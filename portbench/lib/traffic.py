"""The one generator of the imitation traffic: requests made from `--seed` and
the parameters of a traffic file.

A request is a reference clip of SMPL parameters (camera 3 | pose 72 |
shape 10) and, where the mix brings a new subject with every request, that
subject's source views: images in [-1, 1] and SMPLs. Clip lengths come in
antithetic pairs (L, lo + hi - L) with L uniform over [lo, hi], so every
seed gives each pair of requests the same number of frames, and the same
padding, in another split: the seed changes the order and the motion, not
the amount of work. A mix that names `pairs` goes further: every seed draws
the same set of that many pairs, spread evenly over [lo, hi], in a seeded
order, cycle after cycle, so that a window of one cycle holds the same sizes
whatever the seed. A clip is
a smooth motion: each joint swings on a sine of its own amplitude, frequency
and phase, and the body turns about its vertical axis.
"""
from __future__ import annotations

import numpy as np
import torch


def rng_of(seed: int, *stream: int) -> np.random.Generator:
    """An independent numpy stream for (seed, stream...)."""
    return np.random.default_rng([int(seed) % 2 ** 63, *stream])


def clip_lengths(params: dict, seed: int, n: int, chunk: int) -> list:
    """The first n clip lengths: antithetic pairs drawn uniformly over the
    lengths in [min, max] that are no multiple of `chunk`, in a seeded order
    within each pair. With min + max a multiple of the chunk, as in every mix
    here, each pair then pads exactly one chunk's worth of frames, whatever
    the seed."""
    lo, hi = int(params["min"]), int(params["max"])
    rng = rng_of(seed, 1)
    out = []
    if "pairs" in params:
        fixed = fixed_pairs(params, chunk)
        while len(out) < n:
            for j in rng.permutation(len(fixed)):
                pair = list(fixed[j])
                if rng.random() < 0.5:
                    pair.reverse()
                out += pair
        return out[:n]
    while len(out) < n:
        a = int(rng.integers(lo, hi + 1))
        if a % chunk == 0:
            continue
        pair = [a, lo + hi - a]
        if rng.random() < 0.5:
            pair.reverse()
        out += pair
    return out[:n]


def fixed_pairs(params: dict, chunk: int) -> list:
    """The `pairs` antithetic pairs (L, lo + hi - L) of a mix that fixes its
    set of sizes: L at the middles of equal steps over [lo, (lo + hi) / 2],
    moved up by one where it is a multiple of `chunk`."""
    lo, hi, k = int(params["min"]), int(params["max"]), int(params["pairs"])
    out = []
    for j in range(k):
        a = lo + int((2 * j + 1) * (hi - lo) / (4 * k))
        a += a % chunk == 0
        out.append((a, lo + hi - a))
    return out


def lengths_drawn(params: dict, chunk: int) -> list:
    """Every clip length the mix can draw, in order."""
    if "pairs" in params:
        return sorted(n for pair in fixed_pairs(params, chunk) for n in pair)
    return [n for n in range(int(params["min"]), int(params["max"]) + 1) if n % chunk]


def motion(rng: np.random.Generator, n: int, params: dict) -> np.ndarray:
    """(n, 85) SMPLs of a smooth seeded motion at `fps` frames a second."""
    t = np.arange(n, dtype=np.float64) / float(params["fps"])
    amp = rng.uniform(*params["joint_amplitude_rad"], size=(23, 3))
    freq = rng.uniform(*params["joint_hz"], size=(23, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(23, 3))
    pose = amp * np.sin(2 * np.pi * freq * t[:, None, None] + phase)  # (n, 23, 3)
    turn = np.deg2rad(params["turn_deg"]) * np.sin(
        2 * np.pi * rng.uniform(*params["turn_hz"]) * t + rng.uniform(0, 2 * np.pi))
    root = np.zeros((n, 3))
    root[:, 1] = turn
    out = np.zeros((n, 85), np.float32)
    out[:, 0] = 1.0
    out[:, 3:6] = root
    out[:, 6:75] = pose.reshape(n, 69)
    out[:, 75:] = rng.normal(0.0, 0.5, size=10)
    return out


def subject(seed: int, index: int, size: int, ns: int, params: dict, device) -> tuple:
    """Source views of subject `index`: images (1, ns, S, S, 3) made on the
    device from the seed, and SMPLs (1, ns, 85): the views turn the body by
    360 / ns degrees each, with a seeded pose, shape and camera."""
    rng = rng_of(seed, 2, index)
    theta = np.zeros((ns, 85), np.float32)
    theta[:, 0] = params["cam_scale"]
    theta[:, 1:3] = rng.uniform(-0.05, 0.05, size=(ns, 2))
    theta[:, 4] = np.arange(ns) * (2 * np.pi / ns)
    theta[:, 3:75] += rng.normal(0.0, params["pose_std_rad"], size=(ns, 72))
    theta[:, 75:] = rng.normal(0.0, 0.5, size=10)
    g = torch.Generator(device=device).manual_seed(int(rng_of(seed, 5, index).integers(0, 2 ** 63)))
    low = torch.randn((ns, 3, 16, 16), generator=g, device=device)
    img = torch.nn.functional.interpolate(low, size=(size, size), mode="bicubic", align_corners=False)
    img = img + 0.1 * torch.randn((ns, 3, size, size), generator=g, device=device)
    img = torch.tanh(img).clamp(-1.0, 1.0).permute(0, 2, 3, 1).contiguous()[None]
    return img, torch.as_tensor(theta, device=device)[None]


class Requests:
    """Request i of a mix: its clip, and its subject index (0 for a mix with
    one subject per run)."""

    def __init__(self, params: dict, seed: int):
        self.params, self.seed = params, int(seed)
        self._lengths: list = []

    def length(self, i: int) -> int:
        if i >= len(self._lengths):
            self._lengths = clip_lengths(self.params["clip_frames"], self.seed, 2 * i + 2,
                                         self.params["chunk"])
        return self._lengths[i]

    def clip(self, i: int) -> np.ndarray:
        return motion(rng_of(self.seed, 3, i), self.length(i), self.params["motion"])

    def subject_index(self, i: int) -> int:
        return i + 1 if self.params["subject"] == "per_request" else 0

    def checked_chunk(self, i: int, chunk: int) -> int:
        """The chunk of request i whose frames the run compares, by the seed."""
        n_chunks = -(-self.length(i) // chunk)
        return int(rng_of(self.seed, 4, i).integers(0, n_chunks))
