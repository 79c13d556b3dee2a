"""OpenPose Body-25 on driving frames in plain PyTorch: the resize of the
uint8 frames, the network, the flip merge, the argmax decode and the 1-euro
filter.

Cao et al., "OpenPose: Realtime Multi-Person 2D Pose Estimation using Part
Affinity Fields", TPAMI 2019 (arXiv 1812.08008); the layer list of CMU
OpenPose's `models/pose/body_25/pose_deploy.prototxt`: a VGG-19 stem to
conv4_2 at stride 8 with the CPM convolutions (conv4_2, conv4_3_CPM and
conv4_4_CPM with PReLU), four PAF stages (L2) then two heatmap stages (L1),
each five blocks of three 3x3 convolutions with PReLU whose three outputs are
concatenated, a 1x1 squeeze with PReLU and a 1x1 head; 52 PAF channels (26
limbs, x and y) and 26 heatmap channels (25 joints and the background). The
module and parameter names are those of the program's state dict, so one
state dict loads into both. Float32, with TF32 off for cuDNN and matrix
products as the caller sets it (`portbench/drivers/pose2d.py`; the control
turns it on).

Departures from the CMU description, each as the program's runner does it:
  * input: the frame stretched to 368x656 (-1x368 of 1920x1080, the width
    rounded to a multiple of 16) by an antialiased linear resize with
    half-pixel centres, where CMU keeps the aspect with a cubic resize and
    pads; values x / 127.5 - 1 of the uint8 frame, halved to [-0.5, 0.5],
    channels in the frame's order;
  * the concatenations of the stage inputs in the order of iPERCore's
    `openposenet.py` (features, then PAF, then heatmap), whose checkpoint the
    program loads key for key;
  * the flip: each frame and its mirror image run as one batch, and the
    mirror's heads, flipped back with the left and right joints swapped and
    the mirrored limbs' PAFs read with their x component negated, are
    averaged with the frame's (CMU's default runs one pass);
  * the decode at the network's stride 8, on the 46x82 heads (CMU upsamples
    them to the input): per joint the argmax of its heatmap (the first in
    row-major order on a tie) moved by the centre of mass of the 3x3
    neighbourhood of the zero-padded map, values below 0 taken as 0, the
    offset clamped to one cell, as a single person (CMU groups every person
    by NMS and the PAFs; the program's tracked decode gives the argmax where
    its grouping finds nobody); then the 1-euro filter (Casiez et al., CHI
    2012) over the clip at 15 Hz, min cutoff 1, beta 0.05, derivative cutoff
    1, its derivative taken from the previous raw value;
  * computed in blocks of 8 frames.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

N_JOINTS = 25
N_PAFS = 52
BLOCK = 8

# the left <-> right swap of the 25 joints and the background channel
FLIP_JOINTS = [0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11,
               16, 15, 18, 17, 22, 23, 24, 19, 20, 21, 25]
# the 26 limbs (joint a, joint b) and their (x, y) PAF channels
LIMBS = [(1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9), (9, 10), (10, 11), (8, 12),
         (12, 13), (13, 14), (1, 0), (0, 15), (15, 17), (0, 16), (16, 18), (2, 17), (5, 18), (14, 19),
         (19, 20), (14, 21), (11, 22), (22, 23), (11, 24)]
PAF_CHANNELS = [(0, 1), (14, 15), (22, 23), (16, 17), (18, 19), (24, 25), (26, 27), (6, 7), (2, 3), (4, 5),
                (8, 9), (10, 11), (12, 13), (30, 31), (32, 33), (36, 37), (34, 35), (38, 39), (20, 21),
                (28, 29), (40, 41), (42, 43), (44, 45), (46, 47), (48, 49), (50, 51)]


def paf_flip() -> tuple[list, list]:
    """(source channel, sign) for each PAF channel of the merged heads: the
    channel of the mirrored limb, its x component negated."""
    src, sign = list(range(N_PAFS)), [1.0] * N_PAFS
    for (a, b), (cx, cy) in zip(LIMBS, PAF_CHANNELS):
        m = LIMBS.index((FLIP_JOINTS[a], FLIP_JOINTS[b]))
        src[cx], src[cy] = PAF_CHANNELS[m]
        sign[cx] = -1.0
    return src, sign


class PReLU(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((n,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight[None, :, None, None] * x)


def conv(cin: int, cout: int, k: int = 3) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class Stem(nn.Module):
    """conv1_1 ... conv4_4_CPM (NCHW)."""

    VGG = [("conv1_1", 3, 64), ("conv1_2", 64, 64), None, ("conv2_1", 64, 128), ("conv2_2", 128, 128),
           None, ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
           ("conv3_4", 256, 256), None, ("conv4_1", 256, 512)]
    CPM = [("conv4_2", "prelu4_2", 512, 512), ("conv4_3_CPM", "prelu4_3_CPM", 512, 256),
           ("conv4_4_CPM", "prelu4_4_CPM", 256, 128)]

    def __init__(self):
        super().__init__()
        for layer in self.VGG:
            if layer is not None:
                self.add_module(layer[0], conv(layer[1], layer[2]))
        for c, p, cin, cout in self.CPM:
            self.add_module(c, conv(cin, cout))
            self.add_module(p, PReLU(cout))

    def forward(self, x):
        for layer in self.VGG:
            x = F.max_pool2d(x, 2, 2) if layer is None else torch.relu(getattr(self, layer[0])(x))
        for c, p, _, _ in self.CPM:
            x = getattr(self, p)(getattr(self, c)(x))
        return x


class Stage(nn.Module):
    """One refinement stage (NCHW): five blocks of three 3x3 convolutions with
    PReLU, their outputs concatenated; a 1x1 squeeze with PReLU; a 1x1 head."""

    def __init__(self, stage: int, branch: int, width: int, out: int, cin: int):
        super().__init__()
        self.tag = f"stage{stage}_L{branch}"
        for i in range(1, 6):
            for col in range(3):
                c = (cin if i == 1 else 3 * width) if col == 0 else width
                self.add_module(f"Mconv{i}_{self.tag}_{col}", conv(c, width))
                self.add_module(f"Mprelu{i}_{self.tag}_{col}", PReLU(width))
        squeeze = 256 if width == 96 else 512
        self.add_module(f"Mconv6_{self.tag}", conv(3 * width, squeeze, 1))
        self.add_module(f"Mprelu6_{self.tag}", PReLU(squeeze))
        self.add_module(f"Mconv7_{self.tag}", conv(squeeze, out, 1))

    def forward(self, x):
        t = self.tag
        for i in range(1, 6):
            outs = []
            for col in range(3):
                x = getattr(self, f"Mprelu{i}_{t}_{col}")(getattr(self, f"Mconv{i}_{t}_{col}")(x))
                outs.append(x)
            x = torch.cat(outs, dim=1)
        x = getattr(self, f"Mprelu6_{t}")(getattr(self, f"Mconv6_{t}")(x))
        return getattr(self, f"Mconv7_{t}")(x)


class Body25(nn.Module):
    """(N, 3, H, W) in [-0.5, 0.5] -> (PAFs (N, 52, H/8, W/8), heatmaps (N, 26, H/8, W/8))."""

    def __init__(self):
        super().__init__()
        f, P, J = 128, N_PAFS, N_JOINTS + 1
        self.model0 = Stem()
        self.block02 = Stage(0, 2, 96, P, f)
        self.block12 = Stage(1, 2, 128, P, f + P)
        self.block22 = Stage(2, 2, 128, P, f + P)
        self.block32 = Stage(3, 2, 128, P, f + P)
        self.block01 = Stage(0, 1, 96, J, f + P)
        self.block11 = Stage(1, 1, 128, J, f + P + J)

    def forward(self, x):
        feat = self.model0(x)
        paf = self.block02(feat)
        for stage in (self.block12, self.block22, self.block32):
            paf = stage(torch.cat([feat, paf], dim=1))
        hm = self.block01(torch.cat([feat, paf], dim=1))
        hm = self.block11(torch.cat([feat, paf, hm], dim=1))
        return paf, hm


def resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) weights of a linear resize with half-pixel centres that
    antialiases when it shrinks: output i, centred at input coordinate
    (i + 0.5) * s with s = n_in / n_out, takes input j with the triangle
    weight max(0, 1 - |j + 0.5 - centre| / max(s, 1)), normalised to sum 1."""
    s = n_in / n_out
    support = max(s, 1.0)
    centre = (np.arange(n_out, dtype=np.float64) + 0.5) * s
    j = np.arange(n_in, dtype=np.float64) + 0.5
    w = np.maximum(0.0, 1.0 - np.abs(j[None, :] - centre[:, None]) / support)
    return torch.as_tensor(w / w.sum(axis=1, keepdims=True), dtype=torch.float32)


def resize_frames(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """uint8 frames (N, H, W, 3) -> float32 (N, h, w, 3) in [-1, 1]."""
    n, H, W, C = frames.shape
    x = frames.to(torch.float32) / 127.5 - 1.0
    rows = torch.matmul(resize_matrix(H, h).to(frames.device), x.reshape(n, H, W * C))
    return torch.matmul(resize_matrix(W, w).to(frames.device), rows.reshape(n, h, W, C))


def merged_heads(net: Body25, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Frames (N, h, w, 3) in [-1, 1] -> the flip-merged (PAFs, heatmaps), NHWC."""
    n = x.shape[0]
    inp = torch.cat([x, x.flip(2)]).permute(0, 3, 1, 2) * 0.5
    paf, hm = (t.permute(0, 2, 3, 1) for t in net(inp))
    src, sign = paf_flip()
    paf_m = paf[n:].flip(2)[..., src] * torch.tensor(sign, device=x.device)
    hm_m = hm[n:].flip(2)[..., FLIP_JOINTS]
    return 0.5 * (paf[:n] + paf_m), 0.5 * (hm[:n] + hm_m)


def argmax_decode(hm: np.ndarray) -> tuple:
    """Heatmaps (N, h, w, 26) -> (keypoints (N, 25, 2) x, y in [-1, 1] of the
    map, scores (N, 25), the gap between each joint's largest and second
    largest value (N, 25), the positive mass of the 3x3 neighbourhood that
    the centre of mass divides by (N, 25)), in float64."""
    hm = hm[..., :N_JOINTS].astype(np.float64)
    n, h, w, J = hm.shape
    flat = hm.reshape(n, h * w, J)
    idx = flat.argmax(axis=1)
    scores = np.take_along_axis(flat, idx[:, None, :], axis=1)[:, 0]
    second = np.sort(flat, axis=1)[:, -2]
    ys, xs = idx // w, idx % w
    pad = np.pad(hm, ((0, 0), (1, 1), (1, 1), (0, 0)))
    rows = np.arange(n)[:, None]
    cols = np.arange(J)[None, :]
    num_x = num_y = den = 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            v = np.maximum(pad[rows, ys + 1 + dy, xs + 1 + dx, cols], 0.0)
            num_x, num_y, den = num_x + v * dx, num_y + v * dy, den + v
    off_x = np.clip(num_x / np.maximum(den, 1e-6), -1.0, 1.0)
    off_y = np.clip(num_y / np.maximum(den, 1e-6), -1.0, 1.0)
    kps = np.stack([(2.0 * (xs + off_x) + 1.0 - w) / w, (2.0 * (ys + off_y) + 1.0 - h) / h], axis=-1)
    return kps, scores, scores - second, den


def one_euro(kps: np.ndarray, freq: float = 15.0, mincutoff: float = 1.0, beta: float = 0.05,
             dcutoff: float = 1.0) -> np.ndarray:
    """The 1-euro filter over frames (N, ...), each value on its own."""
    alpha = lambda cutoff: 1.0 / (1.0 + freq / (2.0 * math.pi * cutoff))
    out = np.empty_like(kps, dtype=np.float64)
    out[0] = x_hat = prev = kps[0].astype(np.float64)
    dx_hat = np.zeros_like(x_hat)
    for t in range(1, len(kps)):
        x = kps[t].astype(np.float64)
        dx_hat = alpha(dcutoff) * (x - prev) * freq + (1.0 - alpha(dcutoff)) * dx_hat
        a = alpha(mincutoff + beta * np.abs(dx_hat))
        out[t] = x_hat = a * x + (1.0 - a) * x_hat
        prev = x
    return out


def clip_outputs(net: Body25, frames: torch.Tensor, size: tuple, heads_from: int) -> dict:
    """The reference's outputs for the first len(frames) frames of a clip
    (uint8, (N, H, W, 3) on the device), in blocks of 8: the merged heads of
    frames [heads_from, N) (`paf`, `hm`), and for every frame the filtered
    keypoints (`kps`), the scores, the top-two gaps (`gap`), the masses of
    the centres of mass (`mass`) and the largest magnitude of the heads
    (`scale`)."""
    h, w = size
    pafs, hms, kps, scores, gaps, masses, scale = [], [], [], [], [], [], 0.0
    with torch.no_grad():
        for a in range(0, len(frames), BLOCK):
            paf, hm = merged_heads(net, resize_frames(frames[a:a + BLOCK], h, w))
            scale = max(scale, float(paf.abs().max()), float(hm.abs().max()))
            k, s, g, m = argmax_decode(hm.cpu().numpy())
            kps.append(k)
            scores.append(s)
            gaps.append(g)
            masses.append(m)
            lo = max(heads_from - a, 0)
            if lo < len(paf):
                pafs.append(paf[lo:].cpu().numpy())
                hms.append(hm[lo:].cpu().numpy())
    return {"paf": np.concatenate(pafs), "hm": np.concatenate(hms), "kps": one_euro(np.concatenate(kps)),
            "scores": np.concatenate(scores), "gap": np.concatenate(gaps), "mass": np.concatenate(masses),
            "scale": scale}


def unsettled(out: dict, err: float) -> np.ndarray:
    """(N, 25), from the frame on, the joints of `clip_outputs`' frames whose
    keypoint a change of up to `err` in each heatmap value may move by more
    than rounding does: where the top two values lie within 2 err (the argmax
    may move), or where the peak may be positive while the mass the centre
    of mass divides by is under 5 % of the heads' scale (the division is
    ill-conditioned: near 0 it meets the mass's floor of 1e-6). The 1-euro
    filter carries a keypoint into every later frame."""
    moved = (out["gap"] <= 2.0 * err) | ((out["scores"] > -2.0 * err) & (out["mass"] < 0.05 * out["scale"]))
    return np.logical_or.accumulate(moved, axis=0)
