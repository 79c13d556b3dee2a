"""Pose estimation of driving clips through the port's Body-25 runner
(`tools/pose2d.OpenPoseRunner`): one client in a closed loop of clips of
1080p uint8 frames, each uploaded to the device, converted to [-1, 1] and
resized to the network's input (`ops/sampling.resize_image`), then
`heads` (the network with the flip, in batches) and `decode_tracked`
(the argmax decode, the heads to the host, NMS, PAF grouping, the largest
person and the 1-euro filter), inside the program's `pose2d.run` span: the
same calls as `run_tracked`. A clip's keypoints, scores and valid flags on
the host are its one delivery, and the window closes at the delivery of the
clip in flight when its seconds are up.

The frames come from a seeded pool of distinct smooth-noise frames in host
memory (pinned where a card reads them); a clip reads the pool cyclically
from a seeded offset. Clip lengths are the mix's fixed set of antithetic
pairs in a seeded order, so that every seed runs the same sizes.

After the window, for a seeded sample of the window's clips, the plain
reference (`portbench/reference/pose2d.py`) works out again from the uint8
frames one seeded batch's merged heads and the keypoints and scores of every
frame up to that batch's end (the filter carries each frame into the next),
in blocks of 8 frames, and they are compared with what the timed calls gave.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from portbench.drivers.imitate import span
from portbench.lib import trace as tr
from portbench.lib import yardstick as ys
from portbench.lib.launches import LaunchProfiler
from portbench.lib.runner import device_info, peak_bytes, sync, tf32
from portbench.lib.traffic import Requests, lengths_drawn, rng_of
from portbench.lib.weights import seeded_state_dict
from portbench.reference import pose2d as ref

LIMIT_KEYS = ("head_max_rel_err", "head_mean_rel_err", "score_max_rel_err", "kp_max_abs_err", "nonfinite")


def weight_seed(seed: int) -> int:
    return int(rng_of(seed, 6).integers(0, 2 ** 63))


def body25_weights(seed: int, device) -> dict:
    """The seeded state dict that both the program and the reference load."""
    with torch.device("meta"):
        shapes = ref.Body25()
    return seeded_state_dict(shapes, weight_seed(seed), device)


def reference_net(seed: int, device) -> ref.Body25:
    net = ref.Body25().to(device).eval()
    net.load_state_dict(body25_weights(seed, device), strict=True)
    return net


def frame_pool(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The pool of uint8 frames (frames, H, W, 3) in host memory, pinned
    where a card reads it: smooth noise, bicubic from a coarse grid, with
    grain, made on the device from the seed, a few frames at a time."""
    p, (H, W) = traffic["pool"], config["frame"]
    g = torch.Generator(device=device).manual_seed(int(rng_of(seed, 10).integers(0, 2 ** 63)))
    out = torch.empty((p["frames"], H, W, 3), dtype=torch.uint8, pin_memory=device.type == "cuda")
    for a in range(0, p["frames"], 8):
        k = min(8, p["frames"] - a)
        low = torch.randn((k, 3, *p["grid"]), generator=g, device=device)
        img = F.interpolate(low, size=(H, W), mode="bicubic", align_corners=False)
        img = img + p["grain"] * torch.randn((k, 3, H, W), generator=g, device=device)
        u8 = ((torch.tanh(img) + 1.0) * 127.5).round().clamp(0, 255).to(torch.uint8)
        out[a:a + k].copy_(u8.permute(0, 2, 3, 1))
    return out


def offset(seed: int, i: int, pool_frames: int) -> int:
    """The pool frame that clip i starts at."""
    return int(rng_of(seed, 9, i).integers(0, pool_frames))


def pool_frames(pool: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Frames start, start + 1, ... of the pool, read cyclically (a copy)."""
    return pool[(start + torch.arange(n)) % len(pool)]


def upload(pool: torch.Tensor, buf: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """The clip's n frames into the device buffer, one copy per contiguous run
    of the pool."""
    k = 0
    while k < n:
        s = (start + k) % len(pool)
        m = min(len(pool) - s, n - k)
        buf[k:k + m].copy_(pool[s:s + m], non_blocking=True)
        k += m
    return buf[:n]


def checked_batch(seed: int, i: int, n: int, batch: int) -> int:
    """The batch of clip i whose heads the run compares."""
    return int(rng_of(seed, 4, i).integers(0, -(-n // batch)))


class Program:
    """The port's runner with the seeded weights, and the device buffer that
    a clip's frames are uploaded into."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from ipercore_tpu_torch.tools.pose2d import OpenPoseRunner

        if not hasattr(OpenPoseRunner, "decode_tracked"):
            raise RuntimeError("this program's OpenPoseRunner has no heads / decode_tracked split")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.batch = config["batch"]
        self.runner = OpenPoseRunner(device=device)
        self.runner.net.load_state_dict(body25_weights(seed, device), strict=True)
        H, W = config["frame"]
        self.buf = torch.empty((traffic["clip_frames"]["max"], H, W, 3), dtype=torch.uint8, device=device)

    def prepare(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 frames on the device -> (n, h, w, 3) in [-1, 1] at the
        network's input, a batch at a time."""
        from ipercore_tpu_torch.ops.sampling import resize_image

        h, w = self.config["input"]
        out = torch.empty((len(frames), h, w, 3), device=self.device)
        for a in range(0, len(frames), self.batch):
            x = frames[a:a + self.batch].to(torch.float32) / 127.5 - 1.0
            out[a:a + self.batch] = resize_image(x, h, w)
        return out

    def request(self, pool: torch.Tensor, start: int, n: int, spans=None) -> tuple:
        """One clip: (keypoints, scores, valid) on the host, and the heads on
        the device."""
        from ipercore_tpu_torch.utils.logging import span as program_span

        with span(spans, "prepare"):
            x = self.prepare(upload(pool, self.buf, start, n))
        with program_span("pose2d.run", frames=n, batches=-(-n // self.batch)):
            paf, hm = self.runner.heads(x, self.batch)
            kps, scores, valid = self.runner.decode_tracked(paf, hm, smooth=True)
        return kps, scores, valid, paf, hm


class Sample:
    """A seeded sample of k of the window's clips, drawn as the clips come:
    clip i gets a seeded key and the k smallest keys are kept, with what the
    check compares of them."""

    def __init__(self, seed: int, k: int):
        self.seed, self.k, self.kept = seed, k, {}

    def offer(self, i: int, make) -> None:
        key = float(rng_of(self.seed, 7, i).random())
        if len(self.kept) < self.k or key < max(v[0] for v in self.kept.values()):
            self.kept[i] = (key, make())
            if len(self.kept) > self.k:
                del self.kept[max(self.kept, key=lambda j: self.kept[j][0])]

    def items(self) -> dict:
        return {i: v for i, (_, v) in self.kept.items()}


def kept_outputs(prog: Program, i: int, n: int, out: tuple) -> dict:
    """What the check compares of clip i: the heads of its checked batch, and
    the keypoints and scores of its frames up to that batch's end."""
    kps, scores, _, paf, hm = out
    b = checked_batch(prog.seed, i, n, prog.batch)
    lo, hi = b * prog.batch, min((b + 1) * prog.batch, n)
    return {"n": n, "from": lo, "to": hi, "paf": paf[lo:hi].cpu().numpy(), "hm": hm[lo:hi].cpu().numpy(),
            "kps": kps[:hi].copy(), "scores": scores[:hi].copy()}


def window(prog: Program, pool: torch.Tensor, reqs: Requests, seconds: float, trace: bool,
           sample: Sample) -> dict:
    """The measured window: clips in a closed loop until `seconds` have
    passed; the window closes when the clip then in flight is delivered."""
    spans = tr.Spans() if trace else None
    prof = LaunchProfiler(prog.device) if trace else None
    out = {"latency_s": [], "frames": 0, "window_s": 0.0, "traced": None}
    traced = {"requests": [], "kernels": [], "launch_ns": [], "spans": [], "window_s": 0.0}
    if prof is not None:  # before the window: the tracer's start-up takes seconds
        prof.start()
    sync(prog.device)
    t0 = time.perf_counter()
    t_end = t0 + seconds
    tracing = prof is not None
    i = 0
    while time.perf_counter() < t_end:
        n = reqs.length(i)
        start = offset(prog.seed, i, len(pool))
        t_req = time.perf_counter()
        with span(spans, "request"):
            res = prog.request(pool, start, n, spans)
        t_done = time.perf_counter()
        out["latency_s"].append(t_done - t_req)
        out["frames"] += n
        out["window_s"] = t_done - t0
        sample.offer(i, lambda: dict(kept_outputs(prog, i, n, res), start=start))
        if tracing:
            traced["requests"].append(n)
            if time.perf_counter() - t0 >= prog.traffic["trace_seconds"] or time.perf_counter() >= t_end:
                traced["kernels"], t_stop = prof.stop()
                traced["launch_ns"] = prof.launch_ns
                traced["window_s"] = t_stop - t0
                traced["spans"] = spans.closed()
                tracing = False
        del res
        i += 1
    out["traced"] = traced if trace else None
    return out


def reference_outputs(config: dict, seed: int, device, pool: torch.Tensor, picks: dict) -> dict:
    """The reference's outputs of the picked clips {clip: (start, from, to)}:
    frames [0, to) of each, the heads of [from, to)."""
    net = reference_net(seed, device)
    return {i: ref.clip_outputs(net, pool_frames(pool, start, hi).to(device), config["input"], lo)
            for i, (start, lo, hi) in sorted(picks.items())}


def compare(got: dict, want: dict, head_limit: float) -> tuple[dict, int]:
    """The numbers compared, and how many (frame, joint) keypoints were left
    out. Heads: the largest and the mean absolute difference over the
    reference heads' largest magnitude in the clip. Scores: the largest
    difference over the same magnitude. Keypoints: the largest absolute
    difference (x, y in [-1, 1] of the map), leaving out the joints that a
    change of heatmap values within the head limit may move by more than
    rounding (`reference.pose2d.unsettled`: near an argmax tie, or a centre of
    mass over a mass near 0). Not finite: the count of values of the
    program's heads, scores and keypoints that are not finite."""
    if not want:
        return {k: float("inf") for k in LIMIT_KEYS}, 0
    head_max = head_sum = score_max = kp_max = 0.0
    head_count = nonfinite = left_out = 0
    for i, w in want.items():
        g, s = got[i], w["scale"]
        for key in ("paf", "hm", "scores", "kps"):
            nonfinite += int((~np.isfinite(g[key])).sum())
        for key in ("paf", "hm"):
            d = np.abs(g[key].astype(np.float64) - w[key])
            d = d[np.isfinite(d)]
            head_max = max(head_max, float(d.max(initial=0.0)) / s)
            head_sum += float(d.sum()) / s
            head_count += d.size
        d = np.abs(g["scores"].astype(np.float64) - w["scores"])
        score_max = max(score_max, float(d[np.isfinite(d)].max(initial=0.0)) / s)
        near = ref.unsettled(w, head_limit * s)
        d = np.abs(g["kps"].astype(np.float64) - w["kps"]).max(axis=-1)[~near]
        kp_max = max(kp_max, float(d[np.isfinite(d)].max(initial=0.0)))
        left_out += int(near.sum())
    return {"head_max_rel_err": head_max, "head_mean_rel_err": head_sum / max(head_count, 1),
            "score_max_rel_err": score_max, "kp_max_abs_err": kp_max, "nonfinite": float(nonfinite)}, left_out


def picks_of(kept: dict) -> dict:
    return {i: (k["start"], k["from"], k["to"]) for i, k in kept.items()}


def control(cell, seed: int, device, n_requests: int) -> dict:
    """The control: the reference in the program's place, computed in TF32
    (the precision below the configuration's float32 with TF32 off), on the
    checked batches of the mix's first `n_requests` clips, compared as a run
    compares the program."""
    config, traffic = cell.config, cell.traffic
    reqs = Requests(traffic, seed)
    pool = frame_pool(config, traffic, seed, device)
    picks = {}
    for i in range(n_requests):
        n = reqs.length(i)
        b = checked_batch(seed, i, n, config["batch"])
        picks[i] = (offset(seed, i, len(pool)), b * config["batch"], min((b + 1) * config["batch"], n))
    with tf32(False):
        want = reference_outputs(config, seed, device, pool, picks)
    with tf32(True):
        got = reference_outputs(config, seed, device, pool, picks)
    numbers, _ = compare(got, want, config["limits"]["head_max_rel_err"])
    return numbers


def flops_per_frame(config: dict) -> float:
    """Nominal operations of one frame with the flip (two passes of the
    network at its input size), counted on the meta device."""
    h, w = config["input"]
    with torch.device("meta"):
        net = ref.Body25()
        x = torch.zeros((2, 3, h, w))
    return ys.count_flops(net, lambda: net(x))


def batch_sizes(traffic: dict, batch: int) -> list:
    """Every chunk size the network runs in this mix (`pose2d.chunk_frames`
    of each clip length: the full batch and each padded tail), largest first."""
    from ipercore_tpu_torch.tools.pose2d import chunk_frames

    lengths = lengths_drawn(traffic["clip_frames"], traffic["chunk"])
    return sorted({k for n in lengths for k in chunk_frames(n, batch)}, reverse=True)


def warm(prog: Program, pool: torch.Tensor, seed: int) -> None:
    """Every chunk size the network runs in this mix, largest first, through
    the preparation and `heads`; then the shortest clip through the whole
    request."""
    for k in batch_sizes(prog.traffic, prog.batch):
        prog.runner.heads(prog.prepare(upload(pool, prog.buf, 0, k)), k)
    prog.request(pool, offset(seed ^ 0x5EED, 0, len(pool)), prog.traffic["clip_frames"]["min"])


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> tuple:
    config, traffic = cell.config, cell.traffic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    marks = [("start", time.perf_counter())]
    reqs = Requests(traffic, seed)

    # set-up: the runner with the seeded weights, the frame pool, and every
    # chunk size the window will run
    prog = Program(config, traffic, seed, device)
    sync(device)
    marks.append(("program", time.perf_counter()))
    pool = frame_pool(config, traffic, seed, device)
    sync(device)
    marks.append(("pool", time.perf_counter()))
    warm(prog, pool, seed)
    sync(device)
    marks.append(("warm", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print("set-up: imports %.2f s; " % (marks[0][1] - t_start) + "; ".join(
        f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:])), file=sys.stderr)

    sample = Sample(seed, traffic["check"]["requests"])
    w = window(prog, pool, reqs, seconds, trace, sample)
    peak = peak_bytes(device)

    # the program's state goes before the reference runs
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    kept = sample.items()
    t_ref = time.perf_counter()
    want = reference_outputs(config, seed, device, pool, picks_of(kept))
    print(f"reference: {len(want)} clips, {sum(k['to'] for k in kept.values())} frames in "
          f"{time.perf_counter() - t_ref:.1f} s; largest heatmap value "
          f"{max(float(v['scores'].max()) for v in want.values())!r} (no limit; NMS keeps peaks over 0.1)",
          file=sys.stderr)
    limits = config["limits"]
    numbers, left_out = compare(kept, want, limits["head_max_rel_err"])
    print(f"keypoints left out near an argmax tie or a mass near 0: {left_out} of "
          f"{sum(k['to'] for k in kept.values()) * ref.N_JOINTS}", file=sys.stderr)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": len(w["latency_s"]), "failed": 0,
              "metrics": {}, "device": device_info(device, peak)}
    if not trace:
        values = {"frames_per_s": w["frames"] / w["window_s"], "setup_s": setup_s}
        print(f"clips in the window: {len(w['latency_s'])}; frames {w['frames']}; "
              f"window {w['window_s']:.3f} s", file=sys.stderr)
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items() if k in units}
        return result, checks

    t = w["traced"]
    counters = {"requests": len(t["requests"]), "frames": sum(t["requests"]),
                "frame_flops": flops_per_frame(config), "launch_ns": t["launch_ns"]}
    run_ = tr.Run(cell=cell.name, config=config, traffic=traffic, counters=counters,
                  kernels=t["kernels"], spans=t["spans"], window_s=t["window_s"])
    result["device"]["busy_s"] = tr.busy_seconds(t["kernels"])
    result["device"]["window_s"] = t["window_s"]
    result["breakdown"] = {"device_ops": tr.top_device_ops(t["kernels"]),
                           "idle_gaps": tr.idle_gaps(t["kernels"], t["spans"])}
    result["run"] = run_
    return result, checks
