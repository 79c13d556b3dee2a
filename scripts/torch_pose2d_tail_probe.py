#!/usr/bin/env python3
"""Device time per frame of `OpenPoseRunner.heads` at every batch size a
clip's tail can have, against a full batch, on one NVIDIA GPU.

    python3 scripts/torch_pose2d_tail_probe.py [--size 368x656] [--batch 32] [--out FILE]

For each batch size b from 1 to the full batch, on seeded frames in [-1, 1]
at the network's input size (Body-25 with the runner's seeded weights, the
flip, float32 with TF32 off), b runs as the tail of a clip: one warm-up
call, then CUDA-event time over two calls of `heads` on a full batch and b
frames (`heads` pads a tail to a multiple of `pose2d.CHUNK_MULTIPLE` frames),
less a full batch's time; the milliseconds a frame are over the b real
frames. Prints one JSON line a size (event milliseconds a call and a frame,
and the ratio of ms a frame to the full batch's) and a last line with the
sizes whose ratio passes 1.5, and with `--out` writes the lines to that
file. Needs a GPU; exits with code 2 when there is none.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def time_heads(runner, x, batch: int, calls: int) -> float:
    """Event milliseconds a call of `heads` on x, over `calls` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        runner.heads(x, batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="368x656")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", help="a JSON-lines file for the table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from ipercore_tpu_torch.tools.pose2d import OpenPoseRunner

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    h, w = (int(v) for v in args.size.split("x"))
    runner = OpenPoseRunner(device="cuda")
    g = torch.Generator(device="cuda").manual_seed(21)
    frames = torch.rand((2 * args.batch - 1, h, w, 3), generator=g, device="cuda") * 2 - 1
    lines, full_ms = [], None
    for b in range(args.batch, 0, -1):
        x = frames[:b if full_ms is None else args.batch + b].contiguous()
        runner.heads(x, args.batch)
        torch.cuda.synchronize()
        ms = time_heads(runner, x, args.batch, 2)
        if full_ms is None:
            full_ms = ms
        else:
            ms -= full_ms
        lines.append({"batch": b, "ms_per_call": ms, "ms_per_frame": ms / b})
    full = lines[0]["ms_per_frame"]
    for line in lines:
        line["ratio_to_full"] = line["ms_per_frame"] / full
        print(json.dumps(line), flush=True)
    summary = {"device": torch.cuda.get_device_name(0), "size": [h, w], "batch": args.batch,
               "full_ms_per_frame": full,
               "over_1_5": [l["batch"] for l in lines if l["ratio_to_full"] > 1.5],
               "worst": max(lines, key=lambda l: l["ratio_to_full"])}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
