#!/usr/bin/env python3
"""Run `chip_smoke.py`'s `perception_train` phase alone on one NVIDIA GPU.

    python3 scripts/torch_perception_train_probe.py [--out perception_train.json]

Builds the kernels, then trains each of the port's six perception trainers
(`ipercore_tpu_torch/scripts/train_*.py`) at the JAX drivers' published
defaults for a few steps with every check of the phase (K1 / K3 bit-equal on
the trainers' batches, the card against the CPU, each saved file in its
consumer). Prints the card's name and power limit and one line a trainer
(`step_ms`, `batch_ms`, scenes/s, peak GiB, host syncs, launches a step,
the card-vs-CPU gradient difference); writes the whole phase as JSON to
`--out`. f32 with TF32 off (the generator's step bf16). Needs a GPU; exits
with code 2 when there is none.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="perception_train.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ipercore_tpu_torch.utils import cuda_build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    cuda_build.build_all()
    print("build_s", time.time() - t0, flush=True)
    out = cs.perception_train_phase(torch.device("cuda:0"))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    keys = ("step_ms", "batch_ms", "scenes_per_s", "peak_memory_gib", "host_syncs_per_step", "launches_per_step")
    for name, run in out.items():
        if isinstance(run, dict) and "step_ms" in run:
            print(name, {k: run[k] for k in keys}, "card_vs_cpu", run["card_vs_cpu"].get("grad_l2_rel"), flush=True)
    print("launches", out["launches"], "seconds", out["seconds"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
