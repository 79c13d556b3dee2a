#!/usr/bin/env python3
"""Run `chip_smoke.py`'s `drivers` phase alone on one NVIDIA GPU.

    python3 scripts/torch_drivers_probe.py [--out drivers.json]

Builds the kernels and draws the preprocessing phase's 1080x1920 clip (with
its calibrated segmenter), then runs the phase: the SCHP, inpaintor (both
stages) and ESRGAN trainers at the JAX drivers' published defaults (pools or
scenes through K1 bit-equal, timed steps, one step against the CPU, stage
2's fused attention against the plain route, each saved file in its
consumer), `accuracy_cost` at 512², `verify_perception`, `fit_gmm_prior`,
the pseudo-labellers, `visual_processed_data` and `self_imitation`. Prints the
card's name and power limit and one line a part; writes the whole phase as
JSON to `--out`. f32 with TF32 off. Needs a GPU; exits with code 2 when there
is none.
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
    ap.add_argument("--out", default="drivers.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ipercore_tpu_torch.tools.mattors import PERSON_SEG_SEED, PersonSegUNet
    from ipercore_tpu_torch.utils import cuda_build
    from ipercore_tpu_torch.utils.checkpoint import seeded_flat_params

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    cuda_build.build_all()
    print("build_s", time.time() - t0, flush=True)
    device = torch.device("cuda:0")
    for name in ("trainers_run", "accuracy_run", "perception_check_run", "gmm_run", "pseudo_labels_run",
                 "visual_run"):  # each part's seconds and result as it ends
        def part(*a, _fn=getattr(cs, name), _name=name, **k):
            t = time.time()
            res = _fn(*a, **k)
            print(_name, f"{time.time() - t:.1f}s", json.dumps(res, default=str), flush=True)
            return res

        setattr(cs, name, part)
    frames = cs.person_clip(device)
    seg_flat, _ = cs.calibrated_seg_params(seeded_flat_params(PersonSegUNet(), PERSON_SEG_SEED), frames, cs.SEG_WORK)
    out = cs.drivers_phase(device, {"frames": frames[:cs.PIPE_SRC + cs.PIPE_REF], "seg_flat": seg_flat})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    keys = ("step_ms", "batch_ms", "scenes_per_s", "peak_memory_gib", "host_syncs_per_step", "device_idle_share")
    for name, run in out["trainers"].items():
        if isinstance(run, dict):
            print(name, {k: run[k] for k in keys}, "pool_s", run.get("pool_s"), "card_vs_cpu",
                  run["card_vs_cpu"]["grad_l2_rel"], flush=True)
    print("attention", out["trainers"]["inpaintor_stage2"]["attention"], flush=True)
    for row in out["accuracy_cost"]["rows"]:
        print("accuracy_cost", row, flush=True)
    print("self_imitation", out["self_imitation"], flush=True)
    print("launches", out["launches"], "seconds", out["seconds"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
