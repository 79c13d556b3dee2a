#!/usr/bin/env python3
"""Where one personalization train step of the PyTorch port spends its time
and its host syncs, on one NVIDIA GPU.

    python3 scripts/torch_train_profile.py          # from the repository root

Builds the full-width step of `chip_smoke.py` (AttLWB-SPADE, `patch_global`,
VGG19 + Sphere20a, 512^2, 2 sources, 1 target, f32 with TF32 off, seeded
weights), runs 3 steps as warm-up, then prints one JSON line: the card's name
and power limit, the device milliseconds of one step by operator
(`torch.profiler`, self device time, the 20 largest) and by kernel (the 12
largest), and every host sync of one step by the line of the port that made
it (torch's sync debug mode, the innermost frame inside `ipercore_tpu_torch`).
Needs a GPU; exits with code 2 without one.
"""
import collections
import json
import os
import subprocess
import sys
import traceback
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from ipercore_tpu_torch.models import flow_composition as fc
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets

    device = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    model = smpl_mod.template_model(device=device)
    comp = fc.make_composer(model, load_assets(model, device=device), image_size=cs.SIZE, out_dilate_ks=51)
    batch = cs.train_batch(device)
    state, step, _ = cs.train_rig(comp, batch, device)
    for _ in range(3):
        state, _ = step(state)
    torch.cuda.synchronize()

    # host syncs by the port's line that made them
    sites = collections.Counter()
    root = os.path.join("ipercore_tpu_torch", "")

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message).lower():
            return
        frames = [f for f in traceback.extract_stack() if root in f.filename]
        f = frames[-1] if frames else None
        sites[f"{f.filename.split(root, 1)[1]}:{f.lineno} {f.line}" if f else "outside the port"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = step(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state)
        torch.cuda.synchronize()
    ops, kernels = [], []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us:
            continue
        row = {"ms": us / 1e3, "calls": ev.count, "name": ev.key[:90]}
        (kernels if ev.device_type == torch.autograd.DeviceType.CUDA else ops).append(row)
    ops.sort(key=lambda r: -r["ms"])
    kernels.sort(key=lambda r: -r["ms"])
    print(smi, flush=True)
    print(json.dumps({"device": smi, "ops_by_self_device_ms": ops[:20], "kernels": kernels[:12],
                      "host_syncs": sum(sites.values()), "host_sync_sites": dict(sites.most_common())}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
