#!/usr/bin/env python3
"""Time and size the port's fused contextual attention on one NVIDIA GPU.

    python3 scripts/torch_attention_probe.py

For each shape (N frames of H x W features with C channels: the GCA matting
refiner's 128^2 bottleneck at C = 128 on 2 and 16 frames, the inpaintor's
64^2 at C = 192, and 48 frames at 64^2), on seeded features with a hole over
the middle half of each frame, prints one JSON line: the event milliseconds
of `contextual_attention_fused` (one warm-up, three timed calls), the GiB it
allocates at its peak above what was allocated before, its largest
difference from `contextual_attention_plain` (run one frame at a time, so
that the (HW)^2 affinity of one frame is held at once), and, on a frame whose
every pixel is in the hole, its largest difference from the mean of the
features (the uniform softmax the additive -1e9 bias gives). f32, TF32 off.
Needs a GPU; exits with code 2 when there is none.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = ((2, 128, 128), (16, 128, 128), (1, 64, 192), (48, 64, 128))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    from ipercore_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rng = np.random.RandomState(0)
    for n, s, c in CASES:
        f = torch.as_tensor(rng.randn(n, s, s, c).astype(np.float32), device=dev)
        hole = torch.zeros((n, s, s, 1), device=dev)
        hole[:, s // 4:3 * s // 4, s // 4:3 * s // 4] = 1.0
        with torch.inference_mode():
            att.contextual_attention_fused(f, hole)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                fused = att.contextual_attention_fused(f, hole)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 3
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            err = max(float((fused[i:i + 1] - att.contextual_attention_plain(f[i:i + 1], hole[i:i + 1])).abs().max())
                      for i in range(n))
            masked = att.contextual_attention_fused(f[:1], torch.ones_like(hole[:1]))
            masked_err = float((masked - f[:1].mean(dim=(1, 2), keepdim=True)).abs().max())
        print(json.dumps({"frames": n, "hw": s * s, "qk_dim": 9 * c, "v_dim": c, "fused_ms": ms,
                          "fused_peak_gib": peak, "max_abs_err_vs_plain": err, "max_abs": float(fused.abs().max()),
                          "all_masked_err_vs_mean": masked_err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
