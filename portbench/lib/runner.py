"""What every run shares: the device check, the cache directories, the
statistics of a window, the check for JAX, and the result line."""
from __future__ import annotations

import contextlib
import json
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ipercore_tpu")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda_cache"}


def use_cache_dirs(root: str) -> None:
    """Keep every build and kernel cache of the run at fixed paths inside the
    checkout (`<root>/.portbench_cache/`), so that only a checkout's first
    run builds. The port's own kernels build into `ipercore_tpu_torch/_build/`."""
    for var, sub in CACHE_DIRS.items():
        path = os.path.join(root, ".portbench_cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def loaded_forbidden() -> list:
    """JAX, Flax or the JAX package in `sys.modules`, by whole top-level name."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for cuDNN convolutions and CUDA matrix products inside the block."""
    import torch

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def as_devices(devices) -> list:
    """A device or a list of devices as a list of distinct devices."""
    return list(dict.fromkeys(devices if isinstance(devices, (list, tuple)) else [devices]))


def peak_bytes(devices) -> int:
    """Peak bytes allocated since the process began on the fullest of the
    devices (a device or a list of them)."""
    import torch

    return max((int(torch.cuda.max_memory_allocated(d)) for d in as_devices(devices) if d.type == "cuda"),
               default=0)


def device_info(devices, peak: int) -> dict:
    """The result's `device`: the kind of the first device and how many
    distinct devices the run used (a device or a list of them)."""
    import torch

    devices = as_devices(devices)
    if devices[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": len(devices), "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]), "count": len(devices),
            "memory_peak_bytes": peak}


def quantile(values, q: float) -> float:
    """The q-quantile of all values, linear between order statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no samples")
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def emit(result: dict, checks: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, and the result as the last line on standard output with the checks
    under their own key, last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
