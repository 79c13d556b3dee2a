"""Structured metrics logging, step timing and profiler traces.

The port's own copy of `ipercore_tpu/utils/logging.py`: the same JSONL file
and the same echoed `[metrics]` line; `profile_trace` records a
`torch.profiler` trace (Chrome trace JSON) where the JAX package records a
`jax.profiler` one.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL metrics log (+ mirrored stdout line)."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, **metrics) -> None:
        rec = {"t": time.time(), **metrics}
        line = json.dumps(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            printable = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items())
            print(f"[metrics] {printable}", flush=True)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Record a torch.profiler trace (host and, where there is one, CUDA
    activity) around a block into `<log_dir>/trace.json` (open it in Perfetto
    or chrome://tracing). Usage: `with profile_trace('/tmp/trace'): run_step()`."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling wall-clock timer for steps/sec reporting."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []

    def tick(self) -> float:
        now = time.perf_counter()
        self.times.append(now)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < 2:
            return 0.0
        return (len(self.times) - 1) / (self.times[-1] - self.times[0])
