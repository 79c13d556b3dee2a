"""What a traced run records, and the reductions that every metric reader shares.

A traced run records, over its traced window:
  * `kernels`: every device kernel from `torch.profiler` (CUDA activity
    only), as (name, start_ns, end_ns);
  * `spans`: the benchmark's own host spans around its calls into the
    program's layers, as (name, start_ns, end_ns) on the profiler's clock
    (`time.time_ns`), innermost last;
  * `counters`: counts the benchmark takes (frames delivered and computed,
    chunks, requests, steps, calls per layer) and the yardstick's numbers
    (nominal operations per frame);
  * `window_s`: the host-clock length of the traced window, synchronised at
    both ends, so that every kernel of the window lies inside it.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

# the names of the port's hand-written kernels (`ipercore_tpu_torch/csrc/*.cu`)
HAND_WRITTEN = re.compile(r"(raster|table|grid_sample|repack)_\w+_kernel")
K1_KERNELS = re.compile(r"raster_(count|scan|fill|walk|epilogue)\w*_kernel")
K2_KERNELS = re.compile(r"(grid_sample_\w+|repack_rgb4)_kernel")


@dataclass
class Run:
    """The readings of one run, handed to every metric reader."""

    cell: str
    config: dict
    traffic: dict
    counters: dict = field(default_factory=dict)
    kernels: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    window_s: float = 0.0


def kernel_kind(name: str) -> str:
    """The class of a device operation by its name: `kernels` (the port's
    own), `convolutions` (cuDNN and GEMM engines, their FFT and dgrad
    algorithms and layout transforms), `copies` (memcpy and memset),
    `binning_sort_scan`, or `other`."""
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "copies"
    if HAND_WRITTEN.search(name):
        return "kernels"
    if any(w in low for w in ("conv", "cudnn", "gemm", "xmma", "cutlass", "winograd", "implicit",
                              "nchwtonhwc", "nhwctonchw", "dgrad", "fft", "dse::",
                              "pointwise_mult_and_sum_complex")) \
            or ("gemv" in low and "float2" in low):
        return "convolutions"
    if any(w in low for w in ("sort", "radix", "scan", "searchsorted", "repeat_interleave")):
        return "binning_sort_scan"
    return "other"


def device_seconds(kernels, pick=lambda name: True) -> float:
    """Summed device seconds of the kernels whose names `pick` accepts."""
    return sum(e - s for n, s, e in kernels if pick(n)) / 1e9


def union_intervals(kernels) -> list:
    """The union of the kernels' (start, end) intervals, sorted."""
    out = []
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(kernels) -> float:
    """Seconds in which at least one kernel ran."""
    return sum(e - s for s, e in union_intervals(kernels)) / 1e9


def idle_share(run: Run) -> float | None:
    """Percent of the traced window in which no kernel ran."""
    if not run.kernels or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(run.kernels) / run.window_s)


def top_device_ops(kernels, n: int = 10) -> list:
    """The n kernel names that took most device time, [[name, seconds], ...]."""
    by = {}
    for name, s, e in kernels:
        by[name] = by.get(name, 0.0) + (e - s) / 1e9
    return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(kernels, spans, n: int = 10) -> list:
    """The device's idle time between kernels, summed by what the host was
    doing when each gap began (the innermost benchmark span holding that
    moment, `host` outside every span): [[label, seconds], ...], largest first."""
    by = {}
    merged = union_intervals(kernels)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        label = "host"
        for name, a, b in spans:
            if a <= e0 < b:
                label = name  # later spans are nested deeper
        by[label] = by.get(label, 0.0) + (s1 - e0) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Spans:
    """Host spans on the profiler's clock, kept in memory."""

    def __init__(self):
        self.items: list = []

    def open(self, name: str) -> list:
        item = [name, time.time_ns(), None]
        self.items.append(item)
        return item

    @staticmethod
    def close(item: list) -> None:
        item[2] = time.time_ns()

    def closed(self) -> list:
        return [tuple(i) for i in self.items if i[2] is not None]


class Profiler:
    """`torch.profiler` over CUDA activity alone, started and stopped by hand
    so that a driver can trace whole requests of its window. On a CPU device
    (the benchmark's own tests) it records the host's operators instead."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = device.type == "cuda"
        self.kind = torch.autograd.DeviceType.CUDA if self.cuda else torch.autograd.DeviceType.CPU
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> tuple[list, float]:
        """Stop; the device kernels as (name, start_ns, end_ns), and the host
        clock (`time.perf_counter`) once the device had drained."""
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        t_stop = time.perf_counter()
        self.prof.stop()
        out = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() == self.kind and ev.duration_ns() > 0:
                out.append((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        return out, t_stop
