"""What a traced run records, and the reductions that every metric reader shares.

A traced run records, over its traced window:
  * `kernels`: every device kernel from `torch.profiler` (CUDA activity
    only), as (name, start_ns, end_ns, device index); a record without the
    fourth field counts as on device 0;
  * `spans`: the benchmark's own host spans around its calls into the
    program's layers, as (name, start_ns, end_ns) on the profiler's clock
    (`time.time_ns`), innermost last;
  * `counters`: counts the benchmark takes (frames delivered and computed,
    chunks, requests, steps, calls per layer) and the yardstick's numbers
    (nominal operations per frame);
  * `window_s`: the host-clock length of the traced window, synchronised at
    both ends, so that every kernel of the window lies inside it;
  * `devices`: how many devices the cell runs on. Busy time, idle share and
    idle gaps are taken on each device's own timeline and averaged over
    them, so that on several cards one card's kernels never cover another's
    idle time; on one device they are that device's.
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
    devices: int = 1


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


def device_of(kernel) -> int:
    """The device index of a kernel record (0 for a record without one)."""
    return kernel[3] if len(kernel) > 3 else 0


def by_device(kernels) -> dict:
    """The kernel records grouped by device index, in their order."""
    out: dict = {}
    for k in kernels:
        out.setdefault(device_of(k), []).append(k)
    return out


def device_seconds(kernels, pick=lambda name: True) -> float:
    """Summed device seconds of the kernels whose names `pick` accepts, over
    every device."""
    return sum(k[2] - k[1] for k in kernels if pick(k[0])) / 1e9


def union_intervals(kernels) -> list:
    """The union of the kernels' (start, end) intervals, sorted, whatever
    their devices (callers that want one device's timeline pass its kernels)."""
    out = []
    for k in sorted(kernels, key=lambda k: k[1]):
        s, e = k[1], k[2]
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(kernels, devices: int | None = None) -> float:
    """Seconds in which at least one kernel ran on a device, averaged over
    `devices` devices (default: those that ran a kernel); a device without
    kernels counts as never busy."""
    groups = by_device(kernels)
    busy = sum(sum(e - s for s, e in union_intervals(ks)) / 1e9 for ks in groups.values())
    return busy / (devices or max(len(groups), 1))


def idle_share(run: Run) -> float | None:
    """Percent of the traced window in which no kernel ran, the mean over the
    run's devices of each device's own share."""
    if not run.kernels or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(run.kernels, run.devices) / run.window_s)


def top_device_ops(kernels, n: int = 10) -> list:
    """The n kernel names that took most device time, summed over every
    device, [[name, seconds], ...]."""
    by = {}
    for k in kernels:
        by[k[0]] = by.get(k[0], 0.0) + (k[2] - k[1]) / 1e9
    return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(kernels, spans, n: int = 10, devices: int | None = None) -> list:
    """Each device's idle time between its kernels, summed by what the host
    was doing when each gap began (the innermost benchmark span holding that
    moment, `host` outside every span) and averaged over `devices` devices
    (default: those that ran a kernel): [[label, seconds], ...], largest first."""
    by = {}
    groups = by_device(kernels)
    for ks in groups.values():
        merged = union_intervals(ks)
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            label = "host"
            for name, a, b in spans:
                if a <= e0 < b:
                    label = name  # later spans are nested deeper
            by[label] = by.get(label, 0.0) + (s1 - e0) / 1e9
    count = devices or max(len(groups), 1)
    return [[k, v / count] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


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
    (the benchmark's own tests) it records the host's operators instead.
    `devices` is the cell's device or its list of devices: all of them are
    drained before the trace stops."""

    def __init__(self, devices):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from portbench.lib.runner import as_devices

        self.devices = as_devices(devices)
        self.cuda = self.devices[0].type == "cuda"
        self.kind = torch.autograd.DeviceType.CUDA if self.cuda else torch.autograd.DeviceType.CPU
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> tuple[list, float]:
        """Stop; the device kernels as (name, start_ns, end_ns, device index),
        and the host clock (`time.perf_counter`) once every device of the
        cell had drained."""
        import torch

        if self.cuda:
            for d in self.devices:
                torch.cuda.synchronize(d)
        t_stop = time.perf_counter()
        self.prof.stop()
        out = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() == self.kind and ev.duration_ns() > 0:
                out.append((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                            ev.device_index() if self.cuda else 0))
        return out, t_stop
