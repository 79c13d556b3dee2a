#!/usr/bin/env python3
"""Where a traced run's device time and idle time go, by span.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

Runs the cell as `run.py --trace 1` does, with a profiler that also keeps
the CUDA runtime's launch records (kineto's events on the host side that
share a kernel's correlation id: the earliest of them is the launch call),
and prints one JSON line:
  * `device_s_by_launch`: each kernel's device seconds under the innermost
    span (the program's or the benchmark's) open when it was launched, on
    whichever thread; `unattributed` where no launch was recorded;
  * `idle_s_by_span`: the idle seconds between kernels by the innermost span
    open when each gap began;
  * `synth_share_of_device`: the share of the kernels' device seconds
    launched in `synth.geometry` and `synth.generator`, and
    `k1_k2_outside_geometry`: K1 and K2 kernels launched outside
    `synth.geometry` (imitation cells);
  * `metrics`: every per-layer metric of the cell, as `run.py` prints them,
    and `device`, `correct`, `window_s`, `busy_s`.
Needs a CUDA device.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import trace as tr  # noqa: E402

KEPT: dict = {}  # the last stopped profiler's kernels with their keys, and launches


class LaunchProfiler(tr.Profiler):
    """`trace.Profiler` that also keeps, for each device kernel, its
    correlation id, and for each correlation id the host time of its launch."""

    def stop(self):
        kernels, t_stop = super().stop()
        keyed, launches = [], {}
        for ev in self.prof.profiler.kineto_results.events():
            key = ev.correlation_id()
            if ev.device_type() == self.kind:
                if ev.duration_ns() > 0:
                    keyed.append((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(), key))
            elif key > 0:
                launches[key] = min(launches.get(key, ev.start_ns()), ev.start_ns())
        KEPT.update(kernels=keyed, launches=launches)
        return kernels, t_stop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from portbench.lib import manifest, runner
    from portbench.lib import program_spans as ps

    runner.use_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("spans.py needs a CUDA device", file=sys.stderr)
        return 3
    tr.Profiler = LaunchProfiler
    cell = manifest.load_cell(args.workload)
    result, checks = manifest.load_driver(cell.traffic).run(
        cell, args.seed, args.seconds, True, torch.device("cuda", 0), T_START)
    run = result.pop("run")
    program = ps.spans_of(run) or []
    spans = list(program) + list(run.spans)
    kernels, launches = KEPT["kernels"], KEPT["launches"]
    by_launch = ps.device_by_span(kernels, launches, spans)
    k1_k2 = [k for k in kernels if tr.K1_KERNELS.search(k[0]) or tr.K2_KERNELS.search(k[0])]
    k1_k2_under = ps.launched_under(k1_k2, launches, spans)
    metrics = {}
    for m in cell.per_layer:
        v = manifest.load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = v
    busy = tr.busy_seconds(run.kernels)
    line = {
        "workload": cell.name, "seed": args.seed, "correct": result["correct"],
        "device": result["device"], "window_s": run.window_s, "busy_s": busy,
        "program_spans": len(program), "kernels": len(kernels),
        "kernels_with_launch": sum(k[3] in launches for k in kernels),
        "device_s_by_launch": dict(sorted(by_launch.items(), key=lambda kv: -kv[1])),
        "idle_s_by_span": dict(sorted(ps.idle_by_span(run.kernels, spans).items(), key=lambda kv: -kv[1])),
        "synth_share_of_device": sum(by_launch.get(k, 0.0) for k in ("synth.geometry", "synth.generator"))
        / max(sum(by_launch.values()), 1e-12),
        "k1_k2_kernels": len(k1_k2),
        "k1_k2_outside_geometry": sum(label != "synth.geometry" for label in k1_k2_under),
        "metrics": metrics, "breakdown": result.get("breakdown"), "checks": checks,
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
