#!/usr/bin/env python3
"""The benchmark of `ipercore_tpu_torch` on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of `BENCHMARK.json` on the machine it is started on: set-up
(the program, seeded weights and inputs on the device, a warm request),
then a window of `--seconds` of the cell's traffic, then the comparison of
what the window produced with the plain reference. The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics),
`device`, with `--trace 1` a `breakdown`, and last `checks`, each compared
number beside its limit (also the last lines of standard error). Exits
non-zero and prints no result without enough CUDA devices, or when JAX or
the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.lib import manifest, runner

    runner.use_cache_dirs(ROOT)
    import torch

    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, checks = manifest.load_driver(cell.traffic).run(
        cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    run = result.pop("run", None)
    if args.trace:
        values = {}
        for m in cell.per_layer:
            v = manifest.load_reader(m["name"])(run)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = values
    found = runner.loaded_forbidden()
    if found:
        print(f"the run loaded {', '.join(found)}; the benchmark may load neither JAX nor "
              "the JAX package", file=sys.stderr)
        return 4
    runner.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
