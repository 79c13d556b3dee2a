#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place and computed in the precision below the configuration's
(TF32 for float32 with TF32 off), compared with the float32 reference as a
run compares the program. Its numbers are the upper readings from which the
cell's limits were set; they must fail a limit.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--requests 3]

Prints one JSON line a seed with the numbers and whether they pass the limits.
Needs a CUDA device (TF32 exists only there).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=3,
                    help="requests (imitation) or first steps (training, 0: the cell's own) compared")
    args = ap.parse_args(argv)
    import torch

    from portbench.lib import manifest

    if not torch.cuda.is_available():
        print("the control needs a CUDA device", file=sys.stderr)
        return 3
    cell = manifest.load_cell(args.workload)
    driver = manifest.load_driver(cell.traffic)
    limits = cell.config["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = driver.control(cell, seed, torch.device("cuda", 0), args.requests)
        fails = sorted(k for k, v in numbers.items() if v > limits[k])
        print(json.dumps({"workload": cell.name, "seed": seed, "numbers": numbers,
                          "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
