"""The benchmark's data: `BENCHMARK.json` at the root of the checkout, and the
files it names by name.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by its name:

  * configuration `<name>`: `portbench/configs/<name>.json` (its plain
    reference is `portbench/reference/`, whose generator takes the file's
    `Generator` widths and `fusion`);
  * traffic mix `<name>`: `portbench/traffic/<name>.json`, parameters read by
    the driver that its `"driver"` key names (`portbench/drivers/<driver>.py`);
  * per-layer metric `<name>`: `portbench/metrics/<name>.py`, whose
    `read(run)` returns the value or None when the run has nothing to read.

A later change adds a configuration, a mix or a metric by adding such a file
and an entry in `BENCHMARK.json`, with no edit to a file that exists.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)  # the metric entries it reports
    per_layer: list = field(default_factory=list)


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric entry is reported by the cell: the cells that its
    `workloads` lists, or every cell when it has no such key."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of the manifest (by default `BENCHMARK.json` at the root)."""
    if manifest is None:
        manifest = load_json(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = load_json(os.path.join(os.path.dirname(bench_dir), cfg_entry["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic", _checked(w["traffic"]) + ".json"))
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], traffic_name=w["traffic"],
        config=config, traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"] if reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if reports(m, name)])


def load_driver(traffic: dict):
    """The driver module that a traffic mix names."""
    return importlib.import_module(f"portbench.drivers.{_checked(traffic['driver'])}")


def load_reader(metric_name: str, bench_dir: str = BENCH_DIR):
    """The `read(run)` function of `portbench/metrics/<metric_name>.py`."""
    path = os.path.join(bench_dir, "metrics", _checked(metric_name) + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", metric_name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
