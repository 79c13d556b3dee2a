"""The manifest, and the discovery of configurations, mixes and metrics by name."""
import json
import os
import re
import shutil

import pytest

from portbench.lib import manifest

ROOT = os.path.dirname(manifest.BENCH_DIR)
BENCH = manifest.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    per_cell = {c: [m["name"] for m in BENCH["end_to_end"] if c in m.get("workloads", CELLS)] for c in CELLS}
    assert all("setup_s" in v and len(v) >= 2 for v in per_cell.values())
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    c = manifest.load_cell(cell)
    assert c.config["name"] == c.config_name and manifest.load_driver(c.traffic).run
    assert c.per_layer, "a cell reports at least one per-layer metric"
    for m in c.per_layer:
        assert callable(manifest.load_reader(m["name"]))


def test_configs_name_their_reductions_and_widths():
    for entry in BENCH["configs"]:
        cfg = manifest.load_json(os.path.join(ROOT, entry["file"]))
        assert entry["reduced"] == cfg["reduced"] == []
        assert cfg["Generator"]["TSFNet"]["num_filters"] == [64, 128, 256]
        assert cfg["precision"] == {"dtype": "float32", "tf32": False}


def test_a_config_a_mix_and_a_metric_are_added_by_files_and_entries_alone(tmp_path):
    """A copy of the benchmark's folder with new files and manifest entries:
    the loaders find them with no edit to any file that was there."""
    bench = tmp_path / "portbench"
    shutil.copytree(manifest.BENCH_DIR, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.loads((bench / "configs" / "addlwb_512.json").read_text())
    cfg["name"] = "addlwb_384"
    cfg["image_size"] = 384
    (bench / "configs" / "addlwb_384.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "imitate.json").read_text())
    mix["clip_frames"] = {"min": 30, "max": 90}
    (bench / "traffic" / "short_clips.json").write_text(json.dumps(mix))
    (bench / "metrics" / "frames_seen.short.py").write_text(
        "def read(run):\n    return run.counters.get('frames')\n")
    new = json.loads(json.dumps(BENCH))
    new["configs"].append({"name": "addlwb_384", "source": "x", "file": "portbench/configs/addlwb_384.json",
                           "reduced": ["image_size"], "why": "x"})
    new["workloads"].append({"name": "short_clips.addlwb_384", "config": "addlwb_384",
                             "traffic": "short_clips", "chips": 1, "why": "x"})
    for m in new["end_to_end"]:
        if "frames_per_s" == m["name"]:
            m["workloads"].append("short_clips.addlwb_384")
    new["per_layer"].append({"name": "frames_seen.short", "unit": "frames", "better": "higher",
                             "source": "program_counter", "layer": "model step", "moves": "frames_per_s",
                             "workloads": ["short_clips.addlwb_384"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = manifest.load_cell("short_clips.addlwb_384", bench_dir=str(bench))
    assert cell.config["image_size"] == 384 and cell.traffic["clip_frames"]["max"] == 90
    assert [m["name"] for m in cell.per_layer] == ["frames_seen.short"]
    from portbench.lib.trace import Run

    read = manifest.load_reader("frames_seen.short", bench_dir=str(bench))
    assert read(Run(cell="c", config={}, traffic={}, counters={"frames": 12})) == 12
    assert read(Run(cell="c", config={}, traffic={})) is None


def test_names_are_checked():
    with pytest.raises(ValueError):
        manifest.load_reader("../run")
    with pytest.raises(KeyError):
        manifest.load_cell("no.such_cell")
