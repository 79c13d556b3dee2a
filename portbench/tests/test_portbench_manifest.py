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


def contract_problems(bench: dict, root: str) -> list:
    """What in a manifest breaks the contract that the loaders rely on, as
    messages (none for a sound manifest); configuration files are read under
    `root`."""
    out = []
    cells = [w["name"] for w in bench["workloads"]]
    if set(bench) != {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}:
        out.append("keys")
    if bench["paths"] != ["portbench"] or not 1 <= bench["run_seconds"] <= 51:
        out.append("paths or run_seconds")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    if len(names) != len(set(names)) or len(cells) != len(set(cells)):
        out.append("a name twice")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not (NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")):
            out.append(f"metric {m['name']}: name, unit or better")
        if not set(m.get("workloads", cells)) <= set(cells):
            out.append(f"metric {m['name']}: an unknown cell")
    for m in bench["end_to_end"]:
        if not (0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")):
            out.append(f"metric {m['name']}: bound or source")
    for c in cells:
        e2e = [m["name"] for m in bench["end_to_end"] if c in m.get("workloads", cells)]
        if "setup_s" not in e2e or len(e2e) < 2:
            out.append(f"cell {c}: setup_s and one more end-to-end metric")
    for m in bench["per_layer"]:
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        if not set(m["workloads"]) <= set(moved.get("workloads", cells)):
            out.append(f"metric {m['name']}: a cell that does not report {m['moves']}")
    if any(w["chips"] not in (1, 4) for w in bench["workloads"]):
        out.append("chips other than 1 or 4")
    if sum(w["chips"] == 4 for w in bench["workloads"]) > max(1, len(cells) // 4):
        out.append("too many four-chip cells")
    for entry in bench["configs"]:
        cfg = manifest.load_json(os.path.join(root, entry["file"]))
        if entry["reduced"] != cfg.get("reduced"):
            out.append(f"config {entry['name']}: reduced differs from its file")
        if "dtype" not in cfg.get("precision", {}):
            out.append(f"config {entry['name']}: no precision")
        if "Generator" in cfg and (cfg["Generator"]["TSFNet"]["num_filters"] != [64, 128, 256]
                                   or cfg["precision"] != {"dtype": "float32", "tf32": False}):
            out.append(f"config {entry['name']}: TSFNet widths or float32")
    if len(json.dumps(bench)) >= 64 * 1024:
        out.append("size")
    return out


def test_manifest_keeps_the_contract_shape():
    assert contract_problems(BENCH, ROOT) == []


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
        assert entry["reduced"] == cfg["reduced"]
        assert "dtype" in cfg["precision"]
        if "Generator" in cfg:
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


def test_a_four_chip_cell_and_a_config_that_is_no_generator_are_added_by_files_and_entries_alone(tmp_path):
    """A configuration with no `Generator` key and a reduced key, a mix, a
    metric and a cell on four chips: found by name, and the manifest still
    keeps the contract."""
    bench = tmp_path / "portbench"
    shutil.copytree(manifest.BENCH_DIR, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = {"name": "body25_368", "reduced": ["frames"], "precision": {"dtype": "float32", "tf32": False},
           "net": {"stages": 4, "paf_stages": 3}, "input": [368, 656], "frames": 64}
    (bench / "configs" / "body25_368.json").write_text(json.dumps(cfg))
    mixes = ["driving_video", "short_video", "long_video", "batched_video"]
    for mix in mixes:
        (bench / "traffic" / f"{mix}.json").write_text(json.dumps({"driver": "imitate", "frames": 64}))
    (bench / "metrics" / "frames_seen.pose.py").write_text(
        "def read(run):\n    return run.counters.get('frames')\n")
    new = json.loads(json.dumps(BENCH))
    new["configs"].append({"name": "body25_368", "source": "x", "file": "portbench/configs/body25_368.json",
                           "reduced": ["frames"], "why": "x"})
    # three more cells on one chip make room for a second cell on four
    cells = [f"{mix}.body25_368" for mix in mixes]
    for c, mix in zip(cells, mixes):
        new["workloads"].append({"name": c, "config": "body25_368", "traffic": mix,
                                 "chips": 4 if mix == "batched_video" else 1, "why": "x"})
    for m in new["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"] += cells
    new["per_layer"].append({"name": "frames_seen.pose", "unit": "frames", "better": "higher",
                             "source": "program_counter", "layer": "pose", "moves": "frames_per_s",
                             "workloads": cells})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    assert contract_problems(new, str(tmp_path)) == []
    assert sum(w["chips"] == 4 for w in new["workloads"]) == 2
    assert manifest.load_cell("batched_video.body25_368", bench_dir=str(bench)).chips == 4
    cell = manifest.load_cell("driving_video.body25_368", bench_dir=str(bench))
    assert "Generator" not in cell.config and cell.config["reduced"] == ["frames"]
    assert [m["name"] for m in cell.per_layer] == ["frames_seen.pose"]
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "setup_s"]


def test_a_second_four_chip_cell_among_five_is_refused():
    new = json.loads(json.dumps(BENCH))
    while len(new["workloads"]) < 5:
        new["workloads"].append(dict(new["workloads"][0], name=f"extra{len(new['workloads'])}"))
    del new["workloads"][5:]
    for w in new["workloads"][:2]:
        w["chips"] = 4
    for w in new["workloads"][2:]:
        w["chips"] = 1
    assert "too many four-chip cells" in contract_problems(new, ROOT)
    new["workloads"][1]["chips"] = 1
    assert "too many four-chip cells" not in contract_problems(new, ROOT)
    new["workloads"][1]["chips"] = 2
    assert "chips other than 1 or 4" in contract_problems(new, ROOT)


def test_names_are_checked():
    with pytest.raises(ValueError):
        manifest.load_reader("../run")
    with pytest.raises(KeyError):
        manifest.load_cell("no.such_cell")
