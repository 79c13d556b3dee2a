"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX package's),
and the plain reference loads nothing of the program either."""
import ast
import os
import subprocess
import sys

import pytest

from portbench.lib import manifest
from portbench.lib.runner import FORBIDDEN, loaded_forbidden

BENCH = manifest.BENCH_DIR
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH) for f in fs if f.endswith(".py"))


def imported_tops(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = imported_tops(path)
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)
    if os.sep + "reference" + os.sep in path:
        assert "ipercore_tpu_torch" not in tops
        assert not {t for t in tops if t == "portbench"} or all(
            n.startswith("portbench.reference") for n in _from_modules(path) if n.startswith("portbench"))


def _from_modules(path):
    tree = ast.parse(open(path).read(), path)
    return [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ipercore_tpu_torch_fake", object())
    assert "ipercore_tpu" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "ipercore_tpu.fake", object())
    assert "ipercore_tpu" in loaded_forbidden()


def test_a_run_loads_no_jax(tmp_path):
    """The drivers, the readers and the program they drive, loaded in a fresh
    process: sys.modules holds no forbidden top-level name."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.lib import manifest\n"
        "import portbench.control, portbench.run\n"
        "for c in ('imitate.attlwb_spade_512', 'personalize.attlwb_spade_512'):\n"
        "    cell = manifest.load_cell(c); manifest.load_driver(cell.traffic)\n"
        "    [manifest.load_reader(m['name']) for m in cell.per_layer]\n"
        "import ipercore_tpu_torch.parallel.streaming, ipercore_tpu_torch.trainers.lwg_trainer\n"
        "import ipercore_tpu_torch.models.networks.criterions\n"
        "from portbench.lib.runner import loaded_forbidden; print(loaded_forbidden())\n"
    ) % os.path.dirname(BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "imitate.addlwb_512", "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
