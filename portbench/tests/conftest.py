"""Tests of the benchmark itself, on the host at tiny sizes:

    python -m pytest portbench/tests -q

Tests that need an NVIDIA GPU carry the `card` marker and skip without one;
on the card machine the same command runs them."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_GENERATOR = {"BGNet": {"num_filters": [8, 16, 16, 32], "n_res_block": 1},
                  "SIDNet": {"num_filters": [8, 16, 32], "n_res_block": 1},
                  "TSFNet": {"num_filters": [8, 16, 32], "n_res_block": 1}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip when there is none (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny(monkeypatch):
    """A cell of BENCHMARK.json cut to a size the host runs in seconds: a small
    body, 64^2, narrow networks. Returns a function of the cell's name."""
    import torch

    from portbench.lib import manifest
    from portbench.reference import body as body_ref

    full = body_ref.body_arrays
    monkeypatch.setattr(body_ref, "body_arrays", lambda: full(nu=20, nv=18))
    torch.set_num_threads(min(4, torch.get_num_threads()))

    def make(name):
        cell = manifest.load_cell(name)
        cfg = copy.deepcopy(cell.config)
        cfg["image_size"] = 64
        cfg["Generator"] = copy.deepcopy(TINY_GENERATOR)
        if "Discriminator" in cfg:
            cfg["Discriminator"] = dict(cfg["Discriminator"], ndf=8)
        cell.config = cfg
        cell.traffic = dict(cell.traffic, trace_seconds=0.5)
        return cell

    return make
