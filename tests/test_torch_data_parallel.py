"""The port's data-parallel step and train service in two gloo ranks (one
spawned run, each rank a process, joined through a `file://` store, with a
deadline of 120 s so that a hang fails): each rank's bs 1 against one
process's bs 2 on the same global batch, each sample composed alone in both
(`torch_dp_worker.compose_per_sample`: the LBS rounds differently at another
batch size). Every loss is a mean over the batch and no network holds batch
statistics, so the two agree up to the order of float additions.

Tolerances: the metrics within 1e-6 relative. The Adam moments within 2e-6
(L2, relative) and every element within 1e-5 of the largest: a weight
gradient sums over 2 x 64² pixels in one order in one process and in two
partial sums in the ranks. Parameters: those whose gradient stands above the
float noise (first moment above 1e-5 of the largest) within 2e-6 of the
largest parameter; the rest (convolution biases before an instance norm,
whose true gradient is 0, among them) take Adam's step of +-lr on noise in
either run, so they are held to 2 * lr a step.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ipercore_tpu_torch.parallel import mesh
from ipercore_tpu_torch.services.train import train
from ipercore_tpu_torch.trainers import lwg_trainer as T
from ipercore_tpu_torch.utils import checkpoint as tckpt

from tests import torch_dp_worker as W
from tests.test_torch_common import write_train_video

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEADLINE_S = 120


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp")
    write_train_video(str(work / "data"), "v0", 5, seed=41, mask_size=W.S, background=True)
    write_train_video(str(work / "data"), "v1", 4, seed=42, mask_size=W.S)
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_dp_worker", str(work)], cwd=ROOT,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                                       OMP_NUM_THREADS=str(W.THREADS)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    end = time.monotonic() + DEADLINE_S
    try:
        logs = [p.communicate(timeout=max(1.0, end - time.monotonic()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)

    # one process on the global batch, with the torch threads of a rank (the
    # split of a reduction over threads is part of the order of additions)
    comp, gen, dis, vgg, cfg = W.rig()
    batch = {k: torch.as_tensor(v) for k, v in W.global_batch().items()}
    real = W.compose_per_sample()
    threads = torch.get_num_threads()
    torch.set_num_threads(W.THREADS)
    try:
        state, metrics = T.train_step(T.create_train_state(gen, dis, cfg), batch, comp, gen, dis, vgg, None,
                                      cfg, ns=W.NS)
        train(W.train_opt(str(work / "one"), str(work / "data"), 2), max_iters=2, device="cpu")
    finally:
        T.fc.forward = real
        torch.set_num_threads(threads)
    return work, state, metrics, gen, dis


def _close(a, b, what, rtol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-30), (what, np.abs(a - b).max(), np.abs(b).max())


def _same_checkpoint(dir_a, dir_b, step, lr=1e-4):
    """Bars (module note): the moments within 2e-6 (L2, relative) and every
    element within 1e-5 of the largest; parameters whose first moment is
    above the float noise (1e-5 of the largest) within 2e-6 of the largest
    parameter, the rest within 2 * lr a step."""
    for net in ("G", "D"):
        pa = tckpt.load_flat_npz(os.path.join(dir_a, f"net_iter_{step}_id_{net}.npz"))
        pb = tckpt.load_flat_npz(os.path.join(dir_b, f"net_iter_{step}_id_{net}.npz"))
        assert pa.keys() == pb.keys()
        la = tckpt.load_leaves(os.path.join(dir_a, f"opt_iter_{step}_id_{net}.npz"))
        lb = tckpt.load_leaves(os.path.join(dir_b, f"opt_iter_{step}_id_{net}.npz"))
        assert len(la) == len(lb)
        assert [int(x) for x in la[:4]] == [int(x) for x in lb[:4]]
        n = (len(lb) - 4) // 2
        cat = lambda ls: np.concatenate([np.asarray(x, np.float64).ravel() for x in ls])
        for what, sl in (("mu", slice(4, 4 + n)), ("nu", slice(4 + n, 4 + 2 * n))):
            a, b = cat(la[sl]), cat(lb[sl])
            assert np.linalg.norm(a - b) <= 2e-6 * np.linalg.norm(b), (net, what)
            _close(a, b, f"{net} {what}", rtol=1e-5)
        # the Flax leaf order sorts the parameter paths level by level
        keys = sorted(pb, key=lambda k: k.split("/"))
        a, b = cat([pa[k] for k in keys]), cat([pb[k] for k in keys])
        mu = np.abs(cat(lb[4:4 + n]))
        signal = mu >= 1e-5 * mu.max()
        assert np.abs(a - b)[signal].max() <= 2e-6 * np.abs(b).max(), (net, np.abs(a - b)[signal].max())
        assert np.abs(a - b).max() <= 2 * lr * step * 1.001, (net, np.abs(a - b).max())


def test_two_ranks_step_equals_one_process_on_the_global_batch(runs, tmp_path):
    work, state, metrics, gen, dis = runs
    tckpt.save_train_ckpt(str(tmp_path), 1, state, gen, dis)
    _same_checkpoint(str(work / "step"), str(tmp_path), 1)
    with np.load(work / "step" / "metrics.npz") as z:
        assert int(z["all_reduce_calls"]) == 2  # one for G, one for D
        assert set(z.files) - {"all_reduce_calls"} == set(metrics)
        for k, v in metrics.items():
            _close(z[k], v.numpy(), k)


def test_two_ranks_train_writes_the_one_process_checkpoint(runs):
    work = runs[0]
    ranks, one = work / "train" / "models" / "m", work / "one" / "models" / "m"
    assert sorted(os.listdir(ranks)) == sorted(os.listdir(one))
    _same_checkpoint(str(ranks), str(one), 2)


def test_a_process_without_a_group_runs_the_plain_step(monkeypatch, tmp_path):
    """World size 1 needs no group: the step is `train_step` and reduces
    nothing; a CPU device never asks for NCCL; CUDA without a card raises, in
    `init_data_parallel` and in `train`, whose default device is the GPU."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_data_parallel("cpu") == torch.device("cpu")
    assert mesh.world_size() == 1 and mesh.rank() == 0
    assert not torch.distributed.is_initialized()
    comp, gen, dis, vgg, cfg = W.rig()
    step = T.make_sharded_train_step(comp, gen, dis, vgg, None, cfg, ns=W.NS)
    assert step.__name__ == "<lambda>"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.init_data_parallel("cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            train(W.train_opt(str(tmp_path), str(tmp_path), 1), max_iters=1)
    x, n = mesh.pad_to_multiple(torch.arange(5.0), 4)
    assert n == 5 and x.tolist() == [0, 1, 2, 3, 4, 4, 4, 4]
    assert mesh.pad_to_multiple(torch.ones(2, 4), 2, axis=1)[0].shape == (2, 4)
