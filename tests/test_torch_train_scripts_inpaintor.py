"""The port's inpaintor trainer (`ipercore_tpu_torch/scripts/
train_inpaintor.py`, both stages) against `scripts/train_inpaintor.py`
itself, run in-process up to its first update (`tests/torch_script_harness.
py`) at its smoke size (batch 2, control 64², the synthetic body, a pool of
64 silhouettes), resumed from the port's seeded weights. Stage 2 runs a copy
of the JAX driver whose repository root is a temporary directory, so that its
fixed stage-1 path (`assets/inpaintor.npz`) holds the port's stage-1 file and
nothing is written under the repository's `assets/`.

Tolerances, stated where they are used:
  * the silhouette pool (K1, here its plain version, then `dilate(15)`) on
    JAX's recorded draws: equal to the JAX driver's pool;
  * the batch on the driver's recorded draws: the holes equal, the plates
    within 1e-6 of their largest magnitude;
  * the driver's own loss and the port's `loss_fn` on the driver's batch with
    the same parameters: the loss and its terms within 1e-4 relative;
    gradients as `grads_against_jax` states. Stage 2's contextual attention
    takes the plain two-product route on the CPU;
  * one clipped Adam step: every parameter within 2 * lr of JAX's and 99 %
    within 1e-6;
  * `contextual_attention_fused` (PyTorch's own choice of SDPA backend on the
    CPU) against the plain route: output within 1e-5 and gradients of the
    features within 1e-4 relative (L2).
"""
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.ops import attention as tatt
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.scripts import train_inpaintor as T
from ipercore_tpu_torch.utils.checkpoint import flax_params_to_torch, load_flat_npz

from tests.test_torch_common import ROOT, flatten_flax, n, t
from tests.torch_script_harness import (NU, NV, Replay, closure_of, draws_between, draws_of_calls,
                                        grads_against_jax, rel_l2, run_jax_script, within_of_largest)

B, S, LR, POOL = 2, 64, 2e-4, 64


@pytest.fixture(scope="module")
def body():
    tm = tsmpl.synthetic_model(nu=NU, nv=NV, device="cpu")
    return tm, tload_assets(tm, device="cpu", synthetic=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{stage: (the port's start file, the JAX run)}; stage 2 on the port's
    stage-1 file as the frozen coarse net."""
    root = tmp_path_factory.mktemp("inpaint_repo")
    (root / "scripts").mkdir()
    (root / "assets").mkdir()
    script = str(root / "scripts" / "train_inpaintor.py")
    shutil.copy(os.path.join(ROOT, "scripts", "train_inpaintor.py"), script)
    # the start file lies outside `assets/`: a smoke run redirects an output there
    stage1 = str(root / "inpaintor.npz")
    T.save(stage1, T.build("cpu", 1))
    shutil.copy(stage1, root / "assets" / "inpaintor.npz")
    out = {1: (stage1, run_jax_script("train_inpaintor", ["--smoke", "--resume", "--out", stage1],
                                      until="train_step", path=script))}
    refine = str(root / "refine.npz")
    T.save(refine, T.build("cpu", 2, stage1))
    out[2] = (refine, run_jax_script("train_inpaintor", ["--smoke", "--stage", "2", "--resume", "--out", refine],
                                     until="train_step", path=script))
    return stage1, out


def _torch_tree(tree, module):
    return flax_params_to_torch(flatten_flax(tree), like=module.state_dict())


def test_inpaintor_pool_and_batch_match_jax(runs, body):
    _, by_stage = runs
    run = by_stage[1][1]
    replay = Replay(draws_of_calls(run["log"], "render_sil_chunk", "init"))
    pool = T.render_pool(replay, *body, POOL, B, S)
    assert replay.used_up()
    jpool = np.asarray(closure_of(closure_of(run["until"][1], "make_batch"), "sil_pool"))
    np.testing.assert_array_equal(n(pool), jpool)
    assert 0.01 < jpool.mean() < 0.9

    replay = Replay(draws_between(run["log"], "train_step"))
    bg, hole = T.make_batch(replay, torch.as_tensor(jpool), B, S)
    assert replay.used_up()
    args, _ = run["vg"]
    np.testing.assert_array_equal(n(hole), np.asarray(args[2]))
    within_of_largest(bg, args[1], 1e-6)


@pytest.mark.parametrize("stage", [1, 2])
def test_inpaintor_loss_and_step_match_jax(runs, stage):
    stage1, by_stage = runs
    path, run = by_stage[stage]
    args, ((jl, jaux), jgrads) = run["vg"]
    nets = T.build("cpu", stage, stage1, path)
    nets.net.load_state_dict(_torch_tree(args[0], nets.net), strict=True)
    batch = (t(args[1]), t(args[2]))
    loss, aux = T.loss_fn(nets, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4, err_msg=k)

    class Trained(torch.nn.Module):  # the trained net as the module whose gradients are held
        def __init__(self, nets):
            super().__init__()
            self.net, self.frozen = nets.net, [nets]

    def loss_of(m, dt):
        frozen = nets if dt == torch.float32 else _double(nets, m.net)
        return T.loss_fn(frozen, (t(args[1], dt), t(args[2], dt)))[0]

    def _double(nets, net64):
        import copy

        d = copy.deepcopy(nets).double()
        d.net = net64
        return d

    grads_against_jax(Trained(nets), loss_of,
                      {f"net.{k}": v for k, v in _torch_tree(jgrads, nets.net).items()})

    net = nets.net
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    tx = cm.adam(LR, clip=1.0)
    _, tloss, _ = T.train_step(nets, tx, cm.init_state(tx, net), batch)
    np.testing.assert_allclose(float(tloss), float(jl), rtol=1e-4)
    jparams, jupdates = run["updates"]
    new = _torch_tree(jax.tree_util.tree_map(lambda p, u: p + u, jparams, jupdates), net)
    got = dict(net.named_parameters())
    assert max(float((got[k] - before[k]).abs().max()) for k in before) > 0
    d = np.concatenate([np.abs(n(got[k]) - n(new[k])).ravel() for k in got])
    assert d.max() <= 2 * LR * 1.001, d.max()
    assert (d <= 1e-6).mean() >= 0.99, (d <= 1e-6).mean()


@pytest.mark.parametrize("stage", [1, 2])
def test_inpaintor_save_loads_in_both_packages(runs, stage):
    """JAX resumed from the port's file (its strict `load_params`; stage 2
    also loaded the port's stage-1 file as its frozen net); the port's
    `SuperResolutionInpaintor` loads it as trained weights."""
    stage1, by_stage = runs
    path, run = by_stage[stage]
    flat = load_flat_npz(path)
    args, _ = run["vg"]
    for k, v in flatten_flax(args[0]).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k].astype(np.float32))
    inp = T.consumer(path, "cpu", stage, stage1)
    assert inp.trained and inp.refine_trained == (stage == 2)


def test_fused_attention_gradient_matches_the_plain_route():
    """Stage 2's backward through `contextual_attention_fused`: on the CPU
    PyTorch picks the SDPA backend; its output and its gradient with respect
    to the features meet the plain two-product route's, on a hole mask with
    known and masked keys and an all-masked frame."""
    rng = np.random.RandomState(0)
    f = torch.tensor(rng.normal(size=(3, 16, 16, 24)).astype(np.float32))
    mask = np.zeros((3, 16, 16, 1), np.float32)
    mask[0, 4:10, 3:12] = 1
    mask[1, :8] = 1
    mask[2] = 1  # every key masked: a uniform softmax
    hole = torch.tensor(mask)
    w = torch.tensor(rng.normal(size=(3, 16, 16, 24)).astype(np.float32))
    outs, grads = [], []
    for fn in (tatt.contextual_attention_fused, tatt.contextual_attention_plain):
        x = f.clone().requires_grad_(True)
        out = fn(x, hole)
        (g,) = torch.autograd.grad((out * w).sum(), x)
        outs.append(out.detach())
        grads.append(g)
    within_of_largest(outs[0], n(outs[1]), 1e-5)
    assert float(grads[1].abs().max()) > 0
    assert rel_l2(n(grads[0]).astype(np.float64), n(grads[1]).astype(np.float64)) <= 1e-4
