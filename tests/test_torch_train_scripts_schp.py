"""The port's SCHP trainer (`ipercore_tpu_torch/scripts/train_schp.py`)
against `scripts/train_schp.py` itself, run in-process up to its first update
(`tests/torch_script_harness.py`) at its smoke size (batch 1, 64², the
synthetic body, a pool of 48 part maps), resumed from the port's seeded
weights.

Tolerances, stated where they are used:
  * the part-map pool (K1, here its plain version) on JAX's recorded draws:
    equal to the JAX driver's pool;
  * the batch on the driver's recorded draws: labels and the skirt flags
    equal, the image within 1e-6 of its largest magnitude;
  * the driver's own loss (in its jitted step) and the port's `loss_fn` on
    the driver's batch with the same parameters: the cross-entropy and the
    pixel accuracy within 1e-4 relative; gradients as `grads_against_jax`
    states (1e-4 relative, or as close to float64 as JAX's where f32 itself
    is further than that);
  * one clipped Adam step on the driver's batch: every parameter within
    2 * lr of JAX's and 99 % within 1e-6.
"""
import numpy as np
import pytest
import torch

import jax

from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.scripts import train_schp
from ipercore_tpu_torch.utils.checkpoint import flax_params_to_torch, load_flat_npz

from tests.test_torch_common import flatten_flax, n, t
from tests.torch_script_harness import (NU, NV, Replay, closure_of, draws_between, draws_of_calls,
                                        grads_against_jax, run_jax_script, within_of_largest)

B, S, LR, POOL = 1, 64, 3e-4, 48


@pytest.fixture(scope="module")
def body():
    tm = tsmpl.synthetic_model(nu=NU, nv=NV, device="cpu")
    return tm, tload_assets(tm, device="cpu", synthetic=True)


@pytest.fixture(scope="module")
def schp_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("schp") / "schp.npz")
    train_schp.save(path, train_schp.build("cpu"))
    return path, run_jax_script("train_schp", ["--smoke", "--resume", "--out", path], until="train_step")


def _torch_tree(tree, module):
    return flax_params_to_torch(flatten_flax(tree), like=module.state_dict())


def _jax_pool(run):
    make_batch = closure_of(run["until"][1], "make_batch")
    return np.asarray(closure_of(make_batch, "pmap_pool"))


def test_schp_pool_and_batch_match_jax(schp_run, body):
    _, run = schp_run
    replay = Replay(draws_of_calls(run["log"], "render_pmap_chunk", "init"))
    pool = train_schp.render_pool(replay, *body, POOL, B, S)
    assert replay.used_up()
    jpool = _jax_pool(run)
    np.testing.assert_array_equal(n(pool), jpool)
    assert (jpool < train_schp.BACKGROUND_PART).mean() > 0.01

    replay = Replay(draws_between(run["log"], "train_step"))
    img, label, skirted = train_schp.make_batch(replay, torch.as_tensor(jpool).long(), B, S)
    assert replay.used_up()
    args, _ = run["vg"]
    np.testing.assert_array_equal(n(label), np.asarray(args[2]))
    within_of_largest(img, args[1], 1e-6)
    # the skirt flag of the driver's batch: its `skirted` draw
    jskirt = [d for d in draws_between(run["log"], "train_step") if d[0] == "bernoulli"][3][2]
    np.testing.assert_array_equal(n(skirted), np.asarray(jskirt)[:, 0, 0])


def test_schp_loss_and_step_match_jax(schp_run):
    path, run = schp_run
    args, ((jl, jacc), jgrads) = run["vg"]
    net = train_schp.build("cpu", path)
    want = _torch_tree(args[0], net)
    net.load_state_dict(want, strict=True)
    batch = (t(args[1]), torch.as_tensor(np.asarray(args[2])).long())
    loss, aux = train_schp.loss_fn(net, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(aux["pix_acc"]), float(jacc), rtol=1e-4)
    grads_against_jax(net, lambda m, dt: train_schp.loss_fn(m, (t(args[1], dt), batch[1]))[0],
                      _torch_tree(jgrads, net))

    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    tx = cm.adam(LR, clip=1.0)
    _, tloss, _ = train_schp.train_step(net, tx, cm.init_state(tx, net), batch)
    np.testing.assert_allclose(float(tloss), float(jl), rtol=1e-4)
    jparams, jupdates = run["updates"]
    new = _torch_tree(jax.tree_util.tree_map(lambda p, u: p + u, jparams, jupdates), net)
    got = dict(net.named_parameters())
    assert max(float((got[k] - before[k]).abs().max()) for k in before) > 0
    d = np.concatenate([np.abs(n(got[k]) - n(new[k])).ravel() for k in got])
    assert d.max() <= 2 * LR * 1.001, d.max()
    assert (d <= 1e-6).mean() >= 0.99, (d <= 1e-6).mean()


def test_schp_save_loads_in_both_packages(schp_run):
    """JAX resumed from the port's file (its strict `load_params`); the
    port's parser loads it as trained weights."""
    path, run = schp_run
    flat = load_flat_npz(path)
    args, _ = run["vg"]
    for k, v in flatten_flax(args[0]).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k].astype(np.float32))
    parser = train_schp.consumer(path, "cpu")
    for k, v in parser.net.state_dict().items():
        assert v.dtype == torch.float32, k
