"""The port's ESRGAN trainer (`ipercore_tpu_torch/scripts/train_esrgan.py`)
against `scripts/train_esrgan.py` itself, run in-process up to its first
update (`tests/torch_script_harness.py`) at its smoke size (batch 1, HR 64²,
the synthetic body), resumed from the port's seeded weights: once with fresh
scenes (the default) and once with a pool of 3 scenes.

Tolerances, stated where they are used:
  * the batch on the driver's recorded draws (the scene drawing runs K1, here
    its plain version): HR within 1e-5 and LR within 1e-5 of their largest
    magnitude (`compose_scene`'s photo augmentation, as in `tests/
    test_torch_synth_data.py`); the pool on its recorded draws likewise;
  * the driver's own L1 loss and the port's `loss_fn` on the driver's batch
    with the same parameters within 1e-4 relative; gradients as
    `grads_against_jax` states;
  * one clipped Adam step: every parameter within 2 * lr of JAX's and 99 %
    within 1e-6;
  * the hold-out's bilinear upsample (`resize_linear`) against
    `jax.image.resize(..., "bilinear")` within 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.scripts import train_esrgan as E
from ipercore_tpu_torch.utils.checkpoint import flax_params_to_torch, load_flat_npz

from tests.test_torch_common import flatten_flax, n, t
from tests.torch_script_harness import (NU, NV, Replay, closure_of, draws_between, draws_of_calls,
                                        eager_with_draws, grads_against_jax, run_jax_script,
                                        within_of_largest)

B, S, LR, POOL = 1, 64, 2e-4, 3


@pytest.fixture(scope="module")
def body():
    tm = tsmpl.synthetic_model(nu=NU, nv=NV, device="cpu")
    return tm, tload_assets(tm, device="cpu", synthetic=True)


@pytest.fixture(scope="module")
def esr_runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("esrgan") / "esrgan.npz")
    E.save(path, E.build("cpu"))
    # the pooled run stops as its first step is called: its batch maker then
    # runs op by op on that step's key (one jitted step compile, not two)
    return path, {pool: run_jax_script("train_esrgan", ["--smoke", "--resume", "--out", path, "--pool", str(pool)],
                                       until="train_step", before=bool(pool)) for pool in (0, POOL)}


def _torch_tree(tree, module):
    return flax_params_to_torch(flatten_flax(tree), like=module.state_dict())


@pytest.mark.parametrize("pool", [0, POOL])
def test_esrgan_batch_matches_jax(esr_runs, body, pool):
    _, runs = esr_runs
    run = esr_runs[1][pool]
    if pool:
        replay = Replay(draws_of_calls(run["log"], "render_scenes", "init"))
        scenes = cm.pool_chunks(lambda d: E.render_scenes(d, *body, B, S), replay, pool, B)
        assert replay.used_up()
        step_args, step = run["stopped"]
        make_batch = closure_of(step, "make_batch")
        jpool = np.asarray(closure_of(closure_of(make_batch, "get_scenes"), "scene_pool"))
        within_of_largest(scenes, jpool)
        get = lambda d: E.pooled_scenes(d, torch.as_tensor(jpool), B, S)
        (jhr, jlr), draws = eager_with_draws(make_batch, step_args[2])
    else:
        get = lambda d: E.render_scenes(d, *body, B, S)
        (_, jhr, jlr), _ = run["vg"]
        draws = draws_between(run["log"], "train_step")
    replay = Replay(draws)
    hr, lr = E.make_batch(replay, get, B, S)
    assert replay.used_up()
    within_of_largest(hr, np.asarray(jhr))
    within_of_largest(lr, np.asarray(jlr))
    assert lr.shape == (B, S // 4, S // 4, 3)


def test_esrgan_loss_and_step_match_jax(esr_runs):
    path, runs = esr_runs
    run = runs[0]
    args, (jl, jgrads) = run["vg"]
    net = E.build("cpu", path)
    net.load_state_dict(_torch_tree(args[0], net), strict=True)
    batch = (t(args[1]), t(args[2]))
    loss, _ = E.loss_fn(net, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    grads_against_jax(net, lambda m, dt: E.loss_fn(m, (t(args[1], dt), t(args[2], dt)))[0],
                      _torch_tree(jgrads, net))

    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    tx = cm.adam(LR, clip=1.0)
    _, tloss, _ = E.train_step(net, tx, cm.init_state(tx, net), batch)
    np.testing.assert_allclose(float(tloss), float(jl), rtol=1e-4)
    jparams, jupdates = run["updates"]
    new = _torch_tree(jax.tree_util.tree_map(lambda p, u: p + u, jparams, jupdates), net)
    got = dict(net.named_parameters())
    assert max(float((got[k] - before[k]).abs().max()) for k in before) > 0
    d = np.concatenate([np.abs(n(got[k]) - n(new[k])).ravel() for k in got])
    assert d.max() <= 2 * LR * 1.001, d.max()
    assert (d <= 1e-6).mean() >= 0.99, (d <= 1e-6).mean()

    # the hold-out's bilinear baseline: `jax.image.resize`'s upsample
    lr_np = np.asarray(args[2])
    want = jax.image.resize(jnp.asarray(lr_np), np.asarray(args[1]).shape, "bilinear")
    within_of_largest(resize_linear(t(lr_np), tuple(np.asarray(args[1]).shape)), np.asarray(want), 1e-6)
    assert E.psnr(torch.zeros(2), torch.full((2,), 0.1)) == pytest.approx(20.0, abs=1e-4)


def test_esrgan_save_loads_in_both_packages(esr_runs):
    """JAX resumed from the port's file (its strict `load_params`); the
    port's inpaintor loads it as its trained super-resolution stage."""
    path, runs = esr_runs
    flat = load_flat_npz(path)
    args, _ = runs[0]["vg"]
    for k, v in flatten_flax(args[0]).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k].astype(np.float32))
    assert E.consumer(path, "cpu").sr_trained
