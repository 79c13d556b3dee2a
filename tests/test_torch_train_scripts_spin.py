"""The port's SPIN trainer (`ipercore_tpu_torch/scripts/train_spin.py`)
against `scripts/train_spin.py` itself, run in-process up to its first update
(`tests/torch_script_harness.py`) at its smoke size (batch 2, 64² scenes
resized to 224, the synthetic body), resumed from the port's seeded weights.

Tolerances, stated where they are used:
  * the batch on JAX's recorded draws: every value within 1e-5 of its
    field's largest magnitude;
  * the driver's own loss (in its jitted step) and the port's `loss_fn` on
    the driver's batch with the same parameters: loss and each term within 1e-4 relative;
    gradients as `grads_against_jax` states (1e-4 relative, or as close to
    float64 as JAX's where f32 itself is further than that);
  * one step of the masked optimizer on the driver's batch: every trained
    parameter within 2 * lr of JAX's (Adam's first step is about lr * sign(g))
    and 99 % within 1e-6; the batch norms' `mean` / `var` bit-unchanged. (JAX's
    optax 0.2 `masked` passes their clipped gradient through as the update;
    the port keeps them, the driver's intent: ROADMAP Queue 3.)
"""
import numpy as np
import pytest
import torch

import jax

from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.scripts import train_spin
from ipercore_tpu_torch.tools.pose3d import SPINNet, SPINRunner
from ipercore_tpu_torch.utils.checkpoint import flax_params_to_torch, load_flat_npz

from tests.test_torch_common import flatten_flax, n, t
from tests.torch_script_harness import (NU, NV, Replay, draws_between, grads_against_jax, run_jax_script,
                                        within_of_largest)

B, S, LR = 2, 64, 3e-4


@pytest.fixture(scope="module")
def body():
    tm = tsmpl.synthetic_model(nu=NU, nv=NV, device="cpu")
    return tm, tload_assets(tm, device="cpu", synthetic=True)


@pytest.fixture(scope="module")
def spin_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spin") / "spin.npz")
    train_spin.save(path, train_spin.build("cpu"))
    return path, run_jax_script("train_spin", ["--smoke", "--resume", "--out", path], until="train_step")


def _torch_tree(tree, module):
    return flax_params_to_torch(flatten_flax(tree), like=module.state_dict())


def test_spin_batch_matches_jax(spin_run, body):
    _, run = spin_run
    replay = Replay(draws_between(run["log"], "train_step"))
    got = train_spin.make_batch(replay, *body, B, S)
    assert replay.used_up()
    args, _ = run["vg"]
    for a, b in zip(got, args[1:]):
        within_of_largest(a, b)
    assert got[0].shape == (B, 224, 224, 3)


def test_spin_loss_and_masked_step_match_jax(spin_run, body):
    path, run = spin_run
    model = body[0]
    args, ((jloss, jaux), _) = run["vg"]
    net = SPINNet()
    net.load_state_dict(_torch_tree(args[0], net), strict=True)
    saved = load_flat_npz(path)  # JAX resumed from the port's file
    for k, v in flatten_flax(args[0]).items():
        np.testing.assert_array_equal(np.asarray(v), saved[k].astype(np.float32))

    (jl, ja), jgrads = run["vg"][1]
    x, theta, j2d = (np.asarray(a) for a in args[1:])
    loss, aux = train_spin.loss_fn(net, (t(x), t(theta), t(j2d)), model)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(ja[k]), rtol=1e-4, err_msg=k)
    models = {torch.float32: model, torch.float64: model._replace(**{
        f: v.double() for f, v in model._asdict().items() if isinstance(v, torch.Tensor) and v.is_floating_point()})}
    grads_against_jax(net, lambda m, dt: train_spin.loss_fn(m, (t(x, dt), t(theta, dt), t(j2d, dt)), models[dt])[0],
                      _torch_tree(jgrads, net))

    # the masked optimizer on the driver's batch
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    tx = train_spin.optimizer(net, LR)
    frozen = train_spin.frozen_stats(net)
    assert len(frozen) == 2 * sum(1 for k in before if k.endswith(".scale")) > 100
    _, tloss, _ = train_spin.train_step(net, tx, cm.init_state(tx, net),
                                        tuple(t(np.asarray(a)) for a in args[1:]), model)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    jparams, jupdates = run["updates"]
    want = _torch_tree(jax.tree_util.tree_map(lambda p, u: p + u, jparams, jupdates), net)
    got = dict(net.named_parameters())
    for k in frozen:
        assert torch.equal(got[k], before[k]), k
    assert max(float(np.abs(v).max()) for k, v in _torch_tree(jupdates, net).items() if k in frozen) > 0
    d = np.concatenate([np.abs(n(got[k]) - n(want[k])).ravel() for k in want if k not in frozen])
    assert d.max() <= 2 * LR * 1.001, d.max()
    assert (d <= 1e-6).mean() >= 0.99, (d <= 1e-6).mean()


def test_spin_save_loads_in_both_packages(spin_run):
    from ipercore_tpu.tools.pose3d import SPINRunner as JSPINRunner

    path, _ = spin_run
    port = SPINRunner(weights_path=path, device="cpu")
    jax_runner = JSPINRunner(weights_path=path)
    assert port.trained and jax_runner.trained
    crops = np.random.RandomState(2).uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)
    np.testing.assert_allclose(port.run(crops, batch_size=2), np.asarray(jax_runner.run(crops)),
                               atol=1e-4, rtol=0)


def test_spin_statistics_stay_frozen_over_steps(body):
    """Three steps on the port's own draws: finite losses, moved weights,
    statistics bit-unchanged."""
    net = train_spin.build("cpu")
    stats = {k: v.detach().clone() for k, v in net.named_parameters() if k in train_spin.frozen_stats(net)}
    tx = train_spin.optimizer(net, LR)
    opt = cm.init_state(tx, net)
    draws = train_spin.sd.Draws(torch.Generator().manual_seed(0), "cpu")
    for _ in range(3):
        opt, loss, _ = train_spin.train_step(net, tx, opt, train_spin.make_batch(draws, *body, B, S), body[0])
        assert np.isfinite(float(loss))
    params = dict(net.named_parameters())
    assert all(torch.equal(params[k], v) for k, v in stats.items())
    assert int(opt.count) == 3
