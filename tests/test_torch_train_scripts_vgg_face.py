"""The port's VGG and face-loss trainers (`ipercore_tpu_torch/scripts/
train_vgg.py`, `train_faceloss.py`) against the JAX drivers themselves, run
in-process up to their first update (`tests/torch_script_harness.py`), at
the drivers' smoke sizes on the synthetic body (VGG at 64²).

Tolerances, stated where they are used:
  * the batch maker on JAX's recorded draws: every value within 1e-5 of its
    field's largest magnitude, labels exact;
  * the driver's own loss (its closure, in its jitted step) and the port's
    `loss_fn` on the driver's batch with the same parameters: loss within 1e-4
    relative; gradients as `grads_against_jax` states (1e-4 relative, or as
    close to float64 as JAX's where f32 itself is further than that);
  * one optimizer step on the driver's batch: every updated parameter
    within 2 * lr of JAX's (Adam's first step moves a weight by about
    lr * sign(g), so a weight whose gradient is float noise may move the
    other way) and 99 % of them within 1e-6.
"""
import os

import numpy as np
import pytest
import torch

import jax

from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.models.networks import criterions as TC
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.scripts import train_faceloss, train_vgg
from ipercore_tpu_torch.utils.checkpoint import flax_params_to_torch, load_flat_npz

from tests.test_torch_common import flatten_flax, n, t
from tests.torch_script_harness import (NU, NV, Replay, draws_between, grads_against_jax, run_jax_script,
                                        within_of_largest)

S_VGG = 64


@pytest.fixture(scope="module")
def body():
    tm = tsmpl.synthetic_model(nu=NU, nv=NV, device="cpu")
    return tm, tload_assets(tm, device="cpu", synthetic=True)


def _flat_torch(tree, module):
    """A JAX parameter tree in `module`'s state-dict layout."""
    return flax_params_to_torch(flatten_flax(tree), like=module.state_dict())


def _check_step(net, before, jparams, jupdates, lr):
    """The port's parameters after one step against JAX's params + updates."""
    want = _flat_torch(jax_apply(jparams, jupdates), net)
    got = dict(net.named_parameters())
    d = np.concatenate([np.abs(n(got[k]) - n(want[k])).ravel() for k in want])
    moved = max(float((got[k] - before[k]).abs().max()) for k in before)
    assert moved > 0
    assert d.max() <= 2 * lr * 1.001, d.max()
    assert (d <= 1e-6).mean() >= 0.99, (d <= 1e-6).mean()


def jax_apply(params, updates):
    import jax

    return jax.tree_util.tree_map(lambda p, u: p + u, params, updates)


def _grads_close(net, loss_of, jgrads):
    return grads_against_jax(net, loss_of, _flat_torch(jgrads, net))


# --- VGG ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def vgg_run(tmp_path_factory):
    """The port's seeded pyramid saved, then the JAX driver resumed from it."""
    path = str(tmp_path_factory.mktemp("vgg") / "vgg_perceptual.npz")
    train_vgg.save(path, train_vgg.build(S_VGG, "cpu"))
    run = run_jax_script("train_vgg", ["--smoke", "--size", str(S_VGG), "--resume", "--out", path], until="step")
    return path, run


def test_vgg_make_batch_matches_jax(vgg_run, body):
    _, run = vgg_run
    replay = Replay(draws_between(run["log"], "step"))
    img, labels = train_vgg.make_batch(replay, *body, 2, S_VGG)
    assert replay.used_up()
    args, _ = run["vg"]
    within_of_largest(img, args[1])
    np.testing.assert_array_equal(n(labels), np.asarray(args[2]))
    assert (n(labels) != train_vgg.N_CLASSES - 1).mean() > 0.01


def test_vgg_loss_and_step_match_jax(vgg_run):
    path, run = vgg_run
    args, ((jloss, _), _) = run["vg"]
    net = train_vgg.SegVGG(S_VGG)
    net.load_state_dict(_flat_torch(args[0], net), strict=True)
    # the pyramid JAX resumed from is the port's file
    saved = load_flat_npz(path)
    for k, v in flatten_flax(args[0]["params"]["VGGFeatures_0"], "params/").items():
        np.testing.assert_array_equal(np.asarray(v), saved["params/" + k].astype(np.float32))
    (jl, jaux), jgrads = run["vg"][1]
    img, labels = np.asarray(args[1]), np.asarray(args[2])
    loss, aux = train_vgg.loss_fn(net, (t(img), torch.as_tensor(labels)))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    assert float(aux["pix_acc"]) == pytest.approx(float(jaux), abs=1e-6)
    _grads_close(net, lambda m, dt: train_vgg.loss_fn(m, (t(img, dt), torch.as_tensor(labels)))[0], jgrads)

    # one step of the driver's optimizer on the driver's batch
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    tx = cm.adam(2e-4)
    batch = (t(np.asarray(args[1])), torch.as_tensor(np.asarray(args[2])))
    _, tloss, _ = train_vgg.train_step(net, tx, cm.init_state(tx, net), batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    _check_step(net, before, *run["updates"], lr=2e-4)


def test_vgg_save_loads_in_both_packages(vgg_run):
    from ipercore_tpu.models.networks import criterions as JC

    path, _ = vgg_run
    port = TC.init_vgg_params(TC.build_vgg(device="cpu"), weights_path=path)
    jparams = JC.init_vgg_params(jax.random.PRNGKey(0), S_VGG, weights_path=path)
    flat = load_flat_npz(path)
    assert all(v.dtype == np.float16 for v in flat.values())
    for k, v in _flat_torch(jparams, port).items():
        np.testing.assert_array_equal(n(v), n(port.state_dict()[k]))


def test_vgg_driver_runs_whole(tmp_path):
    """`python -m ipercore_tpu_torch.scripts.train_vgg --smoke`, in-process:
    four steps, the hold-out, the pyramid written where asked."""
    out = str(tmp_path / "vgg.npz")
    result = train_vgg.main(["--smoke", "--size", "64", "--out", out, "--device", "cpu"])
    assert result["out"] == out and os.path.exists(out)
    assert 0.0 <= result["miou"] <= 1.0 and result["steps"] == 4
    TC.init_vgg_params(TC.build_vgg(device="cpu"), weights_path=out)


# --- face loss ----------------------------------------------------------------

@pytest.fixture(scope="module")
def face_run():
    return run_jax_script("train_faceloss", ["--smoke", "--out", "/nonexistent/faceloss.npz"],
                          until="train_step")


def test_faceloss_make_batch_matches_jax(face_run, body):
    draws = draws_between(face_run["log"], "train_step")
    replay = Replay(draws)
    a, b = train_faceloss.make_batch(replay, lambda: replay, *body, 3, 96)
    assert replay.used_up()
    args, _ = face_run["vg"]
    within_of_largest(a, args[1])
    within_of_largest(b, args[2])


def test_faceloss_views_share_the_texture_stream(body):
    """The two views of one identity draw the same texture."""
    view, textures = train_faceloss.batch_draws(3, "cpu")
    a, b = textures(), textures()
    assert torch.equal(a.normal((4, 10)), b.normal((4, 10)))
    crops = train_faceloss.make_batch(view, textures, *body, 3, 96)
    assert crops[0].shape == crops[1].shape == (3, 112, 96, 3)
    assert not torch.equal(crops[0], crops[1])


def test_faceloss_loss_and_step_match_jax(face_run, tmp_path):
    from ipercore_tpu.models.networks import criterions as JC

    args, ((jloss, _), _) = face_run["vg"]
    net = TC.SphereFaceFeatures()
    net.load_state_dict(_flat_torch(args[0], net), strict=True)
    (jl, jacc), jgrads = face_run["vg"][1]
    a, b = np.asarray(args[1]), np.asarray(args[2])
    loss, aux = train_faceloss.loss_fn(net, (t(a), t(b)))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    assert float(aux["retrieval_acc"]) == pytest.approx(float(jacc), abs=1e-6)
    _grads_close(net, lambda m, dt: train_faceloss.loss_fn(m, (t(a, dt), t(b, dt)))[0], jgrads)

    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    tx = cm.adam(1e-4, clip=1.0)
    _, tloss, _ = train_faceloss.train_step(net, tx, cm.init_state(tx, net),
                                            (t(np.asarray(args[1])), t(np.asarray(args[2]))))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    _check_step(net, before, *face_run["updates"], lr=1e-4)

    # the save, in both packages' loaders
    path = train_faceloss.save(str(tmp_path / "faceloss.npz"), net)
    port, hw = TC.init_face_params(path, device="cpu")
    assert hw == (112, 96)
    jnet, jparams, _ = JC.init_face_params(jax.random.PRNGKey(0), path)
    for k, v in _flat_torch(jparams, port).items():
        np.testing.assert_array_equal(n(v), n(port.state_dict()[k]))


# --- the shared helpers -------------------------------------------------------

@pytest.mark.parametrize("name", ["sigmoid_binary_cross_entropy", "softmax_cross_entropy",
                                  "softmax_cross_entropy_with_integer_labels"])
def test_cross_entropies_match_optax(name):
    """Elementwise within 1e-6 of optax's, and their gradients within 1e-6."""
    import optax

    rng = np.random.RandomState(3)
    logits = (rng.normal(0, 4, (5, 7))).astype(np.float32)
    labels = {"sigmoid_binary_cross_entropy": rng.uniform(0, 1, (5, 7)),
              "softmax_cross_entropy": rng.dirichlet(np.ones(7), 5),
              "softmax_cross_entropy_with_integer_labels": rng.randint(0, 7, 5)}[name]
    labels = labels.astype(np.int32 if labels.dtype.kind == "i" else np.float32)
    want, jgrad = jax.value_and_grad(lambda x: getattr(optax, name)(x, labels).sum())(logits)
    x = t(logits).requires_grad_()
    got = getattr(cm, name)(x, torch.as_tensor(labels))
    np.testing.assert_allclose(float(got.sum()), float(want), rtol=1e-6)
    np.testing.assert_allclose(n(torch.autograd.grad(got.sum(), x)[0]), np.asarray(jgrad), atol=1e-6)
