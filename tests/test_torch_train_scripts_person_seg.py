"""The port's person-segmenter trainer (`ipercore_tpu_torch/scripts/
train_person_seg.py`) against `scripts/train_person_seg.py` itself, run
in-process up to its first update (`tests/torch_script_harness.py`) at its
smoke size (batch 2, 64², the synthetic body), resumed from the port's
seeded weights.

Tolerances, stated where they are used:
  * `render_alpha` (the driver's direct K1 call, here the plain raster)
    against JAX's raster of the same bodies: the face-index map exact; the
    batch on the driver's recorded draws as stated in its test (JAX's jitted
    and un-jitted runs differ at a silhouette supersample);
  * the driver's own loss (in its jitted step) and the port's `loss_fn` on
    the driver's batch with the same parameters: loss and its terms within 1e-4 relative;
    gradients as `grads_against_jax` states (1e-4 relative, or as close to
    float64 as JAX's where f32 itself is further than that);
  * one Adam step on the driver's batch: every parameter within 2 * lr of
    JAX's and 99 % within 1e-6.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.scripts import train_person_seg
from ipercore_tpu_torch.tools.mattors import HumanMattor
from ipercore_tpu_torch.utils.checkpoint import load_flat_npz

from tests.test_torch_common import flatten_flax, n, t
from tests.torch_script_harness import (NU, NV, Replay, draws_between, grads_against_jax, run_jax_script,
                                        within_of_largest)

B, S, LR = 2, 64, 2e-4


@pytest.fixture(scope="module")
def body():
    tm = tsmpl.synthetic_model(nu=NU, nv=NV, device="cpu")
    return tm, tload_assets(tm, device="cpu", synthetic=True)


@pytest.fixture(scope="module")
def seg_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("person_seg") / "person_seg.npz")
    train_person_seg.save(path, train_person_seg.build("cpu"))
    return path, run_jax_script("train_person_seg", ["--smoke", "--resume", "--out", path], until="train_step")


def _nets_from(tree) -> train_person_seg.Nets:
    nets = train_person_seg.Nets()
    nets.load_state_dict(train_person_seg.state_of(nets, flatten_flax(tree)), strict=True)
    return nets


def test_render_alpha_and_batch_match_jax(seg_run, body):
    from ipercore_tpu.models import smpl as jsmpl
    from ipercore_tpu.ops import rasterizer as jrz

    _, run = seg_run
    draws = draws_between(run["log"], "train_step")
    replay = Replay(draws)
    got = train_person_seg.make_batch(replay, *body, B, S)
    assert replay.used_up()
    args, _ = run["vg"]
    img, alpha, hard = (np.asarray(a) for a in args[1:])
    # JAX's jitted driver and its un-jitted run of this batch maker disagree
    # at a supersample of the silhouette (the fused LBS rounds a vertex by an
    # ulp; ROADMAP Queue 3), and the port's raster follows the un-jitted run
    # bit for bit (`tests/torch_script_harness.eager_with_draws`, checked by
    # hand: every field within 3.6e-7). Against the jitted driver the flipped
    # supersamples are allowed: at most 4 of the soft alpha's pixels differ,
    # by whole supersamples (0.25), and the image, whose blur, resizes and
    # shadow spread such a pixel, has 98 % of its values within 1e-5.
    flips = np.abs(n(got[1]) - alpha)
    assert (flips > 0).sum() <= 4 and np.allclose(flips * 4, np.round(flips * 4), atol=1e-5)
    assert (n(got[2]) != hard).sum() <= 4
    d = np.abs(n(got[0]) - img)
    if (flips > 0).any():
        assert (d <= 1e-5 * np.abs(img).max()).mean() >= 0.98
    else:
        within_of_largest(got[0], img)
    assert 0.0 < float(got[2].mean()) < 0.8

    # the raster alone: the port's K1 call (its plain version here) on the
    # driver's bodies against the JAX driver's CPU raster (`rz.rasterize` per
    # frame) of the same projected faces
    theta = np.concatenate([np.asarray(d[2]).reshape(B, -1) * w for d, w in zip(draws[:4], (1, 1, 0.25, 1.0))], 1)
    jm = jsmpl.synthetic_model(nu=NU, nv=NV)
    det = jsmpl.get_details(jm, jnp.asarray(theta))
    fv = np.asarray(jrz.verts_to_faces(jrz.project_verts(det["verts"], det["cam"]), jm.faces))
    jfim = jax.vmap(lambda f: jrz.rasterize(f, 2 * S).fim)(jnp.asarray(fv))
    fim, _ = train_person_seg.raster_flows(t(fv), body[1].f2uvs[None], 2 * S)
    np.testing.assert_array_equal(n(fim), np.asarray(jfim))
    assert (n(fim) >= 0).mean() > 0.01
    alpha, cond, fim = train_person_seg.render_alpha(Replay(draws[:4]), *body, B, S)
    assert fim.shape == (B, 2 * S, 2 * S) and alpha.shape == (B, S, S, 1) and cond.shape == (B, S, S, 3)


def test_person_seg_loss_and_step_match_jax(seg_run):
    path, run = seg_run
    args, ((jloss, _), _) = run["vg"]
    nets = _nets_from(args[0])
    (jl, ja), jgrads = run["vg"][1]
    img, alpha, hard = (np.asarray(a) for a in args[1:])
    loss, aux = train_person_seg.loss_fn(nets.pair(), (t(img), t(alpha), t(hard)))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(ja[k]), rtol=1e-4, err_msg=k)
    grads_against_jax(nets, lambda m, dt: train_person_seg.loss_fn(
        m.pair(), (t(img, dt), t(alpha, dt), t(hard, dt)))[0],
        train_person_seg.state_of(nets, flatten_flax(jgrads)))

    before = {k: v.detach().clone() for k, v in nets.named_parameters()}
    tx = cm.adam(LR)
    _, tloss, _ = train_person_seg.train_step(nets, tx, cm.init_state(tx, nets),
                                              (t(img), t(alpha), t(hard)))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    jparams, jupdates = run["updates"]
    want = train_person_seg.state_of(nets, flatten_flax(jax.tree_util.tree_map(lambda p, u: p + u,
                                                                                jparams, jupdates)))
    got = dict(nets.named_parameters())
    assert max(float((got[k] - before[k]).abs().max()) for k in before) > 0
    d = np.concatenate([np.abs(n(got[k]) - n(want[k])).ravel() for k in want])
    assert d.max() <= 2 * LR * 1.001, d.max()
    assert (d <= 1e-6).mean() >= 0.99, (d <= 1e-6).mean()


def test_person_seg_save_loads_in_both_packages(seg_run):
    """JAX resumed from the port's file (its strict `load_params`); the
    port's mattor loads both trees of it as trained weights."""
    path, run = seg_run
    flat = load_flat_npz(path)
    assert {k.split("/")[0] for k in flat} == {"seg", "mat"}
    args, _ = run["vg"]
    for k, v in flatten_flax(args[0]).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k].astype(np.float32))
    mattor = HumanMattor(weights_path=path, gca_weights_path="/nonexistent", device="cpu")
    assert mattor.trained
    want = _nets_from(args[0])
    for k, v in want.seg.state_dict().items():
        np.testing.assert_array_equal(n(mattor.seg.state_dict()[k]), n(v))
