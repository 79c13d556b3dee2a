"""Temporal mode: the temporal attention block, `forward_tsf` with temporal
inputs, the fused temporal geometry and `synthesize_frames_temporal` /
`imitate_sequence(temporal=True)`, each against its JAX twin on the same numpy
inputs and weights (CPU; the JAX raster kernel in interpret mode)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipercore_tpu.models import imitator as jimit
from ipercore_tpu.models.networks import blocks as jblocks
from ipercore_tpu.models.networks import build_generator as jbuild
from ipercore_tpu.services import run_imitator as jrun
from ipercore_tpu_torch.models import imitator as timit
from ipercore_tpu_torch.models.networks import blocks as tblocks
from ipercore_tpu_torch.models.networks import build_generator as tbuild
from ipercore_tpu_torch.services.run_imitator import imitate_sequence
from ipercore_tpu_torch.utils import checkpoint as tckpt

from tests.test_torch_common import NARROW_CFG, flatten_flax, n, t, thetas
from tests.test_torch_imitator import S, _close, world  # noqa: F401  (module fixture)


def test_self_attention_lwb_temporal_matches_jax():
    rng = np.random.RandomState(0)
    x = {"tsf": rng.randn(2, 16, 16, 8), "src": rng.randn(2, 2, 16, 16, 6),
         "Tst": rng.uniform(-1.1, 1.1, (2, 2, 32, 32, 2)), "temp": rng.randn(2, 1, 16, 16, 6),
         "Ttt": rng.uniform(-1.1, 1.1, (2, 1, 32, 32, 2))}
    x = {k: v.astype(np.float32) for k, v in x.items()}
    jmod = jblocks.SelfAttentionLWB(channel=8, mode="spade", temporal=True)
    args = [jnp.asarray(x[k]) for k in ("tsf", "src", "Tst", "temp", "Ttt")]
    params = jmod.init(jax.random.PRNGKey(1), *args)
    tmod = tblocks.SelfAttentionLWB(8, 6, 8, temporal=True)
    tmod.load_state_dict(tckpt.flax_params_to_torch(flatten_flax(params), like=tmod.state_dict()))
    ref = np.asarray(jmod.apply(params, *args))
    with torch.no_grad():
        out = tmod(*[t(x[k]) for k in ("tsf", "src", "Tst", "temp", "Ttt")])
        # the pre-warped form gives the same, and without Ttt the temporal
        # features are not used
        warp = lambda f, fl: tblocks.warp(f.reshape((-1,) + f.shape[2:]), fl.reshape(
            (-1,) + fl.shape[2:])).reshape(f.shape[:2] + (16, 16, f.shape[-1]))
        pre = tmod(t(x["tsf"]), warp(t(x["src"]), t(x["Tst"])), temp_x=warp(t(x["temp"]), t(x["Ttt"])),
                   Ttt=t(x["Ttt"]), pre_warped=True)
        no_ttt = tmod(t(x["tsf"]), t(x["src"]), t(x["Tst"]), temp_x=t(x["temp"]))
        plain = tmod(t(x["tsf"]), t(x["src"]), t(x["Tst"]))
    np.testing.assert_allclose(n(out), ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(n(pre), n(out), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(n(no_ttt), n(plain))
    assert np.abs(n(out) - n(plain)).max() > 1e-3


@pytest.fixture(scope="module")
def narrow_temporal():
    jgen = jbuild("AttLWB-SPADE", NARROW_CFG, temporal=True)
    z = jnp.zeros
    params = jax.jit(lambda r: jgen.init(
        r, z((1, 1, 32, 32, 4)), z((1, 2, 32, 32, 6)), z((1, 1, 32, 32, 6)),
        z((1, 1, 2, 32, 32, 2)), None, False))(jax.random.PRNGKey(3))
    flat = flatten_flax(params)
    rng = np.random.RandomState(4)  # non-zero biases
    flat = {k: (v + rng.randn(*v.shape).astype(np.float32) * 0.05 if k.endswith("bias") else v)
            for k, v in flat.items()}
    tgen = tbuild("AttLWB-SPADE", NARROW_CFG, temporal=True, device="cpu")
    tckpt.load_generator_params(tgen, flat)  # strict: no key of its own
    from tests.test_torch_common import unflatten_to_jax

    return jgen, unflatten_to_jax(flat), tgen, flat


def test_temporal_generator_loads_strictly_with_the_plain_keys(narrow_temporal):
    _, _, tgen, flat = narrow_temporal
    plain = tbuild("AttLWB-SPADE", NARROW_CFG, device="cpu")
    assert set(tgen.state_dict()) == set(plain.state_dict())
    assert tgen.temporal and tgen.enc_fusion_0.temporal and not plain.res_fusion_0.temporal
    assert len(flat) == len(tgen.state_dict())


def test_forward_tsf_with_temporal_inputs_matches_jax(narrow_temporal):
    jgen, params, tgen, _ = narrow_temporal
    rng = np.random.RandomState(5)
    S_, ns = 32, 2
    src = rng.uniform(-1, 1, (2, ns, S_, S_, 6)).astype(np.float32)
    temp = rng.uniform(-1, 1, (2, 1, S_, S_, 6)).astype(np.float32)
    tsf = rng.uniform(-1, 1, (2, S_, S_, 6)).astype(np.float32)
    Tst = rng.uniform(-1.1, 1.1, (2, ns, S_, S_, 2)).astype(np.float32)
    Ttt = rng.uniform(-1.1, 1.1, (2, 1, S_, S_, 2)).astype(np.float32)
    enc_r, res_r = jgen.apply(params, jnp.asarray(src), True, method=jgen.forward_src)
    tenc_r, tres_r = jgen.apply(params, jnp.asarray(temp), True, method=jgen.forward_src)
    img_r, mask_r = jgen.apply(params, jnp.asarray(tsf), enc_r, res_r, jnp.asarray(Tst),
                               tenc_r, tres_r, jnp.asarray(Ttt), method=jgen.forward_tsf)
    with torch.no_grad():
        enc, res = tgen.forward_src(t(src))
        tenc, tres = tgen.forward_src(t(temp))
        img, mask = tgen.forward_tsf(t(tsf), enc, res, t(Tst), tenc, tres, t(Ttt))
        img0, _ = tgen.forward_tsf(t(tsf), enc, res, t(Tst))
    np.testing.assert_allclose(n(img), np.asarray(img_r), atol=1e-4, rtol=0)
    np.testing.assert_allclose(n(mask), np.asarray(mask_r), atol=1e-4, rtol=0)
    assert np.abs(n(img) - n(img0)).max() > 1e-3  # the temporal source is used


@pytest.fixture(scope="module")
def temporal_world(world):
    """The imitator test's world with temporal generators on its weights."""
    jtgen = jbuild("AttLWB-SPADE", NARROW_CFG, temporal=True)
    ttgen = tbuild("AttLWB-SPADE", NARROW_CFG, temporal=True, device="cpu")
    ttgen.load_state_dict(world["tgen"].state_dict(), strict=True)
    tgt = timit.prepare_target_smpls(world["tm"], world["tcache"], thetas(3, seed=9))
    return dict(world, jtgen=jtgen, ttgen=ttgen, tgt=tgt)


def test_make_temporal_inputs_fused_matches_interpret_mode(temporal_world):
    w = temporal_world
    j_in, j_tst, j_ttt = jimit.make_temporal_inputs_fused(
        w["jcomp"], w["jcache"], jnp.asarray(w["tgt"]), interpret=True)
    t_in, t_tst, t_ttt = timit.make_temporal_inputs_fused(w["tcomp"], w["tcache"], t(w["tgt"]))
    assert t_in.shape == (3, S, S, 6) and t_tst.shape == (3, 2, S, S, 2) and t_ttt.shape == (3, S, S, 2)
    _close(t_in, j_in)
    _close(t_tst, j_tst)
    _close(t_ttt, j_ttt)
    # frame 0 has itself as its previous frame: Ttt is the identity flow there
    fim = n(timit.make_frame_inputs(w["tcomp"], w["tcache"], t(w["tgt"][:1]))[2]["fim"])[0]
    grid = (2 * np.arange(S) + 1 - S) / S
    ident = np.stack(np.meshgrid(grid, grid), -1)
    assert np.abs(n(t_ttt[0]) - ident)[fim >= 0].max() < 1e-4  # blend of small faces


@pytest.fixture(scope="module")
def temporal_frames(temporal_world):
    w = temporal_world
    jp, jm = jax.jit(lambda p, c, s: jimit.synthesize_frames_temporal(
        w["jcomp"], w["jtgen"], p, c, s))(w["params"], w["jcache"], jnp.asarray(w["tgt"]))
    tp, tm = timit.synthesize_frames_temporal(w["tcomp"], w["ttgen"], w["tcache"], t(w["tgt"]))
    return (jp, jm), (tp, tm)


def test_synthesize_frames_temporal_matches_jax(temporal_frames):
    (jp, jm), (tp, tm) = temporal_frames
    assert tp.shape == (3, S, S, 3) and tm.shape == (3, S, S, 1)
    _close(tp, jp)
    _close(tm, jm)
    assert np.isfinite(n(tp)).all() and np.abs(n(tp[0]) - n(tp[-1])).max() > 1e-3


def test_imitate_sequence_temporal_matches_jax(temporal_world, temporal_frames):
    w = temporal_world
    (jp, _), (tp, _) = temporal_frames
    out = imitate_sequence(w["tcomp"], w["ttgen"], w["tcache"], w["tgt"], chunk=2, temporal=True,
                           device="cpu")
    ref = jrun.imitate_sequence(w["jcomp"], w["jtgen"], w["params"], w["jcache"], w["tgt"],
                                temporal=True)
    assert out.shape == (3, S, S, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, n(tp), atol=1e-6, rtol=0)
    _close(out, ref)
    _close(out, jp)
