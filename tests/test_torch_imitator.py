"""The slice as a whole at a small size: composer build, source setup, target
preparation and frame synthesis through the JAX package and the PyTorch port
with the same weights and the same numpy inputs (CPU, plain versions)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipercore_tpu.models import flow_composition as jfc
from ipercore_tpu.models import imitator as jimit
from ipercore_tpu.models import mesh as jmesh
from ipercore_tpu.models.networks import build_generator as jbuild
from ipercore_tpu_torch.models import flow_composition as tfc
from ipercore_tpu_torch.models import imitator as timit
from ipercore_tpu_torch.models import mesh as tmesh
from ipercore_tpu_torch.models.networks import build_generator as tbuild
from ipercore_tpu_torch.services.run_imitator import imitate_sequence
from ipercore_tpu_torch.utils import checkpoint as tckpt

from tests.test_torch_common import NARROW_CFG, flatten_flax, n, small_models, t, thetas

S, NS = 128, 2


def _close(a, b, frac=0.995, tol=1e-3, mean_tol=1e-4):
    """>= 99.5 % of values within 1e-3 and mean abs diff < 1e-4: a pixel on a
    silhouette edge may take another face in the two packages, the rest must
    agree."""
    a, b = n(a), np.asarray(b)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert (d <= tol).mean() >= frac, f"only {(d <= tol).mean()} within {tol}"
    assert d.mean() < mean_tol, f"mean abs diff {d.mean()}"


def _world(size):
    """Composer, generator and source cache at `size` in both packages."""
    jm, tm = small_models()
    ja, ta = jmesh.load_assets(jm), tmesh.load_assets(tm, device="cpu")
    jcomp = jfc.make_composer(jm, ja, image_size=size, out_dilate_ks=9)
    tcomp = tfc.make_composer(tm, ta, image_size=size, out_dilate_ks=9)

    jgen = jbuild("AttLWB-SPADE", NARROW_CFG)
    z = jnp.zeros
    params = jax.jit(lambda r: jgen.init(
        r, z((1, 1, 32, 32, 4)), z((1, NS, 32, 32, 6)), z((1, 1, 32, 32, 6)),
        z((1, 1, NS, 32, 32, 2)), None, False))(jax.random.PRNGKey(0))
    tgen = tbuild("AttLWB-SPADE", NARROW_CFG, device="cpu")
    tckpt.load_generator_params(tgen, flatten_flax(params))

    rng = np.random.RandomState(0)
    src_img = rng.uniform(-1, 1, (1, NS, size, size, 3)).astype(np.float32)
    src_smpl = thetas(NS, seed=1, pose_scale=0.05).reshape(1, NS, 85)
    jcache = jax.jit(lambda p, si, ss: jimit.setup_source(jcomp, jgen, p, si, ss))(
        params, jnp.asarray(src_img), jnp.asarray(src_smpl))
    tcache = timit.setup_source(tcomp, tgen, t(src_img), t(src_smpl))
    return dict(jm=jm, tm=tm, jcomp=jcomp, tcomp=tcomp, jgen=jgen, tgen=tgen, params=params,
                jcache=jcache, tcache=tcache, src_img=src_img, src_smpl=src_smpl)


@pytest.fixture(scope="module")
def world():
    return _world(S)


def test_composer_uv_raster_matches(world):
    same = n(world["tcomp"].uv_fim) == np.asarray(world["jcomp"].uv_fim)
    assert same.mean() >= 0.999
    assert np.abs(n(world["tcomp"].uv_wim) - np.asarray(world["jcomp"].uv_wim))[same].max() < 1e-4


@pytest.mark.parametrize("field", ["uv_img", "bg_img", "src_f2pts", "src_cam", "src_shape"])
def test_setup_source_cache_fields(world, field):
    a, b = getattr(world["tcache"], field), getattr(world["jcache"], field)
    if field in ("src_f2pts", "src_cam", "src_shape"):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5, rtol=0)
    else:
        _close(a, b)


def test_setup_source_features(world):
    tc, jc = world["tcache"], world["jcache"]
    assert len(tc.src_enc_outs) == len(jc.src_enc_outs) == 3
    assert len(tc.src_res_outs) == len(jc.src_res_outs) == 2
    for a, b in zip(tc.src_enc_outs + tc.src_res_outs, jc.src_enc_outs + jc.src_res_outs):
        _close(a, b)


def test_setup_source_with_masks_bg_and_part_mask(world):
    rng = np.random.RandomState(2)
    masks = (rng.rand(1, NS, S, S, 1) > 0.5).astype(np.float32)
    bg = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    part = np.zeros((world["tm"].faces.shape[0],), bool)
    part[::3] = True
    jc = jimit.setup_source(world["jcomp"], world["jgen"], world["params"],
                            jnp.asarray(world["src_img"]), jnp.asarray(world["src_smpl"]),
                            masks=jnp.asarray(masks), bg_img=jnp.asarray(bg),
                            part_mask=jnp.asarray(part))
    tc = timit.setup_source(world["tcomp"], world["tgen"], t(world["src_img"]),
                            t(world["src_smpl"]), masks=t(masks), bg_img=t(bg),
                            part_mask=torch.as_tensor(part))
    np.testing.assert_array_equal(n(tc.bg_img), bg)
    np.testing.assert_allclose(n(tc.src_f2pts), np.asarray(jc.src_f2pts), atol=1e-5, rtol=0)
    _close(tc.uv_img, jc.uv_img)


def test_prepare_target_smpls(world):
    tgt = thetas(12, seed=3)
    tgt[:, 1:3] = np.random.RandomState(4).randn(12, 2).astype(np.float32) * 0.05
    for strategy in ("smooth", "source", "ref_txty", "copy"):
        ref = jimit.prepare_target_smpls(world["jm"], world["jcache"], tgt, strategy)
        out = timit.prepare_target_smpls(world["tm"], world["tcache"], tgt, strategy)
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(timit.infer_foot_y(world["tm"], tgt, chunk=5),
                               jimit.infer_foot_y(world["jm"], tgt), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def frames(world):
    tgt = timit.prepare_target_smpls(world["tm"], world["tcache"], thetas(2, seed=5))
    jp, jmask = jax.jit(lambda p, c, s: jimit.synthesize_frames(
        world["jcomp"], world["jgen"], p, c, s))(world["params"], world["jcache"], jnp.asarray(tgt))
    tp, tmask = timit.synthesize_frames(world["tcomp"], world["tgen"], world["tcache"], t(tgt))
    return tgt, (jp, jmask), (tp, tmask)


def test_synthesize_frames_matches_jax(frames):
    _, (jp, jmask), (tp, tmask) = frames
    assert tp.shape == (2, S, S, 3) and tmask.shape == (2, S, S, 1)
    _close(tp, jp)
    _close(tmask, jmask)
    assert n(tp).std() > 1e-3 and np.isfinite(n(tp)).all()


def test_make_frame_inputs_matches_jax(world, frames):
    tgt = frames[0]
    j_in, j_tst, j_info = jimit.make_frame_inputs(world["jcomp"], world["jcache"], jnp.asarray(tgt))
    t_in, t_tst, t_info = timit.make_frame_inputs(world["tcomp"], world["tcache"], t(tgt))
    assert (n(t_info["fim"]) == np.asarray(j_info["fim"])).mean() >= 0.999
    _close(t_in, j_in)
    _close(t_tst, j_tst)


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_branch_equals_full_ref_info_branch(world, frames, stride):
    """Inside the port: the fused raster+flow branch and the
    `render_smpl_info` + `cal_bc_transform` branch give the same inputs."""
    tgt = t(frames[0])
    a_in, a_tst, a_info = timit.make_frame_inputs(world["tcomp"], world["tcache"], tgt,
                                                  tst_stride=stride)
    b_in, b_tst, b_info = timit.make_frame_inputs(world["tcomp"], world["tcache"], tgt,
                                                  tst_stride=stride, full_ref_info=True)
    assert a_tst.shape == b_tst.shape == (2, NS, S // stride, S // stride, 2)
    np.testing.assert_array_equal(n(a_info["fim"]), n(b_info["fim"]))
    np.testing.assert_allclose(n(a_in), n(b_in), atol=1e-6, rtol=0)
    np.testing.assert_allclose(n(a_tst), n(b_tst), atol=1e-6, rtol=0)
    assert "wim" in b_info and "wim" not in a_info


def test_make_tsf_inputs_matches_jax_and_the_frame_inputs(world, frames):
    tgt = t(frames[0])
    t_in, _, info = timit.make_frame_inputs(world["tcomp"], world["tcache"], tgt, full_ref_info=True)
    out = tfc.make_tsf_inputs(world["tcomp"], world["tcache"].uv_img, info)
    assert out.shape == (1, 2, S, S, 6)
    np.testing.assert_allclose(n(out[0]), n(t_in), atol=1e-5, rtol=0)
    j_info = {"fim": jnp.asarray(n(info["fim"])), "wim": jnp.asarray(n(info["wim"])),
              "cond": jnp.asarray(n(info["cond"]))}
    ref = jfc.make_tsf_inputs(world["jcomp"], jnp.asarray(n(world["tcache"].uv_img)), j_info)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=1e-5, rtol=0)


def test_imitate_sequence_padding(world):
    tgt = timit.prepare_target_smpls(world["tm"], world["tcache"], thetas(5, seed=6))
    out = imitate_sequence(world["tcomp"], world["tgen"], world["tcache"], tgt, chunk=4,
                           device="cpu")
    whole, _ = timit.synthesize_frames(world["tcomp"], world["tgen"], world["tcache"], t(tgt))
    assert out.shape == (5, S, S, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, n(whole), atol=1e-5, rtol=0)


def test_compute_dtype_knob_runs(world, frames):
    tgt, _, (tp, _) = frames
    bp, bmask = timit.synthesize_frames(world["tcomp"], world["tgen"], world["tcache"], t(tgt),
                                        compute_dtype=torch.bfloat16)
    assert bp.dtype == torch.float32 and bmask.dtype == torch.float32
    assert np.abs(n(bp) - n(tp)).mean() < 0.05  # close, but no parity is claimed


def test_reference_precision_sets_and_restores_tf32_flags():
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with timit.reference_precision():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


def test_table_route_off_its_tile_takes_the_exact_branch(monkeypatch):
    """`IPERCORE_CSR_RASTER=0` at S = 64, not a multiple of the 8x128 table
    tile: the frame geometry takes the unfused `render_smpl_info` +
    `cal_bc_transform` branch, as the JAX package does off its Pallas route,
    and the frames equal JAX's at the tolerances above."""
    monkeypatch.setenv("IPERCORE_CSR_RASTER", "0")
    w = _world(64)
    tgt = timit.prepare_target_smpls(w["tm"], w["tcache"], thetas(2, seed=5))
    j_in, j_tst, j_info = jimit.make_frame_inputs(w["jcomp"], w["jcache"], jnp.asarray(tgt))
    t_in, t_tst, t_info = timit.make_frame_inputs(w["tcomp"], w["tcache"], t(tgt))
    assert "wim" in t_info  # the unfused branch
    assert t_in.shape == (2, 64, 64, 6) and t_tst.shape == (2, NS, 64, 64, 2)
    assert (n(t_info["fim"]) == np.asarray(j_info["fim"])).mean() >= 0.999
    _close(t_in, j_in)
    _close(t_tst, j_tst)
    jp, jmask = jax.jit(lambda p, c, s: jimit.synthesize_frames(w["jcomp"], w["jgen"], p, c, s))(
        w["params"], w["jcache"], jnp.asarray(tgt))
    tp, tmask = timit.synthesize_frames(w["tcomp"], w["tgen"], w["tcache"], t(tgt))
    _close(tp, jp)
    _close(tmask, jmask)
