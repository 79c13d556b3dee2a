"""Viewer and swapper building blocks against their JAX twins on the same
numpy inputs (CPU): the rotation conversions, the novel-view / view /
bullet-time target makers, `merge_source_caches` and the SMPL smoother."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ipercore_tpu.models import imitator as jimit
from ipercore_tpu.ops import rotations as jrot
from ipercore_tpu.utils import smoothing as jsmooth
from ipercore_tpu_torch.models import imitator as timit
from ipercore_tpu_torch.ops import rotations as trot
from ipercore_tpu_torch.utils import smoothing as tsmooth

from tests.test_torch_common import n, t, thetas


def _rotmats() -> np.ndarray:
    """Rotations with the three branches of rotmat_to_axis_angle: generic,
    within 1e-3 of pi, below 1e-6, plus the identity."""
    rng = np.random.RandomState(0)
    aa = rng.randn(64, 3).astype(np.float32)
    axes = rng.randn(6, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    near_pi = (axes * (np.pi - 2e-4)).astype(np.float32)
    tiny = (axes * 3e-7).astype(np.float32)
    aa = np.concatenate([aa, near_pi, tiny, np.zeros((1, 3), np.float32)])
    return np.asarray(jrot.rodrigues(jnp.asarray(aa)))


CONVERSIONS = {
    "rodrigues": (lambda: np.random.RandomState(1).randn(5, 7, 3).astype(np.float32)),
    "rotmat_to_rot6d": _rotmats,
    "rot6d_to_rotmat": (lambda: np.random.RandomState(2).randn(40, 6).astype(np.float32)),
    "rotmat_to_axis_angle": _rotmats,
    "axis_angle_to_rot6d": (lambda: np.random.RandomState(3).randn(4, 24, 3).astype(np.float32)),
    "rot6d_to_axis_angle": (lambda: np.random.RandomState(4).randn(4, 24, 6).astype(np.float32)),
    "quat_to_rotmat": (lambda: np.random.RandomState(5).randn(30, 4).astype(np.float32)),
}


@pytest.mark.parametrize("name", list(CONVERSIONS))
def test_rotation_conversion_matches_jax(name):
    x = CONVERSIONS[name]()
    ref = np.asarray(getattr(jrot, name)(jnp.asarray(x)))
    out = n(getattr(trot, name)(t(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("t_pose", [False, True])
def test_make_novel_view_smpls_matches_jax(t_pose):
    src = thetas(1, seed=6)[0]
    ref = np.asarray(jimit.make_novel_view_smpls(jnp.asarray(src), n_frames=12, use_t_pose=t_pose))
    out = n(timit.make_novel_view_smpls(t(src), n_frames=12, use_t_pose=t_pose))
    assert out.shape == (12, 85)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("angle", [0.0, 45.0, -120.0, 180.0])
def test_add_view_effect_matches_jax(angle):
    smpls = thetas(5, seed=7)
    ref = np.asarray(jimit.add_view_effect(jnp.asarray(smpls), angle))
    out = n(timit.add_view_effect(t(smpls), angle))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_add_bullet_time_effect_matches_jax():
    smpls = thetas(6, seed=8)
    ref = np.asarray(jimit.add_bullet_time_effect(jnp.asarray(smpls), [4, 1, 99], duration=5))
    out = n(timit.add_bullet_time_effect(t(smpls), [4, 1, 99], duration=5))
    assert out.shape == ref.shape == (6 + 3 * 5, 85)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_frames", [30, 8, 5])
def test_temporal_smooth_smpls_matches_jax(n_frames):
    """Thirty frames go through the low-pass, eight through the exponential
    average that stands in where the filter's padding is too long, five are
    returned as they are."""
    rng = np.random.RandomState(9)
    smpls = thetas(n_frames, seed=10, pose_scale=0.3)
    smpls[:, 0:3] += np.cumsum(rng.randn(n_frames, 3).astype(np.float32) * 0.02, axis=0)
    ref = jsmooth.temporal_smooth_smpls(smpls, pose_fc=300.0, cam_fc=100.0)
    out = tsmooth.temporal_smooth_smpls(smpls, pose_fc=300.0, cam_fc=100.0)
    assert out.dtype == np.float32 and out.shape == smpls.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tsmooth.lowpass_filtfilt(smpls[:, :3], 100.0),
                               jsmooth.lowpass_filtfilt(smpls[:, :3], 100.0), atol=1e-6, rtol=0)


def test_merge_source_caches_matches_jax():
    rng = np.random.RandomState(11)
    F, S = 10, 8

    def cache(ns, seed):
        r = np.random.RandomState(seed)
        uv = r.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
        uv[:, : S // 2] = 0.0  # unseen texels: the other person fills them
        return dict(
            enc=tuple(r.randn(1, ns, S // 2 ** i, S // 2 ** i, 4).astype(np.float32) for i in range(3)),
            res=tuple(r.randn(1, ns, 2, 2, 4).astype(np.float32) for _ in range(2)),
            uv=uv, bg=r.uniform(-1, 1, (1, S, S, 3)).astype(np.float32),
            f2pts=r.uniform(-1, 1, (ns, F, 3, 2)).astype(np.float32),
            cam=r.randn(ns, 3).astype(np.float32), shape=r.randn(ns, 10).astype(np.float32))

    raw = [cache(2, 12), cache(1, 13)]
    masks = [rng.rand(F) > 0.5, rng.rand(F) > 0.5]

    def build(mod, conv):
        return [mod.SourceCache(src_enc_outs=tuple(conv(e) for e in c["enc"]),
                                src_res_outs=tuple(conv(r) for r in c["res"]),
                                uv_img=conv(c["uv"]), bg_img=conv(c["bg"]), src_f2pts=conv(c["f2pts"]),
                                src_cam=conv(c["cam"]), src_shape=conv(c["shape"])) for c in raw]

    ref = jimit.merge_source_caches(None, build(jimit, jnp.asarray), [jnp.asarray(m) for m in masks])
    out = timit.merge_source_caches(None, build(timit, t), [torch.as_tensor(m) for m in masks])
    assert out.src_f2pts.shape == (3, F, 3, 2) and out.uv_img.shape == (1, S, S, 3)
    for a, b in zip(out.src_enc_outs + out.src_res_outs, ref.src_enc_outs + ref.src_res_outs):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    for field in ("uv_img", "bg_img", "src_f2pts", "src_cam", "src_shape"):
        np.testing.assert_allclose(n(getattr(out, field)), np.asarray(getattr(ref, field)),
                                   atol=1e-6, rtol=0, err_msg=field)
