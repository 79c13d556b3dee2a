"""The deformers of preprocessing: the soft silhouettes, the silhouette offset
fit and the cloth links, JAX package vs the PyTorch port on the same numpy
inputs (CPU), on the JAX tests' small body (`synthetic_model(nu=20, nv=18)`)
at 32²-64²; and a bound on what autograd keeps for the silhouette fit's
backward at the full 13 776 faces."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipercore_tpu.models import smpl as jsmpl
from ipercore_tpu.tools import deformers as jdef
from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.tools import deformers as tdef

from tests.test_torch_common import n, small_models, t


@pytest.fixture(scope="module")
def models():
    return small_models(20, 18)


class _Info:
    def __init__(self, arrays):
        self.arrays = dict(arrays)

    def get_array(self, key):
        return self.arrays.get(key)


class _Opt(dict):
    def get(self, k, d=None):
        return dict.get(self, k, d)

    __getattr__ = dict.__getitem__


def _frames(count: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    theta = np.zeros((count, 85), np.float32)
    theta[:, 0] = 1.2 + 0.1 * rng.rand(count)
    theta[:, 1:3] = rng.randn(count, 2) * 0.05
    theta[:, 3:75] = rng.randn(count, 72) * 0.1
    return theta


def _posed(jm, theta, offsets=None):
    off = 0.0 if offsets is None else jnp.asarray(offsets)
    d = jsmpl.get_details(jm, jnp.asarray(theta), offsets=off)
    return np.asarray(d["verts"]), np.asarray(d["cam"])


def _grad_check(got_fn, want_fn, verts, w):
    """The port against jitted JAX (as the offset fit runs it): the forward
    within 1e-5 and the gradient of sum(w * sil) with respect to the vertices
    within 1e-4 of its largest magnitude, or within JAX's own spread where
    that is larger. Barycentrics of sliver faces have large, cancelling
    coefficients, and the sigmoid's slope of size / 4 amplifies their
    rounding, so JAX's jitted and eager forms of this function already
    disagree at a few pixels (up to 4e-4 at 64², 3 frames): the port is held
    as close to jitted JAX as JAX's two forms are to each other."""
    loss = lambda v: jnp.sum(want_fn(v) * w)
    x = jnp.asarray(verts)
    want_sil, want_g = np.asarray(jax.jit(want_fn)(x)), np.asarray(jax.jit(jax.grad(loss))(x))
    spread_sil = np.abs(np.asarray(want_fn(x)) - want_sil).max()
    scale = np.abs(want_g).max()
    spread_g = np.abs(np.asarray(jax.grad(loss)(x)) - want_g).max() / scale
    v = t(verts).requires_grad_(True)
    sil = got_fn(v)
    (g,) = torch.autograd.grad((sil * t(w)).sum(), [v])
    np.testing.assert_allclose(n(sil), want_sil, atol=max(1e-5, spread_sil), rtol=0)
    assert np.isfinite(want_g).all() and scale > 0
    np.testing.assert_allclose(n(g), want_g, atol=max(1e-4, spread_g) * scale, rtol=0)
    return want_sil


def test_soft_silhouette_matches_jax(models):
    jm, _ = models
    verts, cam = _posed(jm, _frames(1, 0))
    w = np.random.RandomState(1).randn(48, 48).astype(np.float32)
    sil = _grad_check(lambda v: tdef.soft_silhouette(v, t(cam[0]), 48),
                      lambda v: jdef.soft_silhouette(v, jnp.asarray(cam[0]), 48), verts[0], w)
    assert 0.05 < sil.mean() < 0.9


@pytest.mark.parametrize("size,chunk", [(32, 512), (48, 100)])
def test_soft_silhouette_raster_matches_jax(models, size, chunk):
    """One frame as JAX takes it (V, 3); the face chunks of 512 (one chunk of
    the small body's 720 faces) and of 100 (eight, the last one short)."""
    jm, tm = models
    verts, cam = _posed(jm, _frames(1, 2))
    w = np.random.RandomState(3).randn(size, size).astype(np.float32)
    faces_j = jm.faces
    sil = _grad_check(
        lambda v: tdef.soft_silhouette_raster(v, t(cam[0]), tm.faces, size, chunk=chunk),
        lambda v: jdef.soft_silhouette_raster(v, jnp.asarray(cam[0]), faces_j, size, chunk=chunk),
        verts[0], w)
    assert 0.05 < sil.mean() < 0.9 and sil.max() > 0.99


@pytest.mark.parametrize("size", [32, 64])
def test_soft_silhouette_raster_batches_as_jax_vmaps(models, size):
    """Frames on a leading axis (as the offset fit calls it) give JAX's vmap
    over them (`_grad_check`'s bar)."""
    jm, tm = models
    verts, cam = _posed(jm, _frames(3, 4))
    w = np.random.RandomState(5).randn(3, size, size).astype(np.float32)
    _grad_check(lambda v: tdef.soft_silhouette_raster(v, t(cam), tm.faces, size),
                lambda v: jax.vmap(lambda vv, c: jdef.soft_silhouette_raster(vv, c, jm.faces, size))(
                    v, jnp.asarray(cam)), verts, w)


def _wider_body_masks(jm, theta, size):
    """`test_deformer_fit`'s observation: the hard silhouettes of a body
    widened radially in x and z, background = 1, (N, S, S, 1)."""
    from ipercore_tpu.ops import rasterizer as jrz

    v = np.asarray(jm.v_template)
    gt_off = np.zeros_like(v)
    gt_off[:, 0] = 0.15 * v[:, 0]
    gt_off[:, 2] = 0.15 * v[:, 2]
    d = jsmpl.get_details(jm, jnp.asarray(theta), offsets=jnp.asarray(gt_off))
    _, fim, _ = jrz.render_fim_wim(d["verts"], d["cam"], jm.faces, size)
    return 1.0 - (np.asarray(fim) >= 0).astype(np.float32)[..., None]


@pytest.mark.parametrize("mask_size", [64, 96])
def test_run_sil2smpl_offsets_matches_jax(models, mask_size):
    """The fit at 64² on masks at 64² and at 96² (resized down, antialiased,
    as `jax.image.resize` does). After 2 Adam steps every offset is within
    1e-5 of JAX's. After 3, at least 99 % are, and the rest within lr: Adam's
    step is lr * g / (|g| + 1e-8), so an offset whose gradient is float
    noise (1e-17 to 1e-9 at vertices the silhouette barely sees) moves by a
    noise-driven fraction of lr in each package."""
    jm, _ = models
    theta = np.zeros((2, 85), np.float32)
    theta[:, 0] = 1.2
    theta[:, 4] = [0.0, 0.15]
    masks = _wider_body_masks(jm, theta, mask_size)
    info = _Info({"smpls": theta, "masks": masks})
    opt = _Opt(smoke_model=True)  # both resolve to synthetic_model(nu=20, nv=18)
    lr = 2e-3
    for steps in (2, 3):
        want = jdef.run_sil2smpl_offsets(opt, info, n_steps=steps, lr=lr, reg=1.0, size=64)
        got = tdef.run_sil2smpl_offsets(opt, info, n_steps=steps, lr=lr, reg=1.0, size=64, device="cpu")
        assert got.shape == want.shape == (jm.v_template.shape[0], 3) and np.abs(want).max() > 1e-3
        err = np.abs(got - want)
        if steps == 2:
            assert err.max() <= 1e-5, err.max()
        else:
            assert (err <= 1e-5).mean() >= 0.99 and err.max() <= lr, (np.sort(err.ravel())[-5:])


def test_run_sil2smpl_offsets_without_arrays_is_zero(models):
    opt = _Opt(smoke_model=True)
    got = tdef.run_sil2smpl_offsets(opt, _Info({"smpls": np.zeros((2, 85), np.float32)}), device="cpu")
    want = jdef.run_sil2smpl_offsets(opt, _Info({"smpls": np.zeros((2, 85), np.float32)}))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and not got.any()


def _saved_bytes(verts, cam, faces, size, chunk):
    """Bytes of the distinct storages autograd saves for the backward of one
    silhouette loss (the saved-tensor hooks see every tensor the graph keeps;
    inside a checkpointed chunk the checkpoint's own hooks keep nothing)."""
    saved, held = {}, []

    def pack(x):  # distinct storages (held here, so no address is reused)
        st = x.untyped_storage()
        saved[st.data_ptr()] = st.nbytes()
        held.append(x)
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        v = verts.clone().requires_grad_(True)
        sil = tdef.soft_silhouette_raster(v, cam, faces, size, chunk=chunk)
        loss = (sil ** 2).mean()
    (g,) = torch.autograd.grad(loss, [v])
    assert torch.isfinite(g).all() and g.abs().max() > 0
    return sum(saved.values())


def test_sil_fit_backward_memory_is_bounded(monkeypatch):
    """The port's twin of `test_sil_fit_grad_memory_bounded`: at SMPL's 13 776
    faces (16², 2 frames, chunks of 512 and of 128) the bytes saved for the
    backward stay O(F + P) per frame and do not grow with the number of face
    chunks; without the per-chunk checkpoint the same loss saves every
    chunk's (chunk, P, 3) barycentrics and exceeds the bound many times."""
    model = tsmpl.synthetic_model(device="cpu")  # SMPL cardinalities
    F, V = model.faces.shape[0], model.v_template.shape[0]
    size, frames = 16, 2
    theta = torch.zeros(frames, 85)
    theta[:, 0] = 1.2
    d = tsmpl.get_details(model, theta)
    P = size * size
    # per frame: the projected vertices and their faces, the bary matrices,
    # f64 intermediates of their fused multiply-adds, the coverage
    bound = frames * 4 * (64 * V + 64 * F + 16 * P)
    a = _saved_bytes(d["verts"], d["cam"], model.faces, size, chunk=512)
    b = _saved_bytes(d["verts"], d["cam"], model.faces, size, chunk=128)
    assert a == b <= bound, (a, b, bound)
    monkeypatch.setattr(tdef, "checkpoint", lambda fn, *args, use_reentrant: fn(*args))
    c = _saved_bytes(d["verts"], d["cam"], model.faces, size, chunk=512)
    assert c > 5 * bound and c >= frames * F * P * 3 * 4, (c, bound)


# --- cloth links ------------------------------------------------------------------

def _legs(v):
    """`test_cloth_links._legs`: low-body vertices split by the sign of x."""
    low = v[:, 1] > 0.3
    left = np.nonzero(low & (v[:, 0] > 0.02))[0]
    right = np.nonzero(low & (v[:, 0] < -0.02))[0]
    return left.astype(np.int64), right.astype(np.int64)


@pytest.mark.parametrize("skirt_y", [-1.5, 0.6, 0.8, 1.5])
def test_smpl_link_equals_jax(models, skirt_y):
    """The same links from the same vertices; each link's target equal to
    JAX's, or, where JAX's nearest vertex by y ties with others (the sphere
    mesh's rings share a y, and the two packages' skinning rounds a vertex
    differently by up to 2.4e-7), one of the tied vertices: its y within
    1e-6 of JAX's target's, on JAX's posed vertices."""
    jm, tm = models
    legs = _legs(np.asarray(jm.v_template))
    theta = np.zeros((85,), np.float32)
    theta[0] = 1.0
    theta[2] = 0.05
    got = tdef.smpl_link(tm, theta, skirt_y=skirt_y, leg_ids=legs)
    want = jdef.smpl_link(jm, theta, skirt_y=skirt_y, leg_ids=legs)
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, [0, 2]], want[:, [0, 2]])
    y = np.asarray(jsmpl.get_details(jm, jnp.asarray(theta[None]))["verts"][0])[:, 1]
    differ = got[:, 1] != want[:, 1]
    np.testing.assert_allclose(y[got[differ, 1]], y[want[differ, 1]], atol=1e-6, rtol=0)
    if skirt_y > 1:
        assert len(got) > 0 and differ.mean() < 0.5


def test_inner_leg_ids_and_leg_vertex_ids_equal_jax(models):
    jm, tm = models
    left, right = _legs(np.asarray(jm.v_template))
    for ids, right_side in ((right, True), (left, False)):
        for rate in (0.3, 0.5):
            np.testing.assert_array_equal(tdef._inner_leg_ids(tm, ids, rate, right=right_side),
                                          jdef._inner_leg_ids(jm, ids, rate, right=right_side))
    got, want = tdef.load_leg_vertex_ids(), jdef.load_leg_vertex_ids()
    assert (got is None) == (want is None)
    if got is not None:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdef.LINKER_MEAN_SHAPE, jdef.LINKER_MEAN_SHAPE)


@pytest.mark.parametrize("hem", [-0.5, 0.2, 0.5, 2.0])
def test_find_cloth_links_equals_jax(models, hem):
    jm, _ = models
    verts = np.asarray(jm.v_template)
    got = tdef.find_cloth_links(verts, hem)
    want = jdef.find_cloth_links(verts, hem)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
