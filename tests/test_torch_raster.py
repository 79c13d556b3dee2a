"""Rasterizer: the JAX package (XLA scan and Pallas kernels in interpret
mode) vs the PyTorch port's plain versions on the same numpy inputs (CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ipercore_tpu.models import mesh as jmesh
from ipercore_tpu.ops import rasterizer as jrz
from ipercore_tpu.ops.rasterizer_pallas import rasterize_flows_pallas_csr, rasterize_pallas
from ipercore_tpu_torch.models import mesh as tmesh
from ipercore_tpu_torch.ops import rasterizer as trz
from ipercore_tpu_torch.ops import rasterizer_cuda as trc

from tests.test_torch_common import body_face_verts, n, scene, small_models, t

S = 128


def test_constants_match():
    for name in ("NEAR", "FAR", "FLOW_SENTINEL", "EYE_DISTANCE"):
        assert getattr(trz, name) == getattr(jrz, name)


def test_pixel_centers_and_projection():
    np.testing.assert_array_equal(n(trz._pixel_centers(48)), np.asarray(jrz._pixel_centers(48)))
    rng = np.random.RandomState(0)
    v = rng.randn(2, 11, 3).astype(np.float32)
    cam = rng.rand(2, 3).astype(np.float32) + 0.5
    faces = rng.randint(0, 11, (7, 3))
    ref = jrz.project_verts(jnp.asarray(v), jnp.asarray(cam))
    out = trz.project_verts(t(v), t(cam))
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        n(trz.verts_to_faces(out, torch.as_tensor(faces))),
        np.asarray(jrz.verts_to_faces(jnp.asarray(n(out)), jnp.asarray(faces))))


@pytest.mark.parametrize("which", ["scene", "body"])
def test_face_bary_matrices(which):
    """1e-5 relative is the stated bar; with the fused multiply-add order of
    the JAX CPU build reproduced the matrices are in fact bit-equal. The JAX
    function is jitted, as it is inside `rasterize`: only compiled code fuses
    multiply-adds, and op-by-op execution differs from it by cancellation."""
    import jax

    fv = scene() if which == "scene" else body_face_verts(1, seed=1)[0]
    M_ref, valid_ref = jax.jit(jrz._face_bary_matrices)(jnp.asarray(fv))
    M, valid = trz._face_bary_matrices(t(fv))
    np.testing.assert_array_equal(n(valid), np.asarray(valid_ref))
    np.testing.assert_allclose(n(M), np.asarray(M_ref), rtol=1e-5, atol=0)
    assert (n(M) == np.asarray(M_ref)).mean() > 0.999


def _assert_raster_close(fim, wim, fim_ref, wim_ref, min_agree=0.999, wtol=1e-4):
    same = fim == fim_ref
    assert same.mean() >= min_agree, f"fim agreement {same.mean()}"
    assert np.abs(wim - wim_ref)[same].max() < wtol


@pytest.mark.parametrize("which,chunk", [("scene", None), ("scene", 16), ("body", None)])
def test_rasterize_matches_jax(which, chunk):
    fv = scene() if which == "scene" else body_face_verts(1, seed=2)[0]
    ref = jrz.rasterize(jnp.asarray(fv), S)
    out = trz.rasterize(t(fv), S, chunk=chunk)
    assert out.fim.dtype == torch.int32
    _assert_raster_close(n(out.fim), n(out.wim), np.asarray(ref.fim), np.asarray(ref.wim))
    assert (n(out.fim) >= 0).mean() > 0.05


def test_rasterize_batch_and_render_fim_wim():
    jm, tm = small_models()
    from ipercore_tpu.models import smpl as jsmpl
    from tests.test_torch_common import thetas

    th = thetas(2, seed=3)
    d = jsmpl.get_details(jm, jnp.asarray(th))
    f2_ref, fim_ref, wim_ref = jrz.render_fim_wim(d["verts"], d["cam"], jm.faces, 64)
    f2, fim, wim = trz.render_fim_wim(t(np.asarray(d["verts"])), t(np.asarray(d["cam"])), tm.faces, 64)
    np.testing.assert_allclose(n(f2), np.asarray(f2_ref), atol=1e-6, rtol=0)
    _assert_raster_close(n(fim), n(wim), np.asarray(fim_ref), np.asarray(wim_ref))


def test_z_tie_lowest_face_id_wins():
    """Two coplanar faces over the same pixels: the lower id wins, whichever
    chunk either falls in."""
    tri = [[-0.8, -0.8, 1.0], [0.8, -0.8, 1.0], [0.0, 0.8, 1.0]]
    far = [[-0.9, -0.9, 2.0], [0.9, -0.9, 2.0], [0.0, 0.9, 2.0]]
    fv = np.asarray([far, tri, tri, far], np.float32)
    for chunk in (None, 1, 2):
        fim = n(trz.rasterize(t(fv), 32, chunk=chunk).fim)
        assert set(np.unique(fim)) == {-1, 0, 1}
        assert (fim == 1).sum() > 50 and (fim == 2).sum() == 0
    np.testing.assert_array_equal(fim, np.asarray(jrz.rasterize(jnp.asarray(fv), 32).fim))


@pytest.mark.parametrize("size", [64, 128])
def test_uv_template_edge_pixels_match_jax(size):
    """Pixel centres of the synthetic UV atlas sit on triangle edges; only the
    right multiply-add order reproduces the JAX CPU result there."""
    jm, tm = small_models()
    ja, ta = jmesh.load_assets(jm), tmesh.load_assets(tm, device="cpu")
    ref = jrz.rasterize_uv_template(ja.f2uvs, size)
    out = trz.rasterize_uv_template(ta.f2uvs, size)
    assert out.fim.shape == (size, size) and out.wim.shape == (size, size, 3)
    _assert_raster_close(n(out.fim), n(out.wim), np.asarray(ref.fim), np.asarray(ref.wim))


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _uv_faces():
    jm, _ = small_models()
    f2 = np.asarray(jmesh.load_assets(jm).f2uvs)
    return np.concatenate([f2, np.ones(f2.shape[:-1] + (1,), np.float32)], -1)


# The multiply-add orders XLA's CPU backend could have chosen. The port
# implements ("fma2", "fma_a") for the matrices and "fma_ab_c" for the weights;
# every other candidate misses bits. If an upgrade of JAX / XLA / LLVM moves
# the order, the ids that fail here name the old and the new one: carry the new
# one into `ops/rasterizer.py` (`fma32` calls) and `csrc/raster.cu`.
_DET = {
    "plain": lambda x0, x1, x2, y0, y1, y2: x0 * (y1 - y2) - x1 * (y0 - y2) + x2 * (y0 - y1),
    "fma1": lambda x0, x1, x2, y0, y1, y2: _fma(x2, y0 - y1, _fma(-x1, y0 - y2, x0 * (y1 - y2))),
    "fma2": lambda x0, x1, x2, y0, y1, y2: _fma(x2, y0 - y1, _fma(x0, y1 - y2, -(x1 * (y0 - y2)))),
}
_C = {
    "plain": lambda xi, xj, yi, yj: xi * yj - xj * yi,
    "fma_a": lambda xi, xj, yi, yj: _fma(xi, yj, -(xj * yi)),
    "fma_b": lambda xi, xj, yi, yj: _fma(-xj, yi, xi * yj),
}
_W = {
    "plain": lambda a, b, c, px, py: (a * px + b * py) + c,
    "fma_ab_c": lambda a, b, c, px, py: _fma(b, py, a * px) + c,
    "fma_from_c": lambda a, b, c, px, py: _fma(a, px, _fma(b, py, c)),
    "fma_c_first": lambda a, b, c, px, py: _fma(b, py, _fma(a, px, c)),
}


@pytest.mark.parametrize("c_mode", list(_C))
@pytest.mark.parametrize("det_mode", list(_DET))
def test_fma_order_of_bary_matrices(det_mode, c_mode):
    """Only the implemented order gives the jitted JAX matrices bit for bit
    on the UV template, whose pixel centres sit on triangle edges."""
    import jax

    fv = _uv_faces()
    M_ref = np.asarray(jax.jit(jrz._face_bary_matrices)(jnp.asarray(fv))[0])
    x, y = t(fv[..., 0]), t(fv[..., 1])
    det = _DET[det_mode](*x.unbind(-1), *y.unbind(-1))
    deg = det.abs() < 1e-12
    inv = torch.where(deg, torch.zeros_like(det), 1.0 / torch.where(deg, torch.ones_like(det), det))

    def row(i, j):
        xi, xj, yi, yj = x[..., i], x[..., j], y[..., i], y[..., j]
        return torch.stack([yi - yj, xj - xi, _C[c_mode](xi, xj, yi, yj)], -1)

    M = n(torch.stack([row(1, 2), row(2, 0), row(0, 1)], -2) * inv[..., None, None])
    equal = float((_bits(M) == _bits(M_ref)).mean())
    if (det_mode, c_mode) == ("fma2", "fma_a"):
        assert equal == 1.0, f"implemented order is bit-equal on only {equal}"
        np.testing.assert_array_equal(_bits(n(trz._face_bary_matrices(t(fv))[0])), _bits(M_ref))
    else:
        assert equal < 1.0, "a second order matches: the data no longer tells them apart"


@pytest.mark.parametrize("w_mode", list(_W))
def test_fma_order_of_bary_weights(w_mode):
    """Only `fma(b, py, a * px) + c` gives JAX's weight map bit for bit and
    its face map on every pixel of the UV template at 64^2."""
    import jax

    size = 64
    fv = _uv_faces()
    ref = jrz.rasterize(jnp.asarray(fv), size)
    fim_ref, wim_ref = np.asarray(ref.fim), np.asarray(ref.wim)
    M_ref, valid = jax.jit(jrz._face_bary_matrices)(jnp.asarray(fv))
    M, valid = t(np.asarray(M_ref)), torch.tensor(np.asarray(valid))
    pix = trz._pixel_centers(size)
    px, py = pix[:, 0], pix[:, 1]
    a, b, c = M[..., 0, None], M[..., 1, None], M[..., 2, None]
    W = _W[w_mode](a, b, c, px, py)  # (F, 3, P)
    z = t(fv[..., 2])
    box, eps = trz._face_bbox(t(fv)), 2.0 / size
    in_box = ((px >= box[:, 0:1] - eps) & (px <= box[:, 1:2] + eps)
              & (py >= box[:, 2:3] - eps) & (py <= box[:, 3:4] + eps))
    depth = (W[:, 0] * z[:, 0:1] + W[:, 1] * z[:, 1:2]) + W[:, 2] * z[:, 2:3]
    ok = (W >= -1e-6).all(1) & in_box & valid[:, None] & (depth > trz.NEAR) & (depth < trz.FAR)
    zz, arg = torch.where(ok, depth, torch.full_like(depth, float("inf"))).min(0)
    fim = n(torch.where(torch.isinf(zz), torch.full_like(arg, -1), arg)).reshape(size, size)
    w = W[arg, :, torch.arange(size * size)]
    w = n(torch.where(torch.isinf(zz)[:, None], torch.zeros_like(w), w)).reshape(size, size, 3)
    same = fim == fim_ref
    equal = float((_bits(w) == _bits(wim_ref))[same].mean())
    if w_mode == "fma_ab_c":
        assert same.all() and equal == 1.0, f"fim {same.mean()}, wim bit-equal {equal}"
    else:
        assert equal < 1.0, "a second order matches: the data no longer tells them apart"


def test_raster_fim_plain_matches_pallas_interpret():
    fv = scene()
    ref = rasterize_pallas(jnp.asarray(fv), S, k=128, chunk=64, interpret=True)
    out, stats = trc.raster_fim(t(fv)[None], S, with_stats=True)
    _assert_raster_close(n(out.fim[0]), n(out.wim[0]), np.asarray(ref.fim), np.asarray(ref.wim),
                         wtol=1e-2)
    assert stats["n_overflow_tiles"] == 0 and stats["max_tile_load"] >= 1


def test_raster_flows_plain_matches_pallas_csr_interpret():
    fv = np.stack([scene(), scene()[::-1]])
    rng = np.random.RandomState(4)
    aux = rng.uniform(-1, 1, (3,) + fv.shape[1:3] + (2,)).astype(np.float32)
    fim_ref, fl_ref, st_ref = rasterize_flows_pallas_csr(
        jnp.asarray(fv), jnp.asarray(aux), S, chunk=64, interpret=True, with_stats=True)
    fim, flows, stats = trc.raster_flows(t(fv), t(aux), S, with_stats=True)
    assert flows.shape == (2, S, S, 3, 2) and fim.dtype == torch.int32
    same = n(fim) == np.asarray(fim_ref)
    assert same.mean() > 0.999
    assert np.abs(n(flows) - np.asarray(fl_ref))[same].max() < 1e-2
    assert (n(flows)[n(fim) < 0] == trz.FLOW_SENTINEL).all()
    assert stats["n_overflow_tiles"] == 0 and stats["total_entries"] > 0
    assert int(st_ref["max_span"]) <= 16  # the reference did not truncate either


def test_raster_flows_per_frame_aux():
    fv = body_face_verts(2, seed=5)
    rng = np.random.RandomState(6)
    aux = rng.uniform(-1, 1, (2, 2) + fv.shape[1:3] + (2,)).astype(np.float32)
    fim, flows = trc.raster_flows(t(fv), t(aux), 64)
    for i in range(2):
        fim_i, flows_i = trc.raster_flows(t(fv[i:i + 1]), t(aux[i]), 64)
        np.testing.assert_array_equal(n(fim[i]), n(fim_i[0]))
        np.testing.assert_array_equal(n(flows[i]), n(flows_i[0]))


def test_raster_wrappers_reject_bad_input():
    fv = t(scene())
    with pytest.raises(ValueError):
        trc.raster_fim(fv, 32)  # not batched
    with pytest.raises(TypeError):
        trc.raster_fim(fv[None].double(), 32)
    with pytest.raises(ValueError):
        trc.raster_flows(fv[None], torch.zeros(2, 5, 3, 2), 32)  # wrong F


@pytest.mark.parametrize("size", [64, 100])
def test_binning_covers_every_visible_face(size):
    """Every face the plain raster shows in a tile is in that tile's list or
    on its frame's wide list, the lists are sorted by face id, and no entry is
    lost (sizes that are not a tile multiple included)."""
    fv = t(body_face_verts(2, seed=7))
    plan = trc.prepare_raster(fv, size)
    counts, seg, ids = n(plan.counts), n(plan.seg), n(plan.ids)
    g = (size + trc.TILE - 1) // trc.TILE
    assert seg.shape == counts.shape == (2 * g * g,) and ids.shape == (2 * fv.shape[1] * trc.E_CAP,)
    stats = trc.plan_stats(plan)
    assert counts.sum() == stats["listed_entries"] <= stats["total_entries"]
    for f in range(2):
        fim = n(trz.rasterize(fv[f], size).fim)
        wide = set(n(plan.wide_ids)[f, :n(plan.wide_count)[f]].tolist())
        for ty in range(g):
            for tx in range(g):
                k = f * g * g + ty * g + tx
                lst = ids[seg[k]:seg[k] + counts[k]]
                assert (np.diff(lst) > 0).all()
                seen = set(np.unique(fim[ty * 16:(ty + 1) * 16, tx * 16:(tx + 1) * 16])) - {-1}
                assert seen <= set(lst.tolist()) | wide
    assert plan.geom.shape == (2, fv.shape[1], 16)


def test_cal_bc_transform():
    fv = body_face_verts(2, seed=8)
    rng = np.random.RandomState(9)
    src = rng.uniform(-1, 1, fv.shape[:3] + (2,)).astype(np.float32)
    out = trc.raster_fim(t(fv), 64)
    ref = jrz.cal_bc_transform(jnp.asarray(src), jnp.asarray(n(out.fim)), jnp.asarray(n(out.wim)))
    got = trz.cal_bc_transform(t(src), out.fim, out.wim)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-6, rtol=0)
    assert (n(got)[n(out.fim) < 0] == -2.0).all()


def test_encode_fim_and_visibility_exact():
    jm, tm = small_models()
    ja, ta = jmesh.load_assets(jm), tmesh.load_assets(tm, device="cpu")
    fim = trc.raster_fim(t(body_face_verts(2, seed=10)), 64).fim
    F = tm.faces.shape[0]
    jf = jnp.asarray(n(fim))
    np.testing.assert_array_equal(n(trz.encode_fim(fim, ta.map_fn)),
                                  np.asarray(jrz.encode_fim(jf, ja.map_fn)))
    vis_ref = jrz.visible_face_mask(jf, F)
    vis = trz.visible_face_mask(fim, F)
    np.testing.assert_array_equal(n(vis), np.asarray(vis_ref))
    assert 0 < n(vis).sum() < 2 * F
    np.testing.assert_array_equal(
        n(trz.expand_mask_by_knn(vis, ta.face_k_nearest)),
        np.asarray(jrz.expand_mask_by_knn(vis_ref, ja.face_k_nearest)))
    f2 = np.random.RandomState(11).randn(2, F, 3, 2).astype(np.float32)
    np.testing.assert_array_equal(n(trz.select_f2pts(t(f2), vis)),
                                  np.asarray(jrz.select_f2pts(jnp.asarray(f2), vis_ref)))


def test_visibility_without_face_zero_or_background():
    """Face 0 must not be marked by background pixels, nor dropped when seen."""
    fim = torch.full((1, 4, 4), -1, dtype=torch.int32)
    assert not n(trz.visible_face_mask(fim, 5)).any()
    fim[0, 0, 0] = 0
    fim[0, 1, 1] = 3
    np.testing.assert_array_equal(n(trz.visible_face_mask(fim, 5))[0],
                                  [True, False, False, True, False])
    knn = torch.tensor([[0, 1], [1, 2], [2, 3], [3, 4], [4, 0]])
    mask = torch.tensor([[False, False, False, True, False]])
    np.testing.assert_array_equal(n(trz.expand_mask_by_knn(mask, knn))[0],
                                  [False, False, False, True, True])
