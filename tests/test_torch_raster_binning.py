"""The static-size tile binning of K1 and K3 (`prepare_raster`: at most E_CAP
tile entries per face, larger faces on a per-frame wide list) on the CPU:
against the exact (tile, face) pairs, against JAX `_bin_faces_csr` under the
port's 16x16 tiles, and walked work item by work item as the CUDA walk reads
it (`csrc/raster.cu`), which must give `rasterize` bit for bit."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipercore_tpu.ops.rasterizer_pallas import _bin_faces_csr
from ipercore_tpu_torch.ops import rasterizer as trz
from ipercore_tpu_torch.ops import rasterizer_cuda as trc

from tests.test_torch_common import body_face_verts, n, scene, t


def _exact_pairs(fv: np.ndarray, size: int):
    """Per frame {tile: set of face ids} of every valid face whose box, padded
    by 2 px, touches the tile (f32 arithmetic in numpy), and the spans."""
    f32 = np.float32
    T, F = fv.shape[:2]
    g = -(-size // trc.TILE)
    _, valid = trz._face_bary_matrices(t(fv))
    valid = n(valid)

    def axis(v):
        lo = (v.min(-1) + f32(1.0)) * f32(size * 0.5) - f32(0.5) - f32(2.0)
        hi = (v.max(-1) + f32(1.0)) * f32(size * 0.5) - f32(0.5) + f32(2.0)
        return (np.clip(np.floor(lo / f32(trc.TILE)), 0, g - 1).astype(int),
                np.clip(np.floor(hi / f32(trc.TILE)), 0, g - 1).astype(int))

    (x0, x1), (y0, y1) = axis(fv[..., 0]), axis(fv[..., 1])
    span = np.where(valid, (x1 - x0 + 1) * (y1 - y0 + 1), 0)
    pairs = [dict() for _ in range(T)]
    for f in range(T):
        for face in np.nonzero(valid[f])[0]:
            for ty in range(y0[f, face], y1[f, face] + 1):
                for tx in range(x0[f, face], x1[f, face] + 1):
                    pairs[f].setdefault(ty * g + tx, set()).add(int(face))
    return pairs, span


def _plan_lists(plan: trc.RasterPlan, T: int, n_tiles: int):
    """Per frame and tile the listed face ids, and per frame the wide list."""
    counts, seg, ids = n(plan.counts), n(plan.seg), n(plan.ids)
    lists = [[ids[seg[f * n_tiles + k]:seg[f * n_tiles + k] + counts[f * n_tiles + k]]
              for k in range(n_tiles)] for f in range(T)]
    wide = [n(plan.wide_ids)[f, :n(plan.wide_count)[f]] for f in range(T)]
    return lists, wide


def _frames(which: str) -> np.ndarray:
    if which == "scene":
        return np.stack([scene(), scene()[::-1].copy()])
    return body_face_verts(2, seed=21)


@pytest.mark.parametrize("which,size", [("scene", 128), ("scene", 100), ("body", 64), ("body", 100)])
def test_static_binning_holds_the_exact_pairs(which, size):
    """Listed pairs plus each wide face in every tile of its range are, tile by
    tile as sets, the exact pairs; wide faces are those spanning > E_CAP tiles;
    segments, item starts and stats follow from the counts."""
    fv = _frames(which)
    T, F = fv.shape[:2]
    g = -(-size // trc.TILE)
    n_tiles = g * g
    plan = trc.prepare_raster(t(fv), size)
    pairs, span = _exact_pairs(fv, size)
    lists, wide = _plan_lists(plan, T, n_tiles)
    counts = n(plan.counts).reshape(T, n_tiles)
    for f in range(T):
        assert sorted(wide[f].tolist()) == sorted(np.nonzero(span[f] > trc.E_CAP)[0].tolist())
        assert (np.diff(wide[f]) > 0).all()
        wide_pairs = {}
        for face in wide[f]:
            for k, faces in pairs[f].items():
                if face in faces:
                    wide_pairs.setdefault(k, set()).add(int(face))
        for k in range(n_tiles):
            lst = lists[f][k]
            assert (np.diff(lst) > 0).all()
            assert not set(lst.tolist()) & set(wide[f].tolist())
            assert set(lst.tolist()) | wide_pairs.get(k, set()) == pairs[f].get(k, set()), (f, k)
        load = counts[f] + len(wide[f])
        want_items = np.concatenate([[0], np.cumsum(-(-load // trc.ITEM))])
        np.testing.assert_array_equal(n(plan.items)[f], want_items)
        np.testing.assert_array_equal(
            n(plan.seg)[f * n_tiles:(f + 1) * n_tiles], f * F * trc.E_CAP + np.cumsum(counts[f]) - counts[f])
    stats = trc.plan_stats(plan)
    assert stats == {"max_span": int(span.max()), "total_entries": int(span.sum()),
                     "listed_entries": int(counts.sum()),
                     "max_tile_load": int((counts + n(plan.wide_count)[:, None]).max()),
                     "wide_faces": int((span > trc.E_CAP).sum()), "n_overflow_tiles": 0}
    if which == "scene":
        assert stats["wide_faces"] >= 1  # the big triangles
    assert plan.geom.shape == (T, F, 16) and plan.ids.shape == (T * F * trc.E_CAP,)


@pytest.mark.parametrize("size", [64, 128])
def test_static_binning_holds_jax_csr_pairs(size):
    """Where no face passes JAX's caps (16 entries per face, 16F in all), every
    pair of jitted JAX `_bin_faces_csr` under 16x16 tiles (its box padded by
    1 px) is in the port's lists (padded by 2 px)."""
    fv = body_face_verts(2, seed=22)
    T, F = fv.shape[:2]
    g = size // trc.TILE
    plan = trc.prepare_raster(t(fv), size)
    lists, wide = _plan_lists(plan, T, g * g)
    for f in range(T):
        _, fids, seg, counts, st = jax.jit(lambda x: _bin_faces_csr(
            x, size, 16, 16 * F, 64, tile_h=trc.TILE, tile_w=trc.TILE))(jnp.asarray(fv[f]))
        assert int(st["max_span"]) <= 16 and int(st["total_entries"]) <= 16 * F
        assert len(wide[f]) == 0
        fids, seg, counts = np.asarray(fids), np.asarray(seg), np.asarray(counts)
        assert counts.sum() == int(st["total_entries"]) > 0
        for k in range(g * g):
            jax_set = set(fids[seg[k]:seg[k] + counts[k]].tolist())
            assert jax_set <= set(lists[f][k].tolist()), (f, k, sorted(jax_set - set(lists[f][k].tolist())))


def _walk(plan: trc.RasterPlan, size: int):
    """The CUDA walk and epilogue in numpy/torch: every work item (tile,
    slice of ITEM entries of its list + wide list) keeps per pixel the
    smallest key (f32 bits of depth << 32 | face id), items merge by min,
    and the winner's barycentrics are recomputed. Returns fim, wim."""
    geom = plan.geom
    T = geom.shape[0]
    g = -(-size // trc.TILE)
    n_tiles = g * g
    lists, wide = _plan_lists(plan, T, n_tiles)
    items = n(plan.items)
    coords = (2.0 * torch.arange(size, dtype=torch.float32) + 1.0 - size) / size
    eps = 2.0 / size
    no_face = np.iinfo(np.uint64).max
    zbuf = np.full((T, size, size), no_face, np.uint64)
    for f in range(T):
        for k in range(n_tiles):
            entries = np.concatenate([lists[f][k], wide[f]]).astype(np.int64)
            assert items[f, k + 1] - items[f, k] == -(-len(entries) // trc.ITEM)
            ty, tx = divmod(k, g)
            ys = torch.arange(ty * trc.TILE, min(ty * trc.TILE + trc.TILE, size))
            xs = torch.arange(tx * trc.TILE, min(tx * trc.TILE + trc.TILE, size))
            py, px = coords[ys][:, None, None], coords[xs][None, :, None]
            for i in range(items[f, k], items[f, k + 1]):
                ids = entries[(i - items[f, k]) * trc.ITEM:(i - items[f, k] + 1) * trc.ITEM]
                r = geom[f][torch.as_tensor(ids)]  # (m, 16)
                w = [trz.fma32(r[:, 3 * j + 1], py, r[:, 3 * j] * px) + r[:, 3 * j + 2] for j in range(3)]
                depth = (w[0] * r[:, 9] + w[1] * r[:, 10]) + w[2] * r[:, 11]
                ok = ((px >= r[:, 12] - eps) & (px <= r[:, 13] + eps) & (py >= r[:, 14] - eps)
                      & (py <= r[:, 15] + eps) & (w[0] >= -1e-6) & (w[1] >= -1e-6) & (w[2] >= -1e-6)
                      & (depth > trz.NEAR) & (depth < trz.FAR))
                bits = n(depth).view(np.uint32).astype(np.uint64)
                key = np.where(n(ok), (bits << np.uint64(32)) | ids.astype(np.uint64), no_face)
                cell = zbuf[f, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1]
                np.minimum(cell, key.min(-1), out=cell)
    none = zbuf == no_face
    fim = np.where(none, -1, (zbuf & np.uint64(0xFFFFFFFF)).astype(np.int64)).astype(np.int32)
    r = geom[torch.arange(T)[:, None, None], torch.as_tensor(np.maximum(fim, 0)).long()]
    px, py = coords[None, None, :], coords[None, :, None]
    w = torch.stack([trz.fma32(r[..., 3 * j + 1], py, r[..., 3 * j] * px) + r[..., 3 * j + 2]
                     for j in range(3)], -1)
    return fim, np.where(none[..., None], np.float32(0), n(w))


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _wide_scene() -> np.ndarray:
    """Small faces around two coplanar near faces (ids 5 and 40) that each
    span far more than E_CAP tiles at 128^2: the lower id must win the tie."""
    fv = scene()[4:].copy()  # the 60 small random faces
    big = np.asarray([[-0.95, -0.7, 0.3], [0.8, -0.9, 0.3], [0.1, 0.95, 0.3]], np.float32)
    fv[5] = big
    fv[40] = big
    return fv


@pytest.mark.parametrize("which", ["wide", "scene", "body"])
def test_walk_over_the_plan_equals_rasterize(which):
    """Walked as the kernel walks it, the plan gives `rasterize`'s fim and wim
    bit for bit: wide faces win their pixels, ties go to the lower id."""
    size = 128 if which == "wide" else 64
    fv = {"wide": lambda: _wide_scene()[None], "scene": lambda: _frames("scene"),
          "body": lambda: body_face_verts(2, seed=23)}[which]()
    plan = trc.prepare_raster(t(fv), size)
    fim, wim = _walk(plan, size)
    for f in range(fv.shape[0]):
        ref = trz.rasterize(t(fv[f]), size)
        np.testing.assert_array_equal(fim[f], n(ref.fim))
        np.testing.assert_array_equal(_bits(wim[f]), _bits(n(ref.wim)))
    if which == "wide":
        assert sorted(n(plan.wide_ids)[0, :n(plan.wide_count)[0]].tolist()) == [5, 40]
        assert (fim == 5).mean() > 0.3 and not (fim == 40).any()


def test_wide_face_through_the_wrappers():
    """`raster_flows` and `raster_fim` on the wide scene equal `rasterize` +
    `cal_bc_transform` exactly, and their stats count the wide faces."""
    size = 128
    fv = _wide_scene()[None]
    aux = np.random.RandomState(24).uniform(-1, 1, (2,) + fv.shape[1:3] + (2,)).astype(np.float32)
    ref = trz.rasterize(t(fv[0]), size)
    fim, flows, stats = trc.raster_flows(t(fv), t(aux), size, with_stats=True)
    out, stats3 = trc.raster_fim(t(fv), size, with_stats=True)
    np.testing.assert_array_equal(n(fim[0]), n(ref.fim))
    np.testing.assert_array_equal(n(out.fim[0]), n(ref.fim))
    np.testing.assert_array_equal(_bits(n(out.wim[0])), _bits(n(ref.wim)))
    for j in range(2):
        want = trz.cal_bc_transform(t(aux[j])[None], ref.fim[None], ref.wim[None])[0]
        np.testing.assert_array_equal(_bits(n(flows[0, :, :, j])), _bits(n(want)))
    assert stats == stats3
    assert stats["wide_faces"] == 2 and stats["max_span"] > trc.E_CAP
    assert stats["total_entries"] == _exact_pairs(fv, size)[1].sum()
    assert stats["listed_entries"] < stats["total_entries"] and stats["n_overflow_tiles"] == 0


def test_long_list_splits_into_work_items():
    """A tile listing more than ITEM faces gets several work items; merged by
    min key, they still give `rasterize` bit for bit."""
    rng = np.random.RandomState(25)
    c = rng.uniform(-0.5, -0.3, (700, 1, 2)).astype(np.float32)
    d = rng.uniform(-0.03, 0.03, (700, 3, 2)).astype(np.float32)
    z = rng.uniform(0.5, 3.0, (700, 1, 1)).astype(np.float32).repeat(3, 1)
    fv = np.concatenate([c + d, z], -1)[None]
    size = 64
    plan = trc.prepare_raster(t(fv), size)
    assert trc.plan_stats(plan)["max_tile_load"] > 2 * trc.ITEM
    assert (np.diff(n(plan.items)[0]) >= 3).any()
    fim, wim = _walk(plan, size)
    ref = trz.rasterize(t(fv[0]), size)
    np.testing.assert_array_equal(fim[0], n(ref.fim))
    np.testing.assert_array_equal(_bits(wim[0]), _bits(n(ref.wim)))
