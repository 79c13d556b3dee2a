"""K4, the table-binned fused raster: `bin_faces_table` against JAX
`_bin_faces` exactly, and `raster_flows_table` (its plain version here on the
CPU) against `rasterize_flows_pallas` in interpret mode, with and without
overflowing tiles."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipercore_tpu.models import smpl as jsmpl
from ipercore_tpu.ops import rasterizer as jrz
from ipercore_tpu.ops.rasterizer_pallas import _bin_faces, rasterize_flows_pallas
from ipercore_tpu_torch.ops import rasterizer as rz
from ipercore_tpu_torch.ops import rasterizer_cuda as trc
from ipercore_tpu_torch.utils.logging import counts

from tests.test_torch_common import body_face_verts, n, scene, t


def overflow_scene() -> np.ndarray:
    """The overflow scene of the JAX package's own test: 16 near triangles
    cover the top 8x128 tile at z = 0.5, 200 small ones stack behind them."""
    rng = np.random.RandomState(1)
    tris = []
    y0, y1 = -1.02, -0.85
    for q in range(8):
        x0 = -1.02 + q * 0.26
        x1 = x0 + 0.27
        tris.append([[x0, y0, 0.5], [x1, y0, 0.5], [x0, y1, 0.5]])
        tris.append([[x1, y0, 0.5], [x1, y1, 0.5], [x0, y1, 0.5]])
    for i in range(200):
        cx = rng.uniform(-0.95, 0.95)
        cy = rng.uniform(-0.99, -0.92)
        d = rng.uniform(0.02, 0.05, (3, 2))
        z = 1.0 + i * 0.01
        tris.append([[cx + d[j, 0], cy + d[j, 1], z] for j in range(3)])
    return np.asarray(tris, np.float32)


def body_frames_512(frames=(3, 5)) -> np.ndarray:
    """Frames of the main path's first chunk (`chip_smoke.target_smpls(8, 100)`)
    on the synthetic body, projected by the JAX package: (n, 13776, 3, 3)."""
    from chip_smoke import target_smpls

    model = jsmpl.template_model()
    d = jsmpl.get_details(model, jnp.asarray(target_smpls(8, 100)[list(frames)]))
    return np.asarray(jrz.verts_to_faces(jrz.project_verts(d["verts"], d["cam"]), model.faces))


def _jax_bins(fv: np.ndarray, S: int, k: int):
    _, ids, mask, true_counts = jax.jit(lambda f: _bin_faces(f, S, k))(jnp.asarray(fv))
    return np.asarray(ids), np.asarray(mask), np.asarray(true_counts)


def _assert_bins_equal(fv: np.ndarray, S: int, k: int, bins, frame: int):
    ids, mask, counts = _jax_bins(fv, S, k)
    np.testing.assert_array_equal(n(bins.true_counts[frame]), counts)
    np.testing.assert_array_equal(n(bins.kept[frame]), mask.sum(1))
    mine = n(bins.ids[frame])
    for tile in range(mine.shape[0]):
        kept = int(mask[tile].sum())
        assert mask[tile, :kept].all()  # JAX's real slots come first
        np.testing.assert_array_equal(mine[tile, :kept], ids[tile, :kept], err_msg=f"tile {tile}")
        assert (mine[tile, kept:] == -1).all()


def test_bin_faces_table_equals_jax_on_the_scene():
    fv = scene()
    bins = trc.bin_faces_table(t(fv)[None], 128, k=128, with_stats=True)
    _assert_bins_equal(fv, 128, 128, bins, 0)
    assert bins.stats["n_overflow_tiles"] == 0


def test_bin_faces_table_equals_jax_on_the_overflow_scene():
    fv = overflow_scene()
    bins = trc.bin_faces_table(t(fv)[None], 128, k=32, with_stats=True)
    _assert_bins_equal(fv, 128, 32, bins, 0)
    assert bins.stats["n_overflow_tiles"] >= 1 and bins.stats["max_tile_load"] > 32


def test_bin_faces_table_equals_jax_on_overflowing_body_frames_at_512():
    fv = body_frames_512()
    bins = trc.bin_faces_table(t(fv), 512, k=2048, with_stats=True)
    for f in range(fv.shape[0]):
        _assert_bins_equal(fv[f], 512, 2048, bins, f)
    assert bins.stats["n_overflow_tiles"] >= 1 and bins.stats["max_tile_load"] > 2048
    # kept ids are in non-decreasing minimum-depth order inside every tile
    minz = t(fv)[..., 2].amin(-1)
    for f in range(fv.shape[0]):
        ids = bins.ids[f].long()
        z = torch.where(ids >= 0, minz[f][ids.clamp(min=0)], torch.full_like(ids, 1e9, dtype=torch.float32))
        assert bool((z[:, 1:] >= z[:, :-1]).all())


def _hold(fim, flows, jfim, jflows, frac=0.999, tol=1e-2):
    same = n(fim) == np.asarray(jfim)
    assert same.mean() >= frac, same.mean()
    assert np.abs(n(flows) - np.asarray(jflows))[same].max() < tol


def test_raster_flows_table_matches_interpret_mode():
    fv = scene()
    aux = np.random.RandomState(3).uniform(-1, 1, (2,) + fv.shape[:2] + (2,)).astype(np.float32)
    jfim, jflows = rasterize_flows_pallas(jnp.asarray(fv), jnp.asarray(aux), 128, k=128,
                                          chunk=64, interpret=True)
    fim, flows, stats = trc.raster_flows_table(t(fv)[None], t(aux), 128, k=128, with_stats=True)
    assert fim.shape == (1, 128, 128) and flows.shape == (1, 128, 128, 2, 2)
    assert stats["n_overflow_tiles"] == 0
    _hold(fim[0], flows[0], jfim, jflows)


def test_raster_flows_table_matches_interpret_mode_with_overflow():
    fv = overflow_scene()
    aux = np.random.RandomState(5).uniform(-1, 1, (3,) + fv.shape[:2] + (2,)).astype(np.float32)
    jfim, jflows = rasterize_flows_pallas(jnp.asarray(fv), jnp.asarray(aux), 128, k=32,
                                          chunk=16, interpret=True)
    fim, flows, stats = trc.raster_flows_table(t(fv)[None], t(aux), 128, k=32, with_stats=True)
    assert stats["n_overflow_tiles"] >= 1
    _hold(fim[0], flows[0], jfim, jflows)
    assert (n(fim[0]) == np.asarray(jfim)).all()  # exact: same table, same arithmetic
    # capacity is part of the result: with room for every face, the table
    # route equals the CSR route, and the dropped faces were all occluded here
    full_fim, _ = trc.raster_flows_table(t(fv)[None], t(aux), 128, k=256)
    assert (n(full_fim) == n(fim)).all()


def test_table_and_csr_routes_agree_without_overflow():
    fv = body_face_verts(2, seed=7)
    aux = np.random.RandomState(6).uniform(-1, 1, (3,) + fv.shape[1:3] + (2,)).astype(np.float32)
    fim, flows, stats = trc.raster_flows_table(t(fv), t(aux), 128, with_stats=True)
    cfim, cflows = trc.raster_flows(t(fv), t(aux), 128)
    assert stats["n_overflow_tiles"] == 0
    same = n(fim) == n(cfim)
    assert same.mean() >= 0.999
    # 1e-4, not the 1e-5 of the JAX package's own K1/K4 test: the two routes
    # round a*px + b*py + c in different orders (`table_bary`), and small
    # faces have large barycentric coefficients
    assert np.abs(n(flows) - n(cflows))[same].max() < 1e-4


BARY_ORDERS = {
    "fma(a,px,b*py)+c": lambda a, b, c, px, py: rz.fma32(a, px, b * py) + c,
    "fma(b,py,a*px)+c": lambda a, b, c, px, py: rz.fma32(b, py, a * px) + c,
    "plain": lambda a, b, c, px, py: (a * px + b * py) + c,
    "fma(a,px,fma(b,py,c))": lambda a, b, c, px, py: rz.fma32(a, px, rz.fma32(b, py, c)),
}


@pytest.mark.parametrize("order", list(BARY_ORDERS))
def test_table_bary_order(order, monkeypatch):
    """Which rounding of `a*px + b*py + c` JAX's K4 uses in interpret mode
    decides equal-depth pixels on shared edges of the overflow scene (10, 2
    and 5 of them differ with the other orders). Only the implemented order
    (`table_bary`) gives JAX's face-index map exactly; after a JAX upgrade the
    failing case names the new order."""
    fv = overflow_scene()
    aux = np.zeros((1,) + fv.shape[:2] + (2,), np.float32)
    jfim, _ = rasterize_flows_pallas(jnp.asarray(fv), jnp.asarray(aux), 128, k=32, chunk=16,
                                     interpret=True)
    monkeypatch.setattr(trc, "table_bary", BARY_ORDERS[order])
    fim, _ = trc.raster_flows_table(t(fv)[None], t(aux), 128, k=32)
    exact = bool((n(fim[0]) == np.asarray(jfim)).all())
    assert exact == (order == "fma(a,px,b*py)+c")


def test_plain_version_does_not_depend_on_its_chunking():
    fv = overflow_scene()
    aux = np.random.RandomState(8).uniform(-1, 1, (1,) + fv.shape[:2] + (2,)).astype(np.float32)
    a = trc.raster_flows_table_plain(t(fv)[None], t(aux), 128, k=32)
    b = trc.raster_flows_table_plain(t(fv)[None], t(aux), 128, k=32, max_elems=16 * 1024 * 3)
    assert (n(a[0]) == n(b[0])).all() and (n(a[1]) == n(b[1])).all()


@pytest.mark.parametrize("case", ["size", "dtype", "aux_shape", "per_frame_aux"])
def test_bad_input_raises(case):
    fv = t(scene())[None]
    aux = torch.zeros((2, fv.shape[1], 3, 2))
    size = 128
    if case == "size":
        size = 96
    elif case == "dtype":
        fv = fv.double()
    elif case == "aux_shape":
        aux = torch.zeros((2, fv.shape[1] - 1, 3, 2))
    else:
        aux = aux[None]
    with pytest.raises(ValueError):
        trc.raster_flows_table(fv, aux, size)


def test_cpu_tensors_do_not_count_launches():
    before = counts().get("k4.launches", 0)
    trc.raster_flows_table(t(scene())[None], torch.zeros((1, 64, 3, 2)), 128)
    assert counts().get("k4.launches", 0) == before == 0


def _tri(x0, y0, size, z):
    """A right triangle with its corner at (x0, y0), legs `size`, depths z (3,)."""
    return [[x0, y0, z[0]], [x0 + size, y0, z[1]], [x0, y0 + size, z[2]]]


def tie_scene() -> np.ndarray:
    """Faces of one 8x128 tile (the top-left one at 128^2) whose minimum
    depths tie: ids 1, 3 and 4 at 2.0, ids 0 and 2 at 1.5 and 3.0; the table
    must hold 0, 1, 3, 4, 2."""
    z = [[1.5, 2.5, 2.5], [2.0, 2.0, 2.0], [3.0, 3.0, 3.5], [2.5, 2.0, 2.5], [2.0, 3.0, 2.0]]
    return np.asarray([_tri(-0.99 + 0.3 * i, -0.99, 0.05, z[i]) for i in range(5)], np.float32)


def signed_zero_scene() -> np.ndarray:
    """Minimum depths +0.0 (id 0), -0.0 (id 1) and -1.0 (id 2) in one tile:
    -0.0 equals +0.0, as argsort compares them, so the table is 2, 0, 1."""
    z = [[0.0, 2.0, 2.0], [-0.0, 2.0, 2.0], [-1.0, 2.0, 2.0]]
    return np.asarray([_tri(-0.99 + 0.3 * i, -0.99, 0.05, z[i]) for i in range(3)], np.float32)


TABLE_CASES = {
    "scene": (scene, 128, 128),
    "overflow_scene": (overflow_scene, 128, 32),
    "overflow_scene_k8": (overflow_scene, 128, 8),
    "tie_scene": (tie_scene, 128, 16),
    "signed_zero_scene": (signed_zero_scene, 128, 16),
}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_device_binning_mirror_equals_plain_binning_and_jax(case):
    """`prepare_table_plain`, the mirror of the device binning (its 64-bit
    sort key), builds the tables of `bin_faces_table` and of JAX `_bin_faces`,
    and the walk's work items from them."""
    make, S, k = TABLE_CASES[case]
    fv = make()
    plan = trc.prepare_table_plain(t(fv)[None], S, k)
    bins = trc.bin_faces_table(t(fv)[None], S, k)
    for name in ("ids", "kept", "true_counts"):
        np.testing.assert_array_equal(n(getattr(plan.bins, name)), n(getattr(bins, name)), err_msg=name)
    _assert_bins_equal(fv, S, k, plan.bins, 0)
    kept = n(plan.bins.kept[0]).astype(np.int64)
    per_tile = trc.TABLE_PARTS * -(-kept // trc.TABLE_ITEM)
    np.testing.assert_array_equal(n(plan.items[0]), np.concatenate([[0], np.cumsum(per_tile)]))
    stats = trc.table_stats(plan)
    assert stats == trc.bin_faces_table(t(fv)[None], S, k, with_stats=True).stats
    if case == "tie_scene":
        np.testing.assert_array_equal(n(plan.bins.ids[0, 0, :5]), [0, 1, 3, 4, 2])
    if case == "signed_zero_scene":
        np.testing.assert_array_equal(n(plan.bins.ids[0, 0, :3]), [2, 0, 1])
    if case == "overflow_scene_k8":
        assert stats["n_overflow_tiles"] >= 1 and stats["max_tile_load"] > 8


def test_device_binning_mirror_on_body_frames_at_512():
    fv = body_frames_512()
    plan = trc.prepare_table_plain(t(fv), 512, 2048)
    bins = trc.bin_faces_table(t(fv), 512, 2048)
    for name in ("ids", "kept", "true_counts"):
        assert torch.equal(getattr(plan.bins, name), getattr(bins, name)), name
    assert trc.table_stats(plan)["n_overflow_tiles"] >= 1
    geom, _ = trc.face_geometry(t(fv))
    assert torch.equal(plan.geom, geom)


def test_table_depth_key_orders_as_floats():
    z = torch.tensor([-np.inf, -3.0, -1e-30, -0.0, 0.0, 1e-30, 0.5, 2.0, np.inf])
    key = trc.table_depth_key(z)
    assert bool((key[1:] >= key[:-1]).all())
    assert int(key[3]) == int(key[4])  # -0.0 == +0.0
    assert bool((key[1:3] < key[2:4]).all()) and bool((key[4:] < torch.cat([key[5:], key[-1:] + 1])).all())
    assert int(key.max()) < 2 ** 32 and int(key.min()) >= 0


def test_equal_depth_pixels_pick_the_face_jax_picks():
    """Two coplanar faces at one constant depth overlap: every pixel they
    share is an exact depth tie, which the entry earlier in the table (equal
    minimum depth: the lower id, face 1) wins, in the port and in JAX K4 in
    interpret mode."""
    fv = np.asarray([[[0.5, 0.5, 3.0], [0.9, 0.5, 3.0], [0.5, 0.9, 3.0]],
                     [[-0.6, -0.6, 1.0], [0.4, -0.5, 1.0], [-0.2, 0.5, 1.0]],
                     [[-0.5, -0.7, 1.0], [0.5, -0.6, 1.0], [0.0, 0.6, 1.0]]], np.float32)
    aux = np.random.RandomState(4).uniform(-1, 1, (1, 3, 3, 2)).astype(np.float32)
    jfim, jflows = rasterize_flows_pallas(jnp.asarray(fv), jnp.asarray(aux), 128, k=16, chunk=8,
                                          interpret=True)
    fim, flows = trc.raster_flows_table(t(fv)[None], t(aux), 128, k=16)
    np.testing.assert_array_equal(n(fim[0]), np.asarray(jfim))
    np.testing.assert_allclose(n(flows[0]), np.asarray(jflows), atol=1e-5, rtol=0)
    assert (n(fim[0]) == 1).sum() > 100 and (n(fim[0]) == 2).sum() > 10  # face 2 only off face 1
    # the tie decides: with face 2's depth a little nearer, it takes face 1's pixels
    fv[2, :, 2] = 0.999
    nearer, _ = trc.raster_flows_table(t(fv)[None], t(aux), 128, k=16)
    assert (n(nearer[0]) == 1).sum() < (n(fim[0]) == 1).sum() // 2
