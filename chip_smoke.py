#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # everything; ends with the ok line
    python3 chip_smoke.py --only kernels  # build + kernel checks only, no ok line

Builds the CUDA kernels of `ipercore_tpu_torch` from the sources in this
checkout, holds each against its plain PyTorch version (and each device
binning against its plain binning) on the GPU at the shapes the main path
gives it, then drives the main path (full-width
AttLWB-SPADE with seeded random weights, synthetic body model, 512^2, two
source views, 16 target frames in chunks of 8) through the entry points a
user calls and checks its output. Then, each with the launch counts set to 0
before it and read after it: the table route (`IPERCORE_CSR_RASTER=0`, one
chunk), temporal mode (8 frames, a temporal generator on the same weights),
the three services `imitate`, `novel_view` and `swap` on a synthetic
processed directory written to a temporary directory, `personalize` on that
directory followed by `imitate` with the personalized weights, and the
personalization train step at full width (G + D `patch_global`, VGG19 and
Sphere20a losses, Adam; 512^2, 2 sources, 1 target) with K3 on its batches,
and the train service (`services/train.train`: datasets, prefetch, eval,
panels, checkpoints) in a 1-rank NCCL group for 8 iterations, then resumed
for 2 more, with K3 on its batches and its eval against the plain versions.
Reads no weight file: every network is seeded.
Every phase prints one JSON line; any failed check raises, so the exit code
is non-zero. Needs one GPU; exits with code 2 when there is none.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet) used for the bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

SIZE, NS, CHUNK, N_FRAMES = 512, 2, 8, 16
CFG = {
    "BGNet": {"num_filters": [64, 128, 128, 256], "n_res_block": 6},
    "SIDNet": {"num_filters": [64, 128, 256], "n_res_block": 6},
    "TSFNet": {"num_filters": [64, 128, 256], "n_res_block": 6},
}
REPLACES = {
    "raster_flows_csr": "ipercore_tpu/ops/rasterizer_pallas.py:710",
    "grid_sample_nhwc": "ipercore_tpu/ops/sampling_pallas.py:92",
    "raster_fim": "ipercore_tpu/ops/rasterizer_pallas.py:249",
    "raster_flows_table": "ipercore_tpu/ops/rasterizer_pallas.py:779",
}
TABLE_K = 2048  # faces per 8x128 tile of the table route, the JAX default
# the personalization default discriminator (`patch_global`) at its published width
DIS_CFG = {"ndf": 64, "n_layers": 4, "max_nf_mult": 8, "use_sigmoid": False}
NT = 1  # target frames per train step (`time_step`)
TRAIN_WARMUP, TRAIN_STEPS, SERVICE_ITERS = 3, 20, 4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of `fn()` on the GPU, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """(result, milliseconds) of one `fn()` on the GPU, host clock around a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, flops: float) -> tuple[float, str]:
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def raster_flops(face_verts, size: int, n_out_floats: int) -> float:
    """f32 operations the function needs for this run's data, whatever the
    kernel's tiling: every (pixel, valid face) pair whose guarded bounding box
    (+- 2/S) covers the pixel pays 30 (three barycentrics, inside test, depth,
    depth test, compare); every output float is a 5-operation blend. A pair
    outside the box needs no arithmetic and is not counted."""
    from ipercore_tpu_torch.ops import rasterizer as rz

    _, valid = rz._face_bary_matrices(face_verts)
    box = rz._face_bbox(face_verts)[valid].double()
    eps = 2.0 / size

    def covered(lo, hi):
        # pixel indices i with lo - eps <= (2i + 1 - S) / S <= hi + eps
        i0 = torch.ceil(((lo - eps) * size + size - 1) / 2).clamp(min=0)
        i1 = torch.floor(((hi + eps) * size + size - 1) / 2).clamp(max=size - 1)
        return (i1 - i0 + 1).clamp(min=0)

    pairs = covered(box[:, 0], box[:, 1]) * covered(box[:, 2], box[:, 3])
    return float(pairs.sum()) * 30 + n_out_floats * 5


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def source_inputs(device):
    rng = np.random.RandomState(0)
    src_img = torch.as_tensor(rng.uniform(-1, 1, (1, NS, SIZE, SIZE, 3)).astype(np.float32),
                              device=device)
    theta = np.zeros((NS, 85), np.float32)
    theta[:, 0] = 1.2
    theta[:, 3:75] = rng.randn(NS, 72).astype(np.float32) * 0.05
    return src_img, torch.as_tensor(theta, device=device).reshape(1, NS, 85)


def target_smpls(n: int, seed: int) -> np.ndarray:
    r = np.random.RandomState(seed)
    t = np.zeros((n, 85), np.float32)
    t[:, 0] = 1.2
    t[:, 3:75] = r.randn(n, 72).astype(np.float32) * 0.1
    return t


def geometry_inputs(model, assets, device):
    """face_verts (CHUNK, F, 3, 3), source face_verts (NS, F, 3, 3) and aux
    (1 + NS, F, 3, 2), as `make_frame_inputs` / `setup_source` form them."""
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.ops import rasterizer as rz

    def faces_of(theta):
        d = smpl_mod.get_details(model, theta)
        return rz.verts_to_faces(rz.project_verts(d["verts"], d["cam"]), model.faces).contiguous()

    _, src_smpl = source_inputs(device)
    src_fv = faces_of(src_smpl[0])
    tgt_fv = faces_of(torch.as_tensor(target_smpls(CHUNK, 100), device=device))
    aux = torch.cat([assets.f2uvs[None], src_fv[..., 0:2]], dim=0).contiguous()
    return tgt_fv, src_fv, aux


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def raster_agreement(fim_k, fim_p, val_k, val_p, what: str, bit_equal: bool = False) -> float:
    """fim agreement and the largest difference of flows or wim, held to the
    outer thresholds and, with `bit_equal`, to exact equality."""
    agree = (fim_k == fim_p)
    frac = float(agree.float().mean())
    err_all = float((val_k - val_p).abs().max())
    same = agree.reshape(agree.shape + (1,) * (val_k.dim() - agree.dim())).expand_as(val_k)
    err_same = float((val_k - val_p)[same].abs().max())
    check(frac >= 0.999, f"{what}: fim agreement {frac} < 0.999")
    check(err_all < 1e-2, f"{what}: max abs error {err_all} >= 1e-2 over all pixels")
    check(err_same < 1e-4, f"{what}: max abs error {err_same} >= 1e-4 where fim agrees")
    if bit_equal:
        check(frac == 1.0 and err_all == 0.0,
              f"{what}: not bit-equal to the plain version (fim agreement {frac}, max abs error {err_all})")
    return err_all


def binning_check(face_verts, size: int, what: str) -> dict:
    """The device binning against its plain version on the same faces: counts,
    segment starts, work items, wide counts, stats and the valid faces'
    geometry rows (bit for bit) equal; every tile's list and every wide list
    equal as sorted sets; the entries are every (tile, face) pair that a valid
    face's padded box touches, counted face by face. Returns the stats."""
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc

    plan = rc.prepare_raster(face_verts, size)
    ref = rc.prepare_raster_plain(face_verts, size)
    for name in ("counts", "seg", "items", "wide_count"):
        check(torch.equal(getattr(plan, name), getattr(ref, name)), f"{what}: binning {name} differ")
    stats = rc.plan_stats(plan)
    check(stats == rc.plan_stats(ref), f"{what}: binning stats {stats} != plain {rc.plan_stats(ref)}")
    _, valid = rz._face_bary_matrices(face_verts)
    check(torch.equal(plan.geom.view(torch.int32)[valid], ref.geom.view(torch.int32)[valid]),
          f"{what}: geometry rows of valid faces differ from face_geometry")

    def listed(p):  # sorted keys tile * F + face id of every listed entry
        F = face_verts.shape[1]
        counts = p.counts.long()
        tile = torch.repeat_interleave(torch.arange(counts.numel(), device=counts.device), counts)
        first = torch.cumsum(counts, 0) - counts
        slot = p.seg.long()[tile] + torch.arange(tile.numel(), device=tile.device) - first[tile]
        return torch.sort(tile * F + p.ids.long()[slot]).values

    def wide(p):
        F = p.wide_ids.shape[1]
        live = torch.arange(F, device=p.wide_ids.device)[None] < p.wide_count[:, None]
        return torch.sort(torch.where(live, p.wide_ids, F), dim=1).values

    check(torch.equal(listed(plan), listed(ref)), f"{what}: a tile's list differs from the plain one")
    check(torch.equal(wide(plan), wide(ref)), f"{what}: a wide list differs from the plain one")
    want = tiles_touched(face_verts, size)
    check(stats["total_entries"] == want, f"{what}: binning holds {stats['total_entries']} "
                                          f"(tile, face) pairs, faces touch {want}")
    return stats


def tile_loads(plan) -> dict:
    """Distribution of the faces each 16x16 tile walks (its list + its
    frame's wide list)."""
    T = plan.wide_count.numel()
    load = (plan.counts.reshape(T, -1) + plan.wide_count[:, None]).double().reshape(-1)
    return {"tiles": load.numel(), "max": int(load.max()), "mean": float(load.mean()),
            "p99": float(torch.quantile(load, 0.99)), "empty_share": float((load == 0).double().mean())}


# the names of the hand-written kernels (csrc/*.cu)
HAND_WRITTEN = re.compile(r"(raster|table|grid_sample|repack)_\w+_kernel(<\w+>)?")


def kernel_times(fn, reps: int = 1) -> list:
    """(device microseconds per call, name) of every kernel that `reps` calls of
    `fn()` launch, from torch.profiler. Every `fn` profiled here launches a
    kernel, so a trace without one is a lost reading: it is taken again, up
    to three times, and then raises rather than report 0."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = []
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us and ev.device_type == torch.autograd.DeviceType.CUDA:
                out.append((us / reps, ev.key))
        if out:
            return out
    raise RuntimeError("torch.profiler caught no device kernel in three traces")


def device_us_by_kernel(fn, reps: int = 5) -> dict:
    """Device microseconds per `fn()` call by kernel, after a warm-up call;
    the hand-written kernels by their short names."""
    fn()
    torch.cuda.synchronize()
    out = {}
    for us, key in kernel_times(fn, reps):
        m = HAND_WRITTEN.search(key)
        name = m.group(0) if m else key[:40]
        out[name] = out.get(name, 0.0) + us
    return out


def host_syncs(fn) -> int:
    """Host syncs that one `fn()` makes, counted by torch's sync debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def check_no_host_sync(fn, what: str) -> None:
    """`fn()` runs under sync debug mode "error", which raises on a host sync."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        raise AssertionError(f"{what} made a host sync: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def wide_scene(face_verts):
    """Two frames of the chunk with faces 5 and 40 replaced by one coplanar
    triangle in front of the body, spanning far more than E_CAP tiles: both
    go onto the wide list, face 5 must win their pixels."""
    fv = face_verts[:2].clone()
    big = torch.tensor([[-0.6, -0.5, 1.0], [0.5, -0.6, 1.0], [0.0, 0.7, 1.0]], device=fv.device)
    fv[:, 5] = big
    fv[:, 40] = big
    return fv.contiguous()


def table_checks(face_verts, k: int) -> None:
    """The K4 table itself: each tile keeps min(true_count, k) entries in its
    first slots, in non-decreasing minimum depth, and the true counts add up to
    the (tile, face) pairs that the valid faces' padded boxes touch, counted
    face by face."""
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc

    bins = rc.bin_faces_table(face_verts, SIZE, k, with_stats=True)
    ids = bins.ids.long()
    T = ids.shape[0]
    check(torch.equal(bins.kept, bins.true_counts.clamp(max=k)), f"k={k}: kept != min(true, k)")
    slot = torch.arange(k, device=ids.device)
    check(torch.equal(ids >= 0, slot < bins.kept[..., None]), f"k={k}: kept ids are not the first slots")
    minz = face_verts[..., 2].amin(-1)
    z = torch.gather(minz, 1, ids.clamp(min=0).reshape(T, -1)).reshape(ids.shape)
    z = torch.where(ids >= 0, z, torch.full_like(z, float("inf")))
    check(bool((z[..., 1:] >= z[..., :-1]).all()), f"k={k}: kept ids are not nearest first")
    _, valid = rz._face_bary_matrices(face_verts)
    x, y = face_verts[..., 0], face_verts[..., 1]
    to_px = lambda v: (v + 1.0) * (SIZE * 0.5) - 0.5

    def n_tiles(lo, hi, tile, g):
        t0 = torch.floor((to_px(lo) - 1) / tile).clamp(0, g - 1)
        t1 = torch.floor((to_px(hi) + 1) / tile).clamp(0, g - 1)
        return (t1 - t0 + 1).long()

    pairs = (n_tiles(x.amin(-1), x.amax(-1), rc.TABLE_TILE_W, SIZE // rc.TABLE_TILE_W)
             * n_tiles(y.amin(-1), y.amax(-1), rc.TABLE_TILE_H, SIZE // rc.TABLE_TILE_H))
    want = int(torch.where(valid, pairs, torch.zeros_like(pairs)).sum())
    check(int(bins.true_counts.sum()) == want == bins.stats["total_entries"],
          f"k={k}: true counts add to {int(bins.true_counts.sum())}, faces touch {want}")


def table_binning_check(face_verts, k: int, what: str) -> dict:
    """K4's device binning against the plain binning on the same faces: the
    tables (ids in table order, -1 past kept), kept and true counts bit for
    bit, the work items and the stats equal to the plain mirror's, the valid
    faces' geometry rows equal to `face_geometry`'s. Returns the stats."""
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc

    plan = rc.prepare_table(face_verts, SIZE, k)
    bins = rc.bin_faces_table(face_verts, SIZE, k, with_stats=True)
    for name in ("ids", "kept", "true_counts"):
        check(torch.equal(getattr(plan.bins, name), getattr(bins, name)),
              f"{what}: device table {name} differ from bin_faces_table's (k={k})")
    mirror = rc.prepare_table_plain(face_verts, SIZE, k)
    check(torch.equal(plan.items, mirror.items), f"{what}: work items differ from the plain mirror's")
    stats = rc.table_stats(plan)
    check(stats == bins.stats == rc.table_stats(mirror), f"{what}: stats {stats} != plain {bins.stats}")
    _, valid = rz._face_bary_matrices(face_verts)
    geom, _ = rc.face_geometry(face_verts)
    check(torch.equal(plan.geom.view(torch.int32)[valid], geom.view(torch.int32)[valid]),
          f"{what}: table geometry rows of valid faces differ from face_geometry")
    return stats


def crowded_tile_scene(device) -> torch.Tensor:
    """One frame whose top-left 8x128 tile holds 6000 small faces (more than
    the device select sorts whole in shared memory), many at tied minimum
    depths, under 3 faces that span the frame (the wide list)."""
    rng = np.random.RandomState(21)
    n = 6000
    c = np.stack([rng.uniform(-0.99, -0.55, n), rng.uniform(-0.995, -0.975, n)], -1)
    d = rng.uniform(0.002, 0.01, (n, 3, 2))
    z = np.round(rng.uniform(1.0, 3.0, (n, 1)), 2) + rng.uniform(0, 0.5, (n, 3)) * (rng.rand(n, 3) < 0.5)
    small = np.concatenate([c[:, None, :] + d, z[..., None]], -1)
    big = np.asarray([[[-0.95, -0.95, 4.0], [0.95, -0.9, 4.0], [0.0, 0.95, 4.0]],
                      [[-0.9, 0.9, 5.0], [0.9, 0.95, 5.0], [0.1, -0.95, 5.0]],
                      [[-0.99, -0.99, 3.5], [0.99, -0.99, 3.5], [-0.99, 0.99, 3.5]]])
    return torch.as_tensor(np.concatenate([small, big]).astype(np.float32), device=device)[None].contiguous()


def kernel_checks(model, assets, device) -> dict:
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.ops import sampling_cuda as sc

    tgt_fv, src_fv, aux = geometry_inputs(model, assets, device)
    T, F, J = tgt_fv.shape[0], tgt_fv.shape[1], aux.shape[0]
    results = {}

    # K1 ------------------------------------------------------------------
    fim, flows, stats = rc.raster_flows(tgt_fv, aux, SIZE, with_stats=True)
    torch.cuda.synchronize()
    (fim_p, flows_p), plain_ms = once_ms(lambda: rc.raster_flows_plain(tgt_fv, aux, SIZE))
    err = raster_agreement(fim, fim_p, flows, flows_p, "raster_flows", bit_equal=True)
    check(binning_check(tgt_fv, SIZE, "raster_flows") == stats, "raster_flows: stats differ")
    plan = rc.prepare_raster(tgt_fv, SIZE)
    check_no_host_sync(lambda: rc.raster_flows(tgt_fv, aux, SIZE), "raster_flows")
    b_ms, b_by = bound(nbytes(tgt_fv, aux, fim, flows), raster_flops(tgt_fv, SIZE, flows.numel()))
    results["raster_flows_csr"] = {
        "route": "cuda", "source": "ipercore_tpu_torch/csrc/raster.cu", "max_abs_err": err,
        "kernel_ms": cuda_ms(lambda: rc.launch_raster_flows(plan, aux, T, F, SIZE, J, False)),
        "wrapper_ms": cuda_ms(lambda: rc.raster_flows(tgt_fv, aux, SIZE)),
        "binning_ms": cuda_ms(lambda: rc.prepare_raster(tgt_fv, SIZE)),
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "host_syncs": host_syncs(lambda: rc.raster_flows(tgt_fv, aux, SIZE)),
        "host_syncs_with_stats": host_syncs(lambda: rc.raster_flows(tgt_fv, aux, SIZE, with_stats=True)),
        "tile_loads": tile_loads(plan),
        "device_us": device_us_by_kernel(lambda: rc.raster_flows(tgt_fv, aux, SIZE)),
        "shape": f"T={T} F={F} S={SIZE} J={J}", "stats": stats,
        "fim_agreement": float((fim == fim_p).float().mean()),
    }
    del flows_p, fim_p
    # the (T, J, F, 3, 2) form: aux that differs from frame to frame
    scale = 1.0 - 0.05 * torch.arange(T, dtype=torch.float32, device=device)
    aux_t = (aux[None] * scale[:, None, None, None, None]).contiguous()
    fim_t, flows_t = rc.raster_flows(tgt_fv, aux_t, SIZE)
    fim_p, flows_p = rc.raster_flows_plain(tgt_fv, aux_t, SIZE)
    err_t = raster_agreement(fim_t, fim_p, flows_t, flows_p, "raster_flows/per-frame aux", bit_equal=True)
    check(float((flows_t[1:] - flows[1:]).abs().max()) > 1e-3,
          "raster_flows: per-frame aux gave the flows of the shared aux")
    del flows_p, fim_p, flows_t, fim_t
    # faces on the wide list, K1 and K3, with a tie between two of them
    wide_fv = wide_scene(tgt_fv)
    wide_stats = binning_check(wide_fv, SIZE, "wide scene")
    check(wide_stats["wide_faces"] == 4, f"wide scene: {wide_stats['wide_faces']} wide faces, want 4")
    fim_w, flows_w = rc.raster_flows(wide_fv, aux, SIZE)
    fim_p, flows_p = rc.raster_flows_plain(wide_fv, aux, SIZE)
    err_w = raster_agreement(fim_w, fim_p, flows_w, flows_p, "raster_flows/wide scene", bit_equal=True)
    check(bool((fim_w == 5).any()) and not bool((fim_w == 40).any()), "wide scene: face 5 does not win the tie")
    out_w, ref_w = rc.raster_fim(wide_fv, SIZE), rc.raster_fim_plain(wide_fv, SIZE)
    err_w3 = raster_agreement(out_w.fim, ref_w.fim, out_w.wim, ref_w.wim, "raster_fim/wide scene",
                              bit_equal=True)
    results["raster_flows_csr"]["max_abs_err"] = max(err, err_t, err_w)
    results["raster_flows_csr"]["wide_scene_stats"] = wide_stats
    del fim_p, flows_p, fim_w, flows_w, out_w, ref_w

    # K4: the table route at the same chunk; k = 2048 overflows a few tiles,
    # k = 256 most of them ----------------------------------------------------
    fim4, flows4, stats4 = rc.raster_flows_table(tgt_fv, aux, SIZE, k=TABLE_K, with_stats=True)
    torch.cuda.synchronize()
    (fim_p, flows_p), plain_ms = once_ms(lambda: rc.raster_flows_table_plain(tgt_fv, aux, SIZE, TABLE_K))
    err4 = raster_agreement(fim4, fim_p, flows4, flows_p, "raster_flows_table", bit_equal=True)
    agree4 = float((fim4 == fim_p).float().mean())
    check(stats4["n_overflow_tiles"] >= 1,
          f"raster_flows_table: no tile overflows k={TABLE_K} on the main path's chunk ({stats4})")
    table_checks(tgt_fv, TABLE_K)
    del fim_p, flows_p
    fim_s, flows_s, stats256 = rc.raster_flows_table(tgt_fv, aux, SIZE, k=256, with_stats=True)
    fim_p, flows_p = rc.raster_flows_table_plain(tgt_fv, aux, SIZE, 256)
    err256 = raster_agreement(fim_s, fim_p, flows_s, flows_p, "raster_flows_table/k=256", bit_equal=True)
    agree256 = float((fim_s == fim_p).float().mean())
    table_checks(tgt_fv, 256)
    del fim_p, flows_p, fim_s, flows_s
    # the device binning tile by tile: this chunk at both capacities, the
    # source frames, and a crowded tile past the shared-memory sort (radix
    # select at k = 2048, pairwise ranks at k = 5000 and 8000)
    table_bins = {"chunk_k2048": table_binning_check(tgt_fv, TABLE_K, "table binning/chunk"),
                  "chunk_k256": table_binning_check(tgt_fv, 256, "table binning/chunk k=256"),
                  "source_k2048": table_binning_check(src_fv, TABLE_K, "table binning/source")}
    check(table_bins["chunk_k256"]["n_overflow_tiles"] > table_bins["chunk_k2048"]["n_overflow_tiles"],
          f"table binning: k=256 overflows no more tiles than k={TABLE_K}")
    crowd = crowded_tile_scene(device)
    for kc in (TABLE_K, 5000, 8000):
        table_bins[f"crowded_k{kc}"] = table_binning_check(crowd, kc, f"table binning/crowded k={kc}")
    check(table_bins["crowded_k2048"]["max_tile_load"] > 4096,
          f"crowded scene: densest tile holds {table_bins['crowded_k2048']['max_tile_load']} <= 4096")
    aux_c = torch.rand((1, crowd.shape[1], 3, 2), generator=torch.Generator().manual_seed(3)).to(device)
    fim_c, flows_c = rc.raster_flows_table(crowd, aux_c, SIZE, k=TABLE_K)
    fim_p, flows_p = rc.raster_flows_table_plain(crowd, aux_c, SIZE, TABLE_K)
    err_c = raster_agreement(fim_c, fim_p, flows_c, flows_p, "raster_flows_table/crowded", bit_equal=True)
    del fim_p, flows_p, fim_c, flows_c
    check_no_host_sync(lambda: rc.raster_flows_table(tgt_fv, aux, SIZE, k=TABLE_K), "raster_flows_table")
    plan4 = rc.prepare_table(tgt_fv, SIZE, TABLE_K)
    b_ms, b_by = bound(nbytes(tgt_fv, aux, fim4, flows4), raster_flops(tgt_fv, SIZE, flows4.numel()))
    results["raster_flows_table"] = {
        "route": "cuda", "source": "ipercore_tpu_torch/csrc/raster_table.cu",
        "binning_source": "ipercore_tpu_torch/csrc/raster_table_bin.cu",
        "max_abs_err": max(err4, err256, err_c),
        "kernel_ms": cuda_ms(lambda: rc.launch_raster_flows_table(plan4, aux, SIZE, J)),
        "wrapper_ms": cuda_ms(lambda: rc.raster_flows_table(tgt_fv, aux, SIZE, k=TABLE_K)),
        "binning_ms": cuda_ms(lambda: rc.prepare_table(tgt_fv, SIZE, TABLE_K)),
        "plain_binning_ms": cuda_ms(lambda: rc.bin_faces_table(tgt_fv, SIZE, TABLE_K), reps=3),
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "host_syncs": host_syncs(lambda: rc.raster_flows_table(tgt_fv, aux, SIZE, k=TABLE_K)),
        "host_syncs_with_stats": host_syncs(
            lambda: rc.raster_flows_table(tgt_fv, aux, SIZE, k=TABLE_K, with_stats=True)),
        "device_us": device_us_by_kernel(lambda: rc.raster_flows_table(tgt_fv, aux, SIZE, k=TABLE_K)),
        "work_items": int(plan4.items[:, -1].sum()),
        "shape": f"T={T} F={F} S={SIZE} J={J} k={TABLE_K}", "stats": stats4,
        "fim_agreement": agree4, "max_abs_err_k2048": err4,
        "k256": {"stats": stats256, "fim_agreement": agree256, "max_abs_err": err256},
        "device_binning_stats": table_bins,
    }
    del fim4, flows4

    # K3: source frames (N = NS) and the UV template (N = 1) ---------------
    uv_fv = torch.cat([assets.f2uvs, torch.ones_like(assets.f2uvs[..., :1])], dim=-1)[None].contiguous()
    worst, agree, loads3 = err_w3, 1.0, {}
    for name, fv in (("source", src_fv), ("uv_template", uv_fv)):
        out, st = rc.raster_fim(fv, SIZE, with_stats=True)
        ref = rc.raster_fim_plain(fv, SIZE)
        worst = max(worst, raster_agreement(out.fim, ref.fim, out.wim, ref.wim, f"raster_fim/{name}",
                                            bit_equal=True))
        agree = min(agree, float((out.fim == ref.fim).float().mean()))
        check(binning_check(fv, SIZE, f"raster_fim/{name}") == st, f"raster_fim/{name}: stats differ")
        loads3[name] = tile_loads(rc.prepare_raster(fv, SIZE))
    # the JAX K3 keeps 2048 faces per 8x128 tile; the exact-binned raster_fim
    # equals it while no such tile holds more
    k3_loads = {}
    for name, fv in (("source", src_fv), ("uv_template", uv_fv)):
        st = rc.bin_faces_table(fv, SIZE, TABLE_K, with_stats=True).stats
        k3_loads[name] = {"max_tile_load_8x128": st["max_tile_load"],
                          "n_overflow_tiles": st["n_overflow_tiles"]}
        check(st["max_tile_load"] <= TABLE_K,
              f"raster_fim/{name}: an 8x128 tile holds {st['max_tile_load']} faces > {TABLE_K}, "
              "so JAX rasterize_pallas would drop faces that raster_fim keeps")
    out, stats3 = rc.raster_fim(src_fv, SIZE, with_stats=True)
    _, plain_ms = once_ms(lambda: rc.raster_fim_plain(src_fv, SIZE))
    plan3 = rc.prepare_raster(src_fv, SIZE)
    check_no_host_sync(lambda: rc.raster_fim(src_fv, SIZE), "raster_fim")
    b_ms, b_by = bound(nbytes(src_fv, out.fim, out.wim), raster_flops(src_fv, SIZE, out.wim.numel()))
    results["raster_fim"] = {
        "route": "cuda", "source": "ipercore_tpu_torch/csrc/raster.cu", "max_abs_err": worst,
        "kernel_ms": cuda_ms(lambda: rc.launch_raster_fim(plan3, NS, F, SIZE)),
        "wrapper_ms": cuda_ms(lambda: rc.raster_fim(src_fv, SIZE)),
        "binning_ms": cuda_ms(lambda: rc.prepare_raster(src_fv, SIZE)),
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "host_syncs": host_syncs(lambda: rc.raster_fim(src_fv, SIZE)),
        "host_syncs_with_stats": host_syncs(lambda: rc.raster_fim(src_fv, SIZE, with_stats=True)),
        "tile_loads": loads3,
        "device_us": device_us_by_kernel(lambda: rc.raster_fim(src_fv, SIZE)),
        "shape": f"N={NS} F={F} S={SIZE}", "stats": stats3, "fim_agreement": agree,
        "jax_8x128_tile_loads": k3_loads,
    }

    # K2 ------------------------------------------------------------------
    import torch.nn.functional as Fn

    g = torch.Generator(device="cpu").manual_seed(0)
    uv_img = (torch.rand((1, SIZE, SIZE, 3), generator=g) * 2 - 1).to(device)
    imgs = uv_img.expand(T, SIZE, SIZE, 3)
    grid = flows[..., 0, :].contiguous()  # the Tuv2t flow of K1: sentinel -2 on background
    out = sc.grid_sample_nhwc(imgs, grid)
    ref, plain_ms = once_ms(lambda: sc.grid_sample_plain(imgs, grid))
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref), f"grid_sample_nhwc: not bit-equal to the plain version ({err})")
    # the main path's call: the grid read inside the flows, the result written
    # into the first three channels of the generator's input
    tsf = torch.full((T, SIZE, SIZE, 6), 7.0, device=device)
    main_call = lambda: sc.grid_sample_nhwc(imgs, flows[..., 0, :], out=tsf[..., :3])
    main_call()
    check(torch.equal(tsf[..., :3], ref) and bool((tsf[..., 3:] == 7.0).all()),
          "grid_sample_nhwc: the strided grid / out view call is not bit-equal to the plain version")
    # a non-tile-multiple output, 64 channels, coordinates beyond the image
    img64 = (torch.rand((2, 40, 56, 64), generator=g) * 2 - 1).to(device)
    grid_odd = (torch.rand((2, 100, 75, 2), generator=g) * 2.6 - 1.3).to(device)
    grid_odd[0, :5] = -2.0
    e64 = float((sc.grid_sample_nhwc(img64, grid_odd) - sc.grid_sample_plain(img64, grid_odd)).abs().max())
    check(e64 < 1e-5, f"grid_sample_nhwc: max abs error {e64} >= 1e-5 at 100x75, C=64")
    # the rgb4 path at that odd shape, into an out view
    img3 = img64[:1, ..., :3].contiguous().expand(2, -1, -1, -1)
    odd = torch.zeros((2, 100, 75, 5), device=device)
    sc.grid_sample_nhwc(img3, grid_odd, out=odd[..., 1:4])
    check(torch.equal(odd[..., 1:4], sc.grid_sample_plain(img3, grid_odd)),
          "grid_sample_nhwc: the shared RGB path differs from the plain version at 100x75")
    # bf16 image: the kernel converts taps to f32 exactly as the plain version does
    img_bf = img64.to(torch.bfloat16)
    out_bf = sc.grid_sample_nhwc(img_bf, grid_odd)
    check(out_bf.dtype == torch.float32, "grid_sample_nhwc: bf16 image must give f32 output")
    ebf = float((out_bf - sc.grid_sample_plain(img_bf, grid_odd)).abs().max())
    check(ebf < 1e-5, f"grid_sample_nhwc: max abs error {ebf} >= 1e-5 with a bf16 image")
    imgs_c = imgs.contiguous()
    nchw = imgs_c.permute(0, 3, 1, 2)
    lib = lambda: Fn.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False)
    elib = float((lib().permute(0, 2, 3, 1) - out).abs().max())
    # the main path hands the kernel one UV image broadcast over the batch
    b_ms, b_by = bound(nbytes(uv_img, grid, out), out.numel() * 8 + grid.numel() * 6)
    k_ms = cuda_ms(lambda: sc.grid_sample_nhwc(imgs, grid))
    results["grid_sample_nhwc"] = {
        "route": "cuda", "source": "ipercore_tpu_torch/csrc/grid_sample.cu",
        "max_abs_err": max(err, e64, ebf), "kernel_ms": k_ms, "wrapper_ms": k_ms,
        "main_path_call_ms": cuda_ms(main_call),
        "binning_ms": None, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lib), "max_abs_diff_vs_library": elib,
        "device_us": device_us_by_kernel(lambda: sc.grid_sample_nhwc(imgs, grid)),
        "main_path_call_device_us": device_us_by_kernel(main_call),
        "library_device_us": sum(device_us_by_kernel(lib).values()),
        "shape": f"N={T} H=W={SIZE} C=3 -> {SIZE}x{SIZE}",
    }
    return results


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def tiles_touched(face_verts, size: int) -> int:
    """Number of (tile, face) pairs the binning must hold: for every valid
    face the tiles its bounding box, padded by the binning's margin, touches."""
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops.rasterizer_cuda import _BIN_MARGIN_PX, TILE

    _, valid = rz._face_bary_matrices(face_verts)
    box = rz._face_bbox(face_verts)[valid]
    g = (size + TILE - 1) // TILE

    def n_tiles(lo, hi):
        t0 = torch.floor(((lo + 1.0) * (size * 0.5) - 0.5 - _BIN_MARGIN_PX) / TILE).clamp(0, g - 1)
        t1 = torch.floor(((hi + 1.0) * (size * 0.5) - 0.5 + _BIN_MARGIN_PX) / TILE).clamp(0, g - 1)
        return (t1 - t0 + 1).long()

    return int((n_tiles(box[:, 0], box[:, 1]) * n_tiles(box[:, 2], box[:, 3])).sum())


def counters() -> dict:
    """Launch counters: the four kernels, the device binning that K1 and K3
    launch before their walk, and K4's device binning."""
    from ipercore_tpu_torch.ops.rasterizer_cuda import (
        prepare_raster,
        prepare_table,
        raster_fim,
        raster_flows,
        raster_flows_table,
    )
    from ipercore_tpu_torch.ops.sampling_cuda import grid_sample_nhwc

    return {"raster_flows_csr": raster_flows, "grid_sample_nhwc": grid_sample_nhwc,
            "raster_fim": raster_fim, "raster_flows_table": raster_flows_table,
            "raster_binning": prepare_raster, "table_binning": prepare_table}


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in counters().items()}


def close_fraction(a, b, tol: float = 1e-3) -> float:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float(((a.float().cpu() - b.float().cpu()).abs() <= tol).float().mean())


def device_breakdown(fn) -> dict:
    """Device milliseconds of one `fn()` by kind of kernel, from torch.profiler."""
    kinds = {"convolutions": 0.0, "kernels": 0.0, "binning_sort_scan": 0.0, "other": 0.0}
    by_name = []
    for us, key in kernel_times(fn):
        by_name.append((us / 1e3, key[:70]))
        name = key.lower()
        # the hand-written kernels: K1/K3's and K4's binning, walk and epilogue, K2
        if HAND_WRITTEN.search(key):
            kinds["kernels"] += us
        elif any(w in name for w in ("conv", "cudnn", "gemm", "xmma", "cutlass", "winograd",
                                     "implicit", "nchwtonhwc", "nhwctonchw", "dgrad",
                                     "fft", "dse::", "pointwise_mult_and_sum_complex")) \
                or ("gemv" in name and "float2" in name):
            # cuDNN's f32 algorithms include FFT convolutions (DSE::*_fft*,
            # pointwise_mult_and_sum_complex, complex (float2) gemv and gemm
            # between the transforms) and dgrad engines for ConvTranspose
            kinds["convolutions"] += us
        elif any(w in name for w in ("sort", "radix", "scan", "searchsorted", "repeat_interleave")):
            kinds["binning_sort_scan"] += us
        else:
            kinds["other"] += us
    out = {k: v / 1e3 for k, v in kinds.items()}
    out["busy"] = sum(out.values())
    check(out["kernels"] > 0 and out["convolutions"] > 0,
          "the profiler recorded no device time for the kernels or the convolutions")
    out["top"] = [{"ms": ms, "kernel": k} for ms, k in sorted(by_name, reverse=True)[:8]]
    return out


def main_path(device) -> tuple[dict, dict]:
    from ipercore_tpu_torch.models import flow_composition as fc
    from ipercore_tpu_torch.models import imitator as imit
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.models.networks import build_generator
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.ops.dispatch import force_plain
    from ipercore_tpu_torch.services.run_imitator import imitate_sequence
    from ipercore_tpu_torch.utils.checkpoint import load_generator_params, seeded_flat_params

    gen = build_generator("AttLWB-SPADE", CFG, device=device)
    load_generator_params(gen, seeded_flat_params(CFG, seed=0))
    n_params = sum(p.numel() for p in gen.parameters())
    src_img, src_smpl = source_inputs(device)
    tgt = target_smpls(N_FRAMES, 1)

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = smpl_mod.template_model(device=device)
    assets = load_assets(model, device=device)
    comp = fc.make_composer(model, assets, image_size=SIZE, out_dilate_ks=51)
    cache = imit.setup_source(comp, gen, src_img, src_smpl)
    smpls = imit.prepare_target_smpls(model, cache, tgt, cam_strategy="smooth")
    frames = imitate_sequence(comp, gen, cache, smpls, chunk=CHUNK, device=device)
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    launches = read_counts()

    check(frames.shape == (N_FRAMES, SIZE, SIZE, 3), f"frames have shape {frames.shape}")
    check(bool(np.isfinite(frames).all()), "frames are not finite")
    check(frames.min() >= -1 - 1e-3 and frames.max() <= 1 + 1e-3, "frames leave [-1, 1]")
    check(float(frames.std()) > 1e-3, "frames are constant")
    check(float(np.abs(frames[0] - frames[-1]).max()) > 1e-3, "frames do not follow the pose")
    check(launches["raster_fim"] >= 2, f"raster_fim launched {launches['raster_fim']} times")
    for k in ("raster_flows_csr", "grid_sample_nhwc"):
        check(launches[k] >= N_FRAMES // CHUNK, f"{k} launched {launches[k]} times")
    check(launches["raster_flows_table"] == launches["table_binning"] == 0,
          "the CSR route launched the table kernel or its binning")
    check(launches["raster_binning"] == launches["raster_flows_csr"] + launches["raster_fim"],
          f"the device binning ran {launches['raster_binning']} times for "
          f"{launches['raster_flows_csr'] + launches['raster_fim']} raster launches")

    # no entry lost on this run's geometry: each chunk's device binning equals
    # the plain one tile by tile and holds every (tile, face) pair that a valid
    # face's padded box touches, counted face by face
    stats = []
    for i in range(0, N_FRAMES, CHUNK):
        d = smpl_mod.get_details(model, torch.as_tensor(smpls[i:i + CHUNK], device=device))
        fv = rz.verts_to_faces(rz.project_verts(d["verts"], d["cam"]), model.faces).contiguous()
        st = binning_check(fv, SIZE, f"main path chunk {i // CHUNK}")
        stats.append(dict(st, tile_loads=tile_loads(rc.prepare_raster(fv, SIZE)),
                          table=table_binning_check(fv, TABLE_K, f"main path chunk {i // CHUNK}")))

    # one chunk again: kernels, then the plain versions forced on the GPU
    batch = torch.as_tensor(smpls[:CHUNK], device=device)
    pred_k, mask_k = imit.synthesize_frames(comp, gen, cache, batch)
    check(float(mask_k.min()) >= 0 and float(mask_k.max()) <= 1, "masks leave [0, 1]")
    with force_plain():
        (pred_p, _), plain_chunk_ms = once_ms(lambda: imit.synthesize_frames(comp, gen, cache, batch))
    close = float(((pred_k - pred_p).abs() <= 1e-3).float().mean())
    check(close >= 0.995, f"kernel run and plain run agree on {close} of values, < 0.995")
    check(float(np.abs(pred_k.cpu().numpy() - frames[:CHUNK]).max()) < 1e-4,
          "a chunk run alone differs from the same chunk inside the sequence")

    # frames per second of the kernel run, after the run above as warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imitate_sequence(comp, gen, cache, smpls, chunk=CHUNK, device=device)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    chunk_ms = cuda_ms(lambda: imit.synthesize_frames(comp, gen, cache, batch), reps=3, warmup=1)
    breakdown = device_breakdown(lambda: imit.synthesize_frames(comp, gen, cache, batch))
    syncs = host_syncs(lambda: imit.synthesize_frames(comp, gen, cache, batch))

    ctx = {"comp": comp, "gen": gen, "cache": cache, "smpls": smpls, "pred_csr": pred_k, "frames": frames,
           "chunk_ms": chunk_ms, "idle_share": 1 - breakdown["busy"] / chunk_ms}
    return ctx, {
        "model": "AttLWB-SPADE", "params": n_params, "size": SIZE, "ns": NS,
        "frames": N_FRAMES, "chunk": CHUNK, "dtype": "float32", "tf32": False,
        "launches": launches, "binning_stats": stats,
        "first_run_s": first_run_s,
        "frames_per_s_sequence_with_host_copy": N_FRAMES / seq_s,
        "frames_per_s_device_chunk": CHUNK / (chunk_ms / 1e3),
        "chunk_ms": chunk_ms, "plain_chunk_ms": plain_chunk_ms,
        "device_ms_per_chunk": breakdown,
        "device_idle_share": 1 - breakdown["busy"] / chunk_ms,
        "host_syncs_per_chunk": syncs,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "kernel_vs_plain_close_fraction": close,
        "frame_min": float(frames.min()), "frame_max": float(frames.max()),
        "frame_std": float(frames.std()),
    }


# ---------------------------------------------------------------------------
# phase 5: the table route (IPERCORE_CSR_RASTER=0), one chunk
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def table_route_env():
    """`IPERCORE_CSR_RASTER=0` inside the block, the previous value after it."""
    prev = os.environ.get("IPERCORE_CSR_RASTER")
    os.environ["IPERCORE_CSR_RASTER"] = "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("IPERCORE_CSR_RASTER")
        else:
            os.environ["IPERCORE_CSR_RASTER"] = prev


def table_route(ctx, device) -> dict:
    from ipercore_tpu_torch.models import imitator as imit
    from ipercore_tpu_torch.ops.dispatch import force_plain

    comp, gen, cache = ctx["comp"], ctx["gen"], ctx["cache"]
    batch = torch.as_tensor(ctx["smpls"][:CHUNK], device=device)
    with table_route_env():
        zero_counts()
        pred_k, _ = imit.synthesize_frames(comp, gen, cache, batch)
        launches = read_counts()
        with force_plain():
            pred_p, _ = imit.synthesize_frames(comp, gen, cache, batch)
        chunk_ms = cuda_ms(lambda: imit.synthesize_frames(comp, gen, cache, batch), reps=3, warmup=1)
        breakdown = device_breakdown(lambda: imit.synthesize_frames(comp, gen, cache, batch))
    check(launches["raster_flows_table"] >= 1 and launches["table_binning"] == launches["raster_flows_table"],
          f"table route: launches {launches}")
    check(launches["raster_flows_csr"] == 0, f"table route launched the CSR kernel: {launches}")
    close = close_fraction(pred_k, pred_p)
    check(close >= 0.995, f"table route: kernel and plain runs agree on {close} of values, < 0.995")
    check(bool(torch.isfinite(pred_k).all()), "table route: frames are not finite")
    return {"launches": launches, "chunk": CHUNK, "chunk_ms": chunk_ms,
            "device_ms_per_chunk": breakdown,
            "device_idle_share": 1 - breakdown["busy"] / chunk_ms,
            "csr_route_chunk_ms": ctx["chunk_ms"], "csr_route_device_idle_share": ctx["idle_share"],
            "kernel_vs_plain_close_fraction": close,
            "close_fraction_vs_csr_route": close_fraction(pred_k, ctx["pred_csr"])}


# ---------------------------------------------------------------------------
# phase 6: temporal mode
# ---------------------------------------------------------------------------

def temporal_phase(ctx, device) -> dict:
    from ipercore_tpu_torch.models.networks import build_generator
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.ops.dispatch import force_plain
    from ipercore_tpu_torch.services.run_imitator import imitate_sequence
    from ipercore_tpu_torch.utils.checkpoint import load_generator_params, seeded_flat_params

    gen = build_generator("AttLWB-SPADE", CFG, temporal=True, device=device)
    load_generator_params(gen, seeded_flat_params(CFG, seed=0))
    comp, cache, smpls = ctx["comp"], ctx["cache"], ctx["smpls"][:CHUNK]
    run = lambda: imitate_sequence(comp, gen, cache, smpls, temporal=True, device=device)

    per_frame_aux = []
    launch = rc.launch_raster_flows
    rc.launch_raster_flows = lambda plan, aux, *a: (per_frame_aux.append(aux.dim() == 5),
                                                    launch(plan, aux, *a))[1]
    try:
        zero_counts()
        frames = run()
        launches = read_counts()
    finally:
        rc.launch_raster_flows = launch
    check(per_frame_aux == [True] and launches["raster_flows_csr"] == 1,
          f"temporal: K1 launches {launches}, per-frame aux {per_frame_aux}")
    check(launches["grid_sample_nhwc"] == 1, f"temporal: launches {launches}")
    check(frames.shape == (CHUNK, SIZE, SIZE, 3) and bool(np.isfinite(frames).all()),
          "temporal: frames are not finite or have the wrong shape")
    check(frames.min() >= -1 - 1e-3 and frames.max() <= 1 + 1e-3, "temporal: frames leave [-1, 1]")
    check(float(np.abs(frames[0] - frames[-1]).max()) > 1e-3, "temporal: frames do not follow the pose")
    with force_plain():
        plain = run()
    close = close_fraction(frames, plain)
    check(close >= 0.995, f"temporal: kernel and plain runs agree on {close} of values, < 0.995")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    seconds = time.perf_counter() - t0
    return {"frames": CHUNK, "launches": launches, "frames_per_s_with_host_copy": CHUNK / seconds,
            "kernel_vs_plain_close_fraction": close,
            "frame_min": float(frames.min()), "frame_max": float(frames.max())}


# ---------------------------------------------------------------------------
# phase 7: the services on a synthetic processed directory
# ---------------------------------------------------------------------------

def write_processed(root: str, name: str, n: int, seed: int, masks: bool = False,
                    background: bool = False) -> None:
    """A processed input as the preprocessing stage leaves it: frames, SMPLs
    (and masks, background) from a seed."""
    from ipercore_tpu_torch.services.meta_info import MetaProcess
    from ipercore_tpu_torch.services.process_info import ProcessInfo
    from ipercore_tpu_torch.utils import video as vid

    rng = np.random.RandomState(seed)
    info = ProcessInfo(MetaProcess(name, root).make_dirs().processed_dir, name=name)
    os.makedirs(os.path.join(info.processed_dir, "images"))
    info.meta["valid_img_names"] = [f"frame_{i:08d}.png" for i in range(n)]
    for f in info.meta["valid_img_names"]:
        vid.save_image(os.path.join(info.processed_dir, "images", f),
                       rng.uniform(-1, 1, (SIZE, SIZE, 3)).astype(np.float32))
    info.set_array("smpls", target_smpls(n, seed))
    if masks:
        yy, xx = np.mgrid[:SIZE, :SIZE]
        ring = ((yy - SIZE / 2) ** 2 + (xx - SIZE / 2) ** 2 > (SIZE / 3) ** 2).astype(np.float32)
        info.set_array("masks", np.repeat(ring[None], n, axis=0))
    if background:
        vid.save_image(os.path.join(info.processed_dir, "background.png"),
                       rng.uniform(-1, 1, (SIZE, SIZE, 3)).astype(np.float32))
    info.serialize()


def services_phase(device) -> dict:
    from ipercore_tpu_torch.models import imitator as imit
    from ipercore_tpu_torch.models.mesh import part_face_mask
    from ipercore_tpu_torch.services import options
    from ipercore_tpu_torch.services import run_imitator as ri
    from ipercore_tpu_torch.services.meta_info import parse_src_input
    from ipercore_tpu_torch.services.process_info import ProcessInfo
    from ipercore_tpu_torch.services.run_swapper import swap
    from ipercore_tpu_torch.services.run_viewer import novel_view
    from ipercore_tpu_torch.utils import video as vid
    from ipercore_tpu_torch.utils.smoothing import (
        _butter_lowpass_sos,
        lowpass_filtfilt,
        temporal_smooth_smpls,
    )

    def to_u8(frames):
        return np.clip((np.asarray(frames) + 1.0) * 127.5, 0, 255).astype(np.uint8).astype(np.int32)

    def written(root, synthesis):
        d = os.path.join(root, "primitives", synthesis, "synthesis")
        names = sorted(f for f in os.listdir(d) if f.startswith("pred_"))
        return np.stack([vid.read_png(os.path.join(d, f)) for f in names]).astype(np.int32)

    out = {}
    with tempfile.TemporaryDirectory() as root:
        n_ref = 2 * CHUNK  # longer than the low-pass filter's 9-frame padding
        write_processed(root, "alice", NS, 11, masks=True, background=True)
        write_processed(root, "bob", 1, 12)
        write_processed(root, "dance", n_ref, 13)
        opt = options.setup(None, [])
        opt.update(image_size=SIZE, num_source=NS, output_dir=root, model_id="smoke",
                   Generator=CFG, view_frames=CHUNK, src_path="path?=alice,name?=alice",
                   ref_path="path?=dance,name?=dance")
        # the in-memory frames each service must have written, through the
        # library entry points on one runtime
        model, comp, gen = ri.build_runtime(opt, device)
        alice = parse_src_input(opt.src_path)[0]
        cache, src, offsets, links = ri.load_source_cache(opt, comp, gen, alice)
        ref_smpls = ProcessInfo.deserialize(os.path.join(
            root, "primitives", "dance", "processed")).read_ref_info()["smpls"]
        from scipy.signal import sosfiltfilt

        pose = ref_smpls[:, 3:75]
        check(np.array_equal(lowpass_filtfilt(pose, 300.0),
                             sosfiltfilt(_butter_lowpass_sos(300.0, 2208.0), pose, axis=0)
                             .astype(pose.dtype)),
              "services: the reference's smoothing did not take the Butterworth filter")
        ref_smpls = temporal_smooth_smpls(ref_smpls)
        want = {"imitate": ri.imitate_sequence(
            comp, gen, cache, imit.prepare_target_smpls(model, cache, ref_smpls),
            offsets=offsets, links_ids=links, device=device)}
        ring = imit.make_novel_view_smpls(torch.as_tensor(src["smpls"][0]), n_frames=CHUNK).numpy()
        with table_route_env():
            want["novel_view"] = ri.imitate_sequence(
                comp, gen, cache, imit.prepare_target_smpls(model, cache, ring),
                offsets=offsets, links_ids=links, device=device)
        bob_cache = ri.load_source_cache(opt, comp, gen, parse_src_input("path?=bob,name?=bob")[0])[0]
        upper = part_face_mask(comp.assets, ["upper"])
        merged = imit.merge_source_caches(comp, [cache, bob_cache], [~upper, upper])
        want["swap"] = ri.imitate_sequence(comp, gen, merged,
                                           imit.prepare_target_smpls(model, merged, ref_smpls),
                                           device=device)
        del gen, cache, bob_cache, merged

        # the viewer runs on the table route, so that K4 runs through a service
        runs = (("imitate", ri.imitate, False, "alice-dance", n_ref, -1),
                ("novel_view", novel_view, True, "alice-novel_view", CHUNK, CHUNK // 2),
                ("swap", swap, False, "alice+bob-dance-swap", n_ref, -1))
        for name, fn, table, synthesis, n_frames, other in runs:
            if name == "swap":
                opt.src_path = "path?=alice,name?=alice|path?=bob,name?=bob,parts?=upper"
            with table_route_env() if table else contextlib.nullcontext():
                zero_counts()
                t0 = time.perf_counter()
                fn(opt, device=device)
                seconds = time.perf_counter() - t0
                launches = read_counts()
            frames = written(root, synthesis)
            check(frames.shape == (n_frames, SIZE, SIZE, 3),
                  f"{name}: wrote {frames.shape[0]} frames of {frames.shape[1:]}, want {n_frames}")
            lsb = int(np.abs(frames - to_u8(want[name])).max())
            check(lsb <= 1, f"{name}: written frames differ from the in-memory frames by {lsb} LSB")
            check(int(np.abs(frames[0] - frames[other]).max()) > 2, f"{name}: the frames do not change")
            check(launches["raster_flows_table" if table else "raster_flows_csr"] >= 1
                  and launches["raster_flows_csr" if table else "raster_flows_table"] == 0
                  and launches["grid_sample_nhwc"] >= 1 and launches["raster_fim"] >= 2,
                  f"{name}: launches {launches}")
            out[name] = {"wall_s": seconds, "frames": n_frames, "max_lsb_vs_in_memory": lsb,
                         "launches": launches}
        out.update(personalize_service(opt, root, device, seeded=written(root, "alice-dance")))
    return out


def personalize_service(opt, root: str, device, seeded) -> dict:
    """`personalize` on the subject of the services' directory, then `imitate`
    with the personalized weights (its frames must differ from `seeded`, the
    frames of the seeded weights), then `personalize` again (a skip)."""
    from ipercore_tpu_torch.services import run_imitator as ri
    from ipercore_tpu_torch.services.personalization import personalize, personalized_path
    from ipercore_tpu_torch.utils import video as vid

    opt.src_path = "path?=alice,name?=alice"
    opt.Train.update(niters_or_epochs_no_decay=SERVICE_ITERS, niters_or_epochs_decay=0)
    others = ("raster_flows_csr", "grid_sample_nhwc", "raster_flows_table", "table_binning")
    out = {}
    zero_counts()
    t0 = time.perf_counter()
    path = personalize(opt, device=device)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check(path == personalized_path(opt) and os.path.exists(path), f"personalize: nothing at {path}")
    # the UV template once, then the sources and the target of every step
    check(launches["raster_fim"] == 1 + 2 * SERVICE_ITERS == launches["raster_binning"]
          and not any(launches[k] for k in others), f"personalize: launches {launches}")
    out["personalize"] = {"wall_s": seconds, "iterations": SERVICE_ITERS, "launches": launches}

    zero_counts()
    t0 = time.perf_counter()
    ri.imitate(opt, device=device)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    d = os.path.join(root, "primitives", "alice-dance", "synthesis")
    frames = np.stack([vid.read_png(os.path.join(d, f)) for f in sorted(os.listdir(d))
                       if f.startswith("pred_")]).astype(np.int32)
    check(frames.shape == seeded.shape, f"imitate after personalize: frames {frames.shape} vs {seeded.shape}")
    lsb = int(np.abs(frames - seeded).max())
    # more than the 1 LSB by which two runs of the same weights may differ
    check(lsb > 1, "imitate after personalize: the frames equal the seeded weights' frames")
    check(launches["raster_flows_csr"] >= 1 and launches["grid_sample_nhwc"] >= 1 and launches["raster_fim"] >= 2,
          f"imitate after personalize: launches {launches}")
    out["imitate_personalized"] = {"wall_s": seconds, "frames": int(frames.shape[0]),
                                   "max_lsb_vs_seeded_weights": lsb, "launches": launches}

    stamp = os.stat(path).st_mtime_ns
    zero_counts()
    t0 = time.perf_counter()
    again = personalize(opt, device=device)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check(again == path and os.stat(path).st_mtime_ns == stamp and not any(launches.values()),
          f"a second personalize did not skip: launches {launches}")
    out["personalize_again"] = {"wall_s": seconds, "skipped": True}
    return out


# ---------------------------------------------------------------------------
# phase 8: the personalization train step at full width
# ---------------------------------------------------------------------------

def train_batch(device) -> dict:
    """One personalization batch of the step's shapes: NS sources then NT
    targets, SMPLs posed like the main path's targets, ring masks
    (background = 1), a pseudo-background."""
    rng = np.random.RandomState(5)
    n = NS + NT
    yy, xx = np.mgrid[:SIZE, :SIZE]
    ring = ((yy - SIZE / 2) ** 2 + (xx - SIZE / 2) ** 2 > (SIZE / 3) ** 2).astype(np.float32)
    batch = {"images": rng.uniform(-1, 1, (1, n, SIZE, SIZE, 3)).astype(np.float32),
             "smpls": target_smpls(n, 5)[None],
             "masks": np.broadcast_to(ring[None, None, :, :, None], (1, n, SIZE, SIZE, 1)).copy(),
             "bg": rng.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)}
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def state_agreement(a, b, lr: float, what: str) -> dict:
    """Two train states after one step from the same state: the clipped
    gradients (first moment over 1 - b1) within 1 % (L2, relative) with 99 %
    of the elements within 1e-3 of the largest; every parameter within 2 * lr
    (Adam's first step moves a weight by about lr * sign(g), so a gradient
    near 0 may flip it) and 97 % within 1e-6."""
    out = {}
    for net, pa, pb, oa, ob in (("G", a.params_G, b.params_G, a.opt_G, b.opt_G),
                                ("D", a.params_D, b.params_D, a.opt_D, b.opt_D)):
        ga = torch.cat([oa.mu[k].reshape(-1) for k in oa.mu]) * 2
        gb = torch.cat([ob.mu[k].reshape(-1) for k in oa.mu]) * 2
        dp = torch.cat([(pa[k] - pb[k]).reshape(-1) for k in pa]).abs()
        dg = (ga - gb).abs()
        row = {"grad_l2_rel": float((ga - gb).norm() / gb.norm()),
               "grad_within_1e-3_of_max": float((dg <= 1e-3 * gb.abs().max()).double().mean()),
               "param_max_abs_diff": float(dp.max()),
               "param_within_1e-6": float((dp <= 1e-6).double().mean())}
        check(row["grad_l2_rel"] <= 1e-2 and row["grad_within_1e-3_of_max"] >= 0.99
              and row["param_max_abs_diff"] <= 2 * lr * 1.001 and row["param_within_1e-6"] >= 0.97,
              f"{what}: {net} {row}")
        out[net] = row
    return out


def train_rig(comp, batch, device, gen_name: str = "AttLWB-SPADE"):
    """The personalization step's networks at full width with seeded weights
    (G `gen_name` seed 0, D 1, VGG19 2, Sphere20a 3): (initial state, step
    function state -> (state, metrics) on `batch`, face crop size, (G, D,
    VGG, face))."""
    from ipercore_tpu_torch.models.networks import build_discriminator, build_generator
    from ipercore_tpu_torch.models.networks import criterions as C
    from ipercore_tpu_torch.trainers import lwg_trainer as T
    from ipercore_tpu_torch.utils.checkpoint import load_generator_params, seeded_flat_params

    gen = build_generator(gen_name, CFG, num_source=NS, device=device)
    load_generator_params(gen, seeded_flat_params(gen, 0))
    dis = build_discriminator("patch_global", DIS_CFG, device=device)
    load_generator_params(dis, seeded_flat_params(dis, 1))
    vgg = C.build_vgg(device=device)
    load_generator_params(vgg, seeded_flat_params(vgg, 2))
    face, hw = C.build_face_net("sphere20a", device=device)
    load_generator_params(face, seeded_flat_params(face, 3))
    cfg = T.TrainConfig()
    step = lambda st: T.train_step(st, batch, comp, gen, dis, vgg, face, cfg, ns=NS)
    return T.create_train_state(gen, dis, cfg), step, hw, (gen, dis, vgg, face)


def train_phase(device) -> dict:
    from ipercore_tpu_torch.models import flow_composition as fc
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.ops.dispatch import force_plain
    from ipercore_tpu_torch.trainers import lwg_trainer as T

    model = smpl_mod.template_model(device=device)
    comp = fc.make_composer(model, load_assets(model, device=device), image_size=SIZE, out_dilate_ks=51)
    batch = train_batch(device)

    # K3 on the step's batches: its sources and its targets
    k3 = {}
    for name, theta in (("sources", batch["smpls"][0, :NS]), ("targets", batch["smpls"][0, NS:])):
        d = smpl_mod.get_details(model, theta)
        fv = rz.verts_to_faces(rz.project_verts(d["verts"], d["cam"]), model.faces).contiguous()
        out, ref = rc.raster_fim(fv, SIZE), rc.raster_fim_plain(fv, SIZE)
        raster_agreement(out.fim, ref.fim, out.wim, ref.wim, f"raster_fim/train {name}", bit_equal=True)
        check_no_host_sync(lambda: rc.raster_fim(fv, SIZE), f"raster_fim/train {name}")
        k3[name] = {"N": int(fv.shape[0]), "bit_equal": True,
                    "wrapper_ms": cuda_ms(lambda: rc.raster_fim(fv, SIZE))}

    # networks at full width, then one step: the first step's cost
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state0, step, hw, _ = train_rig(comp, batch, device)
    cfg = T.TrainConfig()
    zero_counts()
    state1, metrics1 = step(state0)
    torch.cuda.synchronize()
    first_step_s = time.perf_counter() - t0
    launches = read_counts()
    check(launches["raster_fim"] == 2 == launches["raster_binning"]
          and not any(launches[k] for k in ("raster_flows_csr", "grid_sample_nhwc", "raster_flows_table")),
          f"train step: launches {launches}")

    # the kernel step against the plain step from the same state (cuDNN
    # deterministic for this comparison only; grid_sample's backward adds with
    # atomics either way)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sk, mk = step(state0)
        with force_plain():
            sp, mp = step(state0)
    finally:
        torch.backends.cudnn.deterministic = prev
    loss_rel = {k: abs(float(mk[k]) - float(mp[k])) / max(abs(float(mp[k])), 1e-6) for k in mk}
    check(max(loss_rel.values()) <= 1e-4, f"train step: kernel and plain losses differ {loss_rel}")
    agreement = state_agreement(sk, sp, cfg.lr_g, "train step kernel vs plain")
    del sk, sp

    # steady state: CUDA events over TRAIN_STEPS steps after TRAIN_WARMUP
    holder = [state1]

    def one():
        holder[0], m = step(holder[0])
        return m

    for _ in range(TRAIN_WARMUP):
        one()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TRAIN_STEPS):
        metrics = one()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    two = device_breakdown(lambda: (one(), one()))
    per_step = {k: v / 2 for k, v in two.items() if k != "top"}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    one()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k3_per_step = read_counts()["raster_fim"]
    syncs = host_syncs(one)
    losses = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in losses.values()), f"train step: losses not finite {losses}")
    moved = max(float((holder[0].params_G[k] - state0.params_G[k]).abs().max()) for k in state0.params_G)
    moved_d = max(float((holder[0].params_D[k] - state0.params_D[k]).abs().max()) for k in state0.params_D)
    check(moved > 0 and moved_d > 0, "train step: the parameters did not move")
    check(int(holder[0].opt_G.count) == int(holder[0].step) == TRAIN_WARMUP + TRAIN_STEPS + 5,
          "train step: a step was skipped as non-finite")
    return {
        "model": "AttLWB-SPADE", "params_G": sum(v.numel() for v in state0.params_G.values()),
        "params_D": sum(v.numel() for v in state0.params_D.values()), "discriminator": "patch_global",
        "size": SIZE, "ns": NS, "nt": NT, "bs": 1, "dtype": "float32", "tf32": False,
        "face_hw": list(hw), "k3_training": k3, "launches_first_step": launches,
        "first_step_s": first_step_s, "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
        "timed_steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP,
        "device_ms_per_step": per_step, "device_top_kernels_two_steps": two["top"],
        "device_busy_share": per_step["busy"] / step_ms,
        "device_idle_share": 1 - per_step["busy"] / step_ms,
        "peak_memory_gib": peak, "host_syncs_per_step": syncs, "k3_launches_per_step": k3_per_step,
        "kernel_vs_plain_loss_rel_diff": loss_rel, "kernel_vs_plain_state": agreement,
        "losses_last_step": losses, "first_step_losses": {k: float(v) for k, v in metrics1.items()},
        "param_max_move": moved,
    }


# ---------------------------------------------------------------------------
# phase 9: the train service (services/train.py) at full width
# ---------------------------------------------------------------------------

def png_paeth(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG whose every row is stored with the Paeth filter (as
    other writers store photos), encoded in numpy: the encoder knows every
    pixel, so the predictor is vectorised."""
    import struct
    import zlib

    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(raw)
    a[:, c:] = raw[:, :-c]
    b = np.zeros_like(raw)
    b[1:] = raw[:-1]
    cc = np.zeros_like(raw)
    cc[1:, c:] = raw[:-1, :-c]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    rows = ((raw - pred) & 0xFF).astype(np.uint8)
    data = np.concatenate([np.full((h, 1), 4, np.uint8), rows], axis=1).tobytes()

    def chunk(tag, payload):
        body = tag + payload
        return struct.pack(">I", len(payload)) + body + struct.pack(">I", zlib.crc32(body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(data, 6)) + chunk(b"IEND", b""))


def decode_times(root: str) -> dict:
    """`read_png` of one 512² RGB image stored unfiltered (the port's writer)
    and stored with Paeth rows; both must decode to the image."""
    from ipercore_tpu_torch.utils import video as vid

    img = np.random.RandomState(9).randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
    plain, paeth = os.path.join(root, "plain.png"), os.path.join(root, "paeth.png")
    vid.write_png(plain, img)
    with open(paeth, "wb") as f:
        f.write(png_paeth(img))
    out = {}
    for name, path in (("unfiltered", plain), ("paeth", paeth)):
        t0 = time.perf_counter()
        got = vid.read_png(path)
        out[name] = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(got, img), f"train service: the {name} PNG does not decode to its image")
    return out


class FakeClock:
    """The train loop's wall clock, advanced one second an iteration, so that
    its time-based cadences fire at chosen iterations."""

    def __init__(self):
        self.now = 0.0

    def time(self) -> float:
        return self.now


TRAIN_SERVICE_ITERS = 8
TRAIN_SERVICE_CADENCE_S = 4.5  # display and mid-run save at index 4 (clock 5 > 4.5)


def train_service_phase(device) -> dict:
    """`services/train.train` in a 1-rank NCCL group at full width, then again
    to resume. The loop is measured from the outside: the step, the eval, the
    prefetch queue, the checkpoint writer and loader are wrapped, and the
    loop's clock is a `FakeClock`."""
    import torch.distributed as dist

    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.ops.dispatch import force_plain
    from ipercore_tpu_torch.parallel import mesh
    from ipercore_tpu_torch.services import options
    from ipercore_tpu_torch.services import train as svc
    from ipercore_tpu_torch.trainers import lwg_trainer as T
    from ipercore_tpu_torch.utils import checkpoint as ckpt
    from ipercore_tpu_torch.utils import video as vid

    n_iters = TRAIN_SERVICE_ITERS
    rec = {"t": [], "step": [], "wait": [], "eval": [], "save": [], "load": [], "batches": [], "saved": {}}
    clock = FakeClock()
    window = {"from": 5, "syncs": 0, "k3": 0}
    caught: list = []

    def snapshot(state):
        cpu = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}
        return {"G": cpu(state.params_G), "D": cpu(state.params_D),
                "opt_G": state.opt_G._replace(mu=cpu(state.opt_G.mu), nu=cpu(state.opt_G.nu)),
                "opt_D": state.opt_D._replace(mu=cpu(state.opt_D.mu), nu=cpu(state.opt_D.nu))}

    real_make, real_eval = T.make_sharded_train_step, T.eval_step
    real_prefetch, real_save, real_load, real_time = svc.prefetch, svc.save_train_ckpt, svc.load_train_ckpt, svc.time

    def make(comp, gen, dis, vgg, face, cfg, ns=2):
        rec["rig"] = (comp, gen, dis, vgg, face, cfg, ns)
        step = real_make(comp, gen, dis, vgg, face, cfg, ns=ns)

        def timed_step(state, batch):
            i = len(rec["t"])
            rec["t"].append(time.perf_counter())
            if "state0" not in rec:
                rec["state0"] = {"G": {k: v.clone() for k, v in state.params_G.items()}}
            if i == window["from"]:
                window["k3_before"] = read_counts()["raster_fim"]
                torch.cuda.set_sync_debug_mode("warn")
                window["mark"] = len(caught)
            elif i == window["from"] + 1:
                torch.cuda.set_sync_debug_mode("default")
                window["syncs"] = sum("synchroniz" in str(w.message).lower() for w in caught[window["mark"]:])
                window["k3"] = read_counts()["raster_fim"] - window["k3_before"]
            rec["batches"].append(batch)
            clock.now += 1.0
            if i == window["from"]:
                return step(state, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            rec["step"].append((time.perf_counter() - t0) * 1e3)
            return out

        return timed_step

    def counting() -> bool:
        return window["from"] <= len(rec["t"]) - 1 < window["from"] + 1

    def timed_eval(*a, **k):
        if counting():
            return real_eval(*a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_eval(*a, **k)
        torch.cuda.synchronize()
        rec["eval"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_prefetch(it, depth=2):
        src = real_prefetch(it, depth)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(src)
            except StopIteration:
                return
            rec["wait"].append((time.perf_counter() - t0) * 1e3)
            yield item

    def timed_save(ckpt_dir, step, state, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(ckpt_dir, step, state, *a, **k)
        rec["save"].append(time.perf_counter() - t0)
        rec["saved"][step] = snapshot(state)

    def timed_load(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = real_load(*a, **k)
        torch.cuda.synchronize()
        rec["load"].append((time.perf_counter() - t0, a[1], state))
        return state

    env_keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
    env_before = {k: os.environ.get(k) for k in env_keys}
    out = {}
    with tempfile.TemporaryDirectory() as root:
        out["decode_ms"] = decode_times(root)
        data = os.path.join(root, "data")
        for i, name in enumerate(("v0", "v1")):
            write_processed(data, name, 6, 21 + i, masks=True, background=True)
        with open(os.path.join(data, "train.txt"), "w") as f:
            f.write("v0\nv1\n")
        opt = options.setup(None, [])
        opt.update(image_size=SIZE, num_source=NS, time_step=NT, batch_size=1, Generator=CFG,
                   output_dir=os.path.join(root, "out"), model_id="train", dataset_dirs=[data])
        opt.Discriminator.update(DIS_CFG)
        opt.Train.update(print_freq_s=0.0, display_freq_s=TRAIN_SERVICE_CADENCE_S,
                         save_latest_freq_s=TRAIN_SERVICE_CADENCE_S)
        ckpt_dir = os.path.join(opt.output_dir, "models", "train")
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        try:
            dev = mesh.init_data_parallel(device, init_method="file://" + os.path.join(root, "store"))
            check(dist.is_initialized() and dist.get_backend() == "nccl" and mesh.world_size() == 1,
                  "train service: no 1-rank NCCL group")
            T.make_sharded_train_step, T.eval_step = make, timed_eval
            svc.prefetch, svc.save_train_ckpt, svc.load_train_ckpt, svc.time = (
                timed_prefetch, timed_save, timed_load, clock)
            reduces0 = mesh.all_reduce_mean.calls
            with warnings.catch_warnings(record=True) as caught_now:
                warnings.simplefilter("always")
                caught = caught_now
                zero_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                metrics = svc.train(opt, max_iters=n_iters, device=dev)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                launches = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            reduces = mesh.all_reduce_mean.calls - reduces0
            first = {k: rec[k][:] for k in ("t", "step", "wait", "eval", "save")}
            comp, gen, dis, vgg, face, cfg, ns = rec["rig"]
            batches = rec["batches"][:]

            # resume: a second call restores the final save and runs 2 more
            rec.update(t=[], wait=[], batches=[], load=[])
            clock.now = 0.0
            window["from"] = -10
            zero_counts()
            t0 = time.perf_counter()
            svc.train(opt, max_iters=n_iters + 2, device=dev)
            torch.cuda.synchronize()
            resume_run_s = time.perf_counter() - t0
            resume_launches = read_counts()
            resume_reduces = mesh.all_reduce_mean.calls - reduces0 - reduces
        finally:
            T.make_sharded_train_step, T.eval_step = real_make, real_eval
            svc.prefetch, svc.save_train_ckpt, svc.load_train_ckpt, svc.time = (
                real_prefetch, real_save, real_load, real_time)
            torch.cuda.set_sync_debug_mode("default")
            if dist.is_initialized():
                dist.destroy_process_group()
            for k, v in env_before.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

        # what the first run did and wrote
        losses = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in losses.values()), f"train service: losses not finite {losses}")
        final = rec["saved"][n_iters]
        moved = max(float((final["G"][k] - rec["state0"]["G"][k].cpu()).abs().max()) for k in final["G"])
        check(moved > 0, "train service: the parameters did not move")
        for step in (TRAIN_SERVICE_ITERS // 2, n_iters):
            missing = [p for p in ckpt.train_ckpt_paths(ckpt_dir, step).values() if not os.path.exists(p)]
            check(not missing, f"train service: checkpoint files missing {missing}")
        check(sorted(rec["saved"]) == [TRAIN_SERVICE_ITERS // 2, n_iters, n_iters + 2],
              f"train service: saved at {sorted(rec['saved'])}")
        with open(os.path.join(ckpt_dir, "train_log.jsonl")) as f:
            rows = [json.loads(l) for l in f]
        check(len(rows) == n_iters + 2 and all(k in rows[0] for k in ("g_total", "d_total", "val_g_total",
                                                                        "val_g_tsf")),
              f"train service: log rows {len(rows)}, keys {sorted(rows[0]) if rows else []}")
        panels = sorted(os.listdir(os.path.join(ckpt_dir, "panels")))
        check(len(panels) == 1, f"train service: panels {panels}")
        panel = vid.read_png(os.path.join(ckpt_dir, "panels", panels[0]))
        check(panel.shape == (4 * SIZE, SIZE, 3), f"train service: panel {panel.shape}")
        per_iter = 2 + 2  # the train step's sources and target, then the eval's
        want_k3 = 1 + per_iter * n_iters + 2  # + the composer, + the panel's eval
        check(launches["raster_fim"] == want_k3 == launches["raster_binning"]
              and not any(launches[k] for k in ("raster_flows_csr", "grid_sample_nhwc", "raster_flows_table")),
              f"train service: launches {launches}, want {want_k3} of raster_fim")
        check(window["k3"] == per_iter, f"train service: {window['k3']} K3 launches in one iteration")
        check(reduces == 2 * n_iters and resume_reduces == 2 * 2,
              f"train service: {reduces} / {resume_reduces} all-reduces, want 2 a step")

        # the resumed run: starts at n_iters with exactly the state saved there
        (load_s, step, loaded), = rec["load"]
        check(step == n_iters and int(loaded.step) == n_iters and len(rec["t"]) == 2,
              f"train service: resumed at {step}, ran {len(rec['t'])} iterations")
        got = snapshot(loaded)
        for net, module in (("G", gen), ("D", dis)):
            check(all(torch.equal(got[net][k], final[net][k]) for k in final[net]),
                  f"train service: resumed {net} parameters differ from the saved ones")
            check(all(np.array_equal(a, b) for a, b in zip(
                ckpt.adam_state_to_leaves(module, got[f"opt_{net}"], False),
                ckpt.adam_state_to_leaves(module, final[f"opt_{net}"], False))),
                f"train service: resumed {net} Adam state differs from the saved one")

        # K3 on the service's batches, and the eval with kernels against plain
        model = comp.model
        tile_max = 0
        for b in batches:
            for what, theta in (("sources", b["smpls"][0, :ns]), ("targets", b["smpls"][0, ns:])):
                d = smpl_mod.get_details(model, theta)
                fv = rz.verts_to_faces(rz.project_verts(d["verts"], d["cam"]), model.faces).contiguous()
                if what == "targets":
                    tile_max = max(tile_max, rc.bin_faces_table(fv, SIZE, TABLE_K, with_stats=True)
                                   .stats["max_tile_load"])
                if b is batches[0]:
                    o, ref = rc.raster_fim(fv, SIZE), rc.raster_fim_plain(fv, SIZE)
                    raster_agreement(o.fim, ref.fim, o.wim, ref.wim, f"raster_fim/train service {what}",
                                     bit_equal=True)
        last = T.LWGTrainState(params_G={k: v.to(dev) for k, v in final["G"].items()},
                               params_D={k: v.to(dev) for k, v in final["D"].items()},
                               opt_G=None, opt_D=None, step=torch.zeros((), dtype=torch.int32, device=dev))
        vb = batches[-1]
        mk = T.eval_step(last, vb, comp, gen, dis, vgg, face, cfg, ns=ns)
        with force_plain():
            mp = T.eval_step(last, vb, comp, gen, dis, vgg, face, cfg, ns=ns)
        eval_rel = {k: abs(float(mk[k]) - float(mp[k])) / max(abs(float(mp[k])), 1e-6) for k in mk}
        check(max(eval_rel.values()) <= 1e-4, f"train service: eval with kernels vs plain {eval_rel}")

    iters = np.diff(np.asarray(first["t"])) * 1e3
    steady = iters[2:] if len(iters) > 2 else iters
    iter_ms = float(np.median(steady))
    out.update({
        "iterations": n_iters, "resumed_iterations": 2, "world_size": 1, "backend": "nccl",
        "model": "AttLWB-SPADE", "discriminator": "patch_global", "losses": "VGG19 + Sphere20a",
        "size": SIZE, "ns": NS, "nt": NT, "bs": 1, "dtype": "float32", "tf32": False,
        "iter_ms": iter_ms, "iters_per_s": 1e3 / iter_ms, "iter_ms_all": iters.tolist(),
        # the data-parallel step alone (synchronised around it; not in the
        # sync-count iteration), and what the iteration spends besides it and the eval
        "step_ms": float(np.median(first["step"][2:])), "step_ms_all": first["step"],
        "iter_other_ms": iter_ms - float(np.median(first["step"][2:])) - float(np.median(first["eval"])),
        "data_wait_ms": float(np.mean(first["wait"][2:])), "data_wait_ms_all": first["wait"],
        "eval_ms": float(np.median(first["eval"])), "eval_ms_all": first["eval"],
        "checkpoint_write_s": first["save"], "resume_s": load_s, "first_call_s": first_s,
        "resume_call_s": resume_run_s, "peak_memory_gib": peak,
        "host_syncs_per_iter": window["syncs"], "k3_launches_per_iter": window["k3"],
        "k3_launches_first_call": launches["raster_fim"], "k3_launches_resume_call": resume_launches["raster_fim"],
        "nccl_all_reduces": reduces, "nccl_all_reduces_per_step": reduces / n_iters,
        "k3_max_tile_faces_8x128_targets": tile_max, "k3_jax_tile_cap": TABLE_K,
        "k3_bit_equal_on_service_batch": True, "eval_kernel_vs_plain_rel_diff": eval_rel,
        "resume_bit_equal": True, "losses_last_step": losses, "param_max_move": moved,
    })
    return out

# ---------------------------------------------------------------------------
# phase 10: the rest of the generator zoo, its two trainers
# ---------------------------------------------------------------------------

ZOO_LWB = ("AttLWB-AdaIN", "AddLWB", "AvgLWB", "SoftGateAddLWB", "SoftGateAvgLWB", "AttLWB-Front")
ZOO_BASELINES = ("InputConcat", "TextureWarping")
ZOO_TRAINERS = ("LWGFrontTrainer", "BaselineTrainer")
ZOO_WARMUP, ZOO_STEPS = 2, 5


def zoo_geometry_checks(comp, cache, batch) -> dict:
    """K1 and K2 on a zoo chunk's inputs and K3 on its sources, each bit-equal
    to its plain version."""
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.ops import sampling_cuda as sc

    model = comp.model

    def faces_of(theta):
        d = smpl_mod.get_details(model, theta)
        return rz.verts_to_faces(rz.project_verts(d["verts"], d["cam"]), model.faces).contiguous()

    fv = faces_of(batch)
    aux = torch.cat([comp.assets.f2uvs[None], cache.src_f2pts], dim=0).contiguous()
    fim, flows = rc.raster_flows(fv, aux, SIZE)
    fim_p, flows_p = rc.raster_flows_plain(fv, aux, SIZE)
    raster_agreement(fim, fim_p, flows, flows_p, "raster_flows/zoo chunk", bit_equal=True)
    imgs = cache.uv_img.expand((fv.shape[0],) + tuple(cache.uv_img.shape[1:]))
    grid = flows[..., 0, :]
    out, ref = sc.grid_sample_nhwc(imgs, grid), sc.grid_sample_plain(imgs, grid)
    check(torch.equal(out, ref), "grid_sample_nhwc/zoo chunk: not bit-equal to the plain version")
    _, src_smpl = source_inputs(batch.device)
    src_fv = faces_of(src_smpl[0])
    o, r = rc.raster_fim(src_fv, SIZE), rc.raster_fim_plain(src_fv, SIZE)
    raster_agreement(o.fim, r.fim, o.wim, r.wim, "raster_fim/zoo sources", bit_equal=True)
    return {"raster_flows_csr": True, "grid_sample_nhwc": True, "raster_fim": True}


def zoo_generators(comp, device) -> dict:
    """Each other LWB generator at full width with seeded weights: setup, one
    chunk of CHUNK frames with kernels against the plain versions, `chunk_ms`
    by events after a warm-up."""
    from ipercore_tpu_torch.models import imitator as imit
    from ipercore_tpu_torch.models.networks import build_generator
    from ipercore_tpu_torch.ops.dispatch import force_plain
    from ipercore_tpu_torch.utils.checkpoint import load_generator_params, seeded_flat_params

    src_img, src_smpl = source_inputs(device)
    bg = torch.as_tensor(np.random.RandomState(7).uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32),
                         device=device)
    out, bit_equal = {}, None
    for name in ZOO_LWB:
        gen = build_generator(name, CFG, device=device)
        load_generator_params(gen, seeded_flat_params(gen, 0))
        given_bg = bg if name == "AttLWB-Front" else None  # no BGNet: the background is given
        zero_counts()
        cache = imit.setup_source(comp, gen, src_img, src_smpl, bg_img=given_bg)
        setup = read_counts()
        smpls = imit.prepare_target_smpls(comp.model, cache, target_smpls(CHUNK, 1), cam_strategy="smooth")
        batch = torch.as_tensor(smpls, device=device)
        zero_counts()
        pred_k, mask_k = imit.synthesize_frames(comp, gen, cache, batch)
        chunk = read_counts()
        with force_plain():
            pred_p, _ = imit.synthesize_frames(comp, gen, cache, batch)
        close = close_fraction(pred_k, pred_p)
        check(close >= 0.995, f"zoo {name}: kernel and plain runs agree on {close} of values, < 0.995")
        check(bool(torch.isfinite(pred_k).all()) and float(pred_k.std()) > 1e-3,
              f"zoo {name}: frames not finite or constant")
        check(float(pred_k.min()) >= -1 - 1e-3 and float(pred_k.max()) <= 1 + 1e-3, f"zoo {name}: frames leave [-1, 1]")
        check(setup["raster_fim"] >= 1 and chunk["raster_flows_csr"] == 1 and chunk["grid_sample_nhwc"] == 1
              and chunk["raster_fim"] == 0, f"zoo {name}: launches setup {setup}, chunk {chunk}")
        if bit_equal is None:
            bit_equal = zoo_geometry_checks(comp, cache, batch)
        chunk_ms = cuda_ms(lambda: imit.synthesize_frames(comp, gen, cache, batch), reps=3, warmup=1)
        out[name] = {"params": sum(p.numel() for p in gen.parameters()), "chunk": CHUNK, "chunk_ms": chunk_ms,
                     "frames_per_s_device_chunk": CHUNK / (chunk_ms / 1e3),
                     "launches_setup": setup, "launches_chunk": chunk, "kernel_vs_plain_close_fraction": close,
                     "background": "given" if given_bg is not None else "BGNet"}
        del gen, cache, pred_k, pred_p
    return {"generators": out, "bit_equal_on_zoo_chunk": bit_equal}


def zoo_baselines(device) -> dict:
    """The baselines' training forward at full width (they have no
    `forward_tsf`), timed by events."""
    from ipercore_tpu_torch.models.networks import build_generator
    from ipercore_tpu_torch.utils.checkpoint import load_generator_params, seeded_flat_params

    rng = np.random.RandomState(9)
    u = lambda *s: torch.as_tensor(rng.uniform(-1, 1, s).astype(np.float32), device=device)
    ins = (u(1, 1, SIZE, SIZE, 4), u(1, NS, SIZE, SIZE, 6), u(1, 2, SIZE, SIZE, 6), u(1, 2, NS, SIZE, SIZE, 2))
    out = {}
    for name in ZOO_BASELINES:
        gen = build_generator(name, CFG, num_source=NS, device=device)
        load_generator_params(gen, seeded_flat_params(gen, 0))
        with torch.no_grad():
            zero_counts()
            bg, imgs, masks = gen(*ins, only_tsf=False)
            launches = read_counts()
            check(imgs.shape == (1, 2, SIZE, SIZE, 3) and masks.shape == (1, 2, SIZE, SIZE, 1)
                  and bool(torch.isfinite(imgs).all()) and float(imgs.std()) > 1e-3,
                  f"zoo {name}: forward gave {tuple(imgs.shape)}")
            check(not any(launches.values()), f"zoo {name}: a kernel ran in a baseline forward {launches}")
            ms = cuda_ms(lambda: gen(*ins, only_tsf=False), reps=3, warmup=1)
        out[name] = {"params": sum(p.numel() for p in gen.parameters()), "nt": 2, "forward_ms": ms}
        del gen
    return out


def zoo_trainer(trainer: str, comp, batch, device) -> dict:
    """One trainer of the zoo at full width: the first step (K3 twice), the
    kernel step against the plain step from one state, `step_ms` by events
    over ZOO_STEPS steps after ZOO_WARMUP, host syncs a step, and `eval_step`
    with kernels against plain."""
    from ipercore_tpu_torch.ops.dispatch import force_plain
    from ipercore_tpu_torch.trainers import lwg_trainer as T
    from ipercore_tpu_torch.trainers import resolve_trainer

    gen_name = resolve_trainer(trainer)["default_gen"]
    state0, step, _, nets = train_rig(comp, batch, device, gen_name=gen_name)
    gen, dis, vgg, face = nets
    cfg = T.TrainConfig()
    zero_counts()
    state1, _ = step(state0)
    first = read_counts()
    check(first["raster_fim"] == 2 and not any(first[k] for k in ("raster_flows_csr", "grid_sample_nhwc")),
          f"zoo {trainer}: launches {first}")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sk, mk = step(state0)
        with force_plain():
            sp, mp = step(state0)
    finally:
        torch.backends.cudnn.deterministic = prev
    loss_rel = {k: abs(float(mk[k]) - float(mp[k])) / max(abs(float(mp[k])), 1e-6) for k in mk}
    check(max(loss_rel.values()) <= 1e-4, f"zoo {trainer}: kernel and plain losses differ {loss_rel}")
    agreement = state_agreement(sk, sp, cfg.lr_g, f"zoo {trainer} kernel vs plain")
    del sk, sp

    holder = [state1]

    def one():
        holder[0], m = step(holder[0])
        return m

    for _ in range(ZOO_WARMUP):
        one()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(ZOO_STEPS):
        metrics = one()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / ZOO_STEPS
    syncs = host_syncs(one)
    losses = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in losses.values()), f"zoo {trainer}: losses not finite {losses}")
    moved = max(float((holder[0].params_G[k] - state0.params_G[k]).abs().max()) for k in state0.params_G)
    check(moved > 0, f"zoo {trainer}: the parameters did not move")

    zero_counts()
    ek = T.eval_step(holder[0], batch, comp, gen, dis, vgg, face, cfg, ns=NS)
    eval_launches = read_counts()
    check(eval_launches["raster_fim"] == 2, f"zoo {trainer}: eval launches {eval_launches}")
    with force_plain():
        ep = T.eval_step(holder[0], batch, comp, gen, dis, vgg, face, cfg, ns=NS)
    eval_rel = {k: abs(float(ek[k]) - float(ep[k])) / max(abs(float(ep[k])), 1e-6) for k in ek}
    check(max(eval_rel.values()) <= 1e-4, f"zoo {trainer}: eval with kernels vs plain {eval_rel}")
    if gen_name == "AttLWB-Front":  # the real background stands in: no bg term
        check(not hasattr(gen, "bg_net"), "zoo LWGFrontTrainer: the generator has a BGNet")
    return {"generator": gen_name, "params_G": sum(v.numel() for v in state0.params_G.values()),
            "step_ms": step_ms, "steps_per_s": 1e3 / step_ms, "timed_steps": ZOO_STEPS,
            "warmup_steps": ZOO_WARMUP, "host_syncs_per_step": syncs, "k3_launches_per_step": first["raster_fim"],
            "k3_launches_per_eval": eval_launches["raster_fim"], "kernel_vs_plain_loss_rel_diff": loss_rel,
            "kernel_vs_plain_state": agreement, "eval_kernel_vs_plain_rel_diff": eval_rel,
            "losses_last_step": losses, "param_max_move": moved}


def zoo_train_service(device) -> dict:
    """`services/train.train(max_iters=2)` with `train_name =
    BaselineTrainer` in a 1-rank NCCL group; the checkpoint writer is
    replaced by a recorder (no write in this phase)."""
    import torch.distributed as dist

    from ipercore_tpu_torch.parallel import mesh
    from ipercore_tpu_torch.services import options
    from ipercore_tpu_torch.services import train as svc

    real_save, saves = svc.save_train_ckpt, []
    env_keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
    env_before = {k: os.environ.get(k) for k in env_keys}
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        for i, name in enumerate(("v0", "v1")):
            write_processed(data, name, 4, 31 + i, masks=True, background=True)
        opt = options.setup(None, [])
        # the options' gen_name (AttLWB-SPADE) would override the trainer's
        opt.update(image_size=SIZE, num_source=NS, time_step=NT, batch_size=1, Generator=CFG,
                   output_dir=os.path.join(root, "out"), model_id="baseline", dataset_dirs=[data],
                   train_name="BaselineTrainer", gen_name="InputConcat")
        opt.Discriminator.update(DIS_CFG)
        opt.Train.update(print_freq_s=0.0, display_freq_s=1e9, save_latest_freq_s=1e9)
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        try:
            dev = mesh.init_data_parallel(device, init_method="file://" + os.path.join(root, "store"))
            check(dist.is_initialized() and mesh.world_size() == 1, "zoo train service: no 1-rank group")
            svc.save_train_ckpt = lambda ckpt_dir, step, *a, **k: saves.append(step)
            reduces0 = mesh.all_reduce_mean.calls
            zero_counts()
            t0 = time.perf_counter()
            metrics = svc.train(opt, max_iters=2, device=dev)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = read_counts()
            reduces = mesh.all_reduce_mean.calls - reduces0
        finally:
            svc.save_train_ckpt = real_save
            if dist.is_initialized():
                dist.destroy_process_group()
            for k, v in env_before.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    losses = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in losses.values()) and "g_total" in losses,
          f"zoo train service: losses {losses}")
    check(saves == [2], f"zoo train service: checkpoint calls at {saves}")
    # the composer's UV raster, then each iteration the step's sources and
    # target and the eval's (no val.txt: every video is held out too)
    check(launches["raster_fim"] == 1 + (2 + 2) * 2 and reduces == 2 * 2,
          f"zoo train service: launches {launches}, all-reduces {reduces}")
    return {"trainer": "BaselineTrainer", "generator": "InputConcat", "iterations": 2, "wall_s": wall_s,
            "k3_launches": launches["raster_fim"], "nccl_all_reduces": reduces, "checkpoint_writes": 0,
            "losses_last_step": losses}


def zoo_phase(device) -> dict:
    from ipercore_tpu_torch.models import flow_composition as fc
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets

    model = smpl_mod.template_model(device=device)
    comp = fc.make_composer(model, load_assets(model, device=device), image_size=SIZE, out_dilate_ks=51)
    out = {"size": SIZE, "ns": NS, "dtype": "float32", "tf32": False}
    out.update(zoo_generators(comp, device))
    out["baselines"] = zoo_baselines(device)
    batch = train_batch(device)
    out["trainers"] = {t: zoo_trainer(t, comp, batch, device) for t in ZOO_TRAINERS}
    out["train_service"] = zoo_train_service(device)
    return out


# ---------------------------------------------------------------------------
# phase 11: the evaluate service on the main path's frames
# ---------------------------------------------------------------------------

def timed_call(fn):
    """(result, wall ms with the host work, device ms of its kernels) of one
    `fn()` after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return out, wall, sum(us for us, _ in kernel_times(fn)) / 1e3


def evaluate_phase(ctx, device) -> dict:
    """`evaluate_frames` on the main path's frames against the same frames
    with the plain versions forced, with the exact nets (seeded LPIPS and
    Inception weights given) and with the proxies; each metric timed; one
    chunk under `compute_dtype=bfloat16` scored against the f32 chunk."""
    from ipercore_tpu_torch.models import imitator as imit
    from ipercore_tpu_torch.models.networks import criterions as C
    from ipercore_tpu_torch.models.networks.inception import InceptionV3Features
    from ipercore_tpu_torch.ops.dispatch import force_plain
    from ipercore_tpu_torch.services import evaluate as E
    from ipercore_tpu_torch.services.run_imitator import imitate_sequence
    from ipercore_tpu_torch.utils.checkpoint import seeded_flat_params

    comp, gen, cache, smpls = ctx["comp"], ctx["gen"], ctx["cache"], ctx["smpls"]
    frames = ctx["frames"]
    with force_plain():
        plain = imitate_sequence(comp, gen, cache, smpls, chunk=CHUNK, device=device)
    metric = E.PerceptualMetric(params=seeded_flat_params(C.VGGFeatures(), 2), device=device)
    # LPIPS's learned 1x1 weights are non-negative (a distance): seeded, then |.|
    lpips_flat = {k: np.abs(v) if "/lin" in k else v for k, v in seeded_flat_params(C.LPIPSLin(), 5).items()}
    with tempfile.TemporaryDirectory() as root:
        nothing = os.path.join(root, "absent")
        exact = {"lpips_net": E.LPIPSMetric(weights_path=nothing, params=lpips_flat, device=device),
                 "fid_net": E.InceptionFID(weights_path=nothing,
                                           params=seeded_flat_params(InceptionV3Features(), 6), device=device)}
        proxy = {"lpips_net": E.LPIPSMetric(weights_path=nothing, device=device),
                 "fid_net": E.InceptionFID(weights_path=nothing, device=device)}
    check(exact["lpips_net"].available and exact["fid_net"].available
          and not proxy["lpips_net"].available and not proxy["fid_net"].available,
          "evaluate: the metric nets' weights are not as given")
    t0 = time.perf_counter()
    with_exact = E.evaluate_frames(frames, plain, metric=metric, device=device, **exact)
    exact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with_proxy = E.evaluate_frames(frames, plain, metric=metric, device=device, **proxy)
    proxy_s = time.perf_counter() - t0
    check(set(with_exact) == {"ssim", "psnr", "lpips", "fid"}
          and set(with_proxy) == {"ssim", "psnr", "lpips_proxy", "fid_proxy"},
          f"evaluate: keys {sorted(with_exact)} / {sorted(with_proxy)}")
    check(all(np.isfinite(v) for v in list(with_exact.values()) + list(with_proxy.values())),
          f"evaluate: not finite {with_exact} {with_proxy}")
    check(with_exact["ssim"] >= 0.999 and with_exact["psnr"] >= 40.0,
          f"evaluate: kernel and plain frames score ssim {with_exact['ssim']}, psnr {with_exact['psnr']}")
    # the metrics tell frames apart: each frame against the one before it
    shifted = np.roll(plain, 1, axis=0)
    far = {"lpips": float(np.mean(exact["lpips_net"](frames, shifted))),
           "psnr": float(E.psnr(torch.as_tensor(frames, device=device),
                                torch.as_tensor(shifted, device=device)).mean())}
    check(far["lpips"] > with_exact["lpips"] and far["psnr"] < with_exact["psnr"],
          f"evaluate: shifted frames score {far} against {with_exact}")

    a = torch.as_tensor(frames, device=device)
    b = torch.as_tensor(plain, device=device)
    times = {}
    for name, fn in (("ssim", lambda: E.ssim(a, b)), ("psnr", lambda: E.psnr(a, b)),
                     ("lpips", lambda: exact["lpips_net"](frames, plain)),
                     ("lpips_proxy", lambda: metric(frames, plain)),
                     ("inception_features_299", lambda: exact["fid_net"].features(frames)),
                     ("proxy_features", lambda: metric.feature_stats(frames))):
        _, wall, dev = timed_call(fn)
        times[name] = {"wall_ms": wall, "device_ms": dev}
    mu1, c1 = exact["fid_net"].feature_stats(frames)
    mu2, c2 = exact["fid_net"].feature_stats(plain)
    t0 = time.perf_counter()
    E.frechet_distance(mu1, c1, mu2, c2)
    times["frechet_2048_host"] = {"wall_ms": (time.perf_counter() - t0) * 1e3, "device_ms": 0.0}
    mu1, c1 = metric.feature_stats(frames)
    mu2, c2 = metric.feature_stats(plain)
    t0 = time.perf_counter()
    E.frechet_distance(mu1, c1, mu2, c2)
    times["frechet_512_host"] = {"wall_ms": (time.perf_counter() - t0) * 1e3, "device_ms": 0.0}

    # quality beside a speed choice: one chunk in bf16 against the f32 chunk
    batch = torch.as_tensor(smpls[:CHUNK], device=device)
    f32 = ctx["pred_csr"]
    bf16, bf16_mask = imit.synthesize_frames(comp, gen, cache, batch, compute_dtype=torch.bfloat16)
    _, f32_mask = imit.synthesize_frames(comp, gen, cache, batch)
    bf16_ms = cuda_ms(lambda: imit.synthesize_frames(comp, gen, cache, batch, compute_dtype=torch.bfloat16),
                      reps=3, warmup=1)
    f32_np, bf16_np = f32.cpu().numpy(), bf16.float().cpu().numpy()
    quality = {"ssim": float(E.ssim(f32, bf16.float()).mean()), "psnr": float(E.psnr(f32, bf16.float()).mean()),
               "lpips_proxy": float(np.mean(metric(bf16_np, f32_np))),
               # where the mask is 1 the frame is the setup's f32 background, so
               # the mask itself and its foreground share say what bf16 touched
               "mask_max_abs_diff": float((bf16_mask.float() - f32_mask).abs().max()),
               "foreground_share_f32": float((1.0 - f32_mask).mean())}
    check(all(np.isfinite(v) for v in quality.values()), f"evaluate: bf16 scores {quality}")
    return {"frames": int(len(frames)), "size": SIZE, "exact_seeded_nets": with_exact, "proxies": with_proxy,
            "against_previous_frame": far, "evaluate_frames_s": {"exact": exact_s, "proxy": proxy_s},
            "metric_ms": times,
            "bf16_chunk_vs_f32": dict(quality, chunk=CHUNK, bf16_chunk_ms=bf16_ms, f32_chunk_ms=ctx["chunk_ms"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["kernels"], default=None,
                    help="'kernels': build and check the kernels, then stop (no ok line)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false); "
              "this check runs only on a GPU", file=sys.stderr)
        return 2

    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.utils import cuda_build

    device = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", name_and_power_limit=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    cuda_build.build_all()
    emit("build", seconds=time.perf_counter() - t0, sources=list(cuda_build.SOURCES))

    model = smpl_mod.template_model(device=device)
    assets = load_assets(model, device=device)
    kernels = kernel_checks(model, assets, device)
    emit("kernel_check", ok=True, kernels={
        k: {"max_abs_err": v["max_abs_err"], "shape": v["shape"]} for k, v in kernels.items()})
    if args.only == "kernels":
        emit("kernels", kernels=kernels)
        return 0

    ctx, result = main_path(device)
    emit("main_path", **result)
    table = table_route(ctx, device)
    emit("table_route", **table)
    emit("temporal", **temporal_phase(ctx, device))
    evaluated = evaluate_phase(ctx, device)
    emit("evaluate", **evaluated)
    del ctx
    services = services_phase(device)
    service_runs = {k: services.pop(k) for k in ("personalize", "imitate_personalized", "personalize_again")}
    emit("services", **services)
    train = train_phase(device)
    emit("personalize", service=service_runs, train_step=train)
    service_train = train_service_phase(device)
    emit("train_service", **service_train)
    zoo = zoo_phase(device)
    emit("zoo", **zoo)

    # launches: K1-K3 on the main path's run, K4 on the table route's
    launches = dict(result["launches"], raster_flows_table=table["launches"]["raster_flows_table"])
    kernels["raster_fim"]["launches_per_train_step"] = train["k3_launches_per_step"]
    kernels["raster_fim"]["launches_per_train_service_iteration"] = service_train["k3_launches_per_iter"]
    # the zoo's paths: per chunk and per setup of each other LWB generator, per
    # step and per eval of its two trainers
    for name in ("raster_flows_csr", "grid_sample_nhwc", "raster_fim"):
        kernels[name]["launches_zoo_per_chunk"] = {
            g: v["launches_chunk"][name] for g, v in zoo["generators"].items()}
        kernels[name]["launches_zoo_per_setup"] = {
            g: v["launches_setup"][name] for g, v in zoo["generators"].items()}
    kernels["raster_fim"]["launches_per_zoo_train_step"] = {
        t: v["k3_launches_per_step"] for t, v in zoo["trainers"].items()}
    kernels["raster_fim"]["launches_per_zoo_eval_step"] = {
        t: v["k3_launches_per_eval"] for t, v in zoo["trainers"].items()}
    line = {"kernels": [
        {"name": name, "replaces": REPLACES[name], "launches": launches[name],
         "ms": v["wrapper_ms"], **v}  # `ms`: the whole call, as a user of the wrapper pays it
        for name, v in kernels.items()]}
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
