#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # everything; ends with the ok line
    python3 chip_smoke.py --only kernels  # build + kernel checks only, no ok line

Builds the CUDA kernels of `ipercore_tpu_torch` from the sources in this
checkout, holds each against its plain PyTorch version (and each device
binning against its plain binning) on the GPU at the shapes the main path
gives it (K5, SPADE's convolutions, against its plain version in float64,
within twice the error of cuDNN's float32), then drives the main path (full-width
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
Then the other generators, trainers and evaluation (`zoo`, `evaluate`), and
preprocessing part 1 (`preprocess_2d`: person detection with the segmenter
and Body-25, the crop and 2D pose on a 48-frame 1080x1920 clip; each network
on the card against the CPU, the native host routines against their plain
versions), which runs none of the four kernels; and preprocessing part 2
(`preprocess_3d`: SPIN on those crops, multi-hypothesis SMPLify with the GMM
pose prior, the silhouette offset fit against K3's silhouettes of a wider
body, cloth links; each on the card against the CPU, K3 bit-equal to its
plain version on the phase's batches); preprocessing part 3
(`preprocess_mattes`: on those crops, the SMPL silhouettes through K3, the
GCA mattor with the fused contextual attention, held against the plain
attention on the real bottleneck, the SCHP parser, the inpaintors with and
without super-resolution; each on the card against the CPU); and the
`pipeline`: a raw clip of PNG frames through the three stages of
`run_imitator` (preprocess, personalize, imitate), then `run_viewer` and
`run_swapper`, with K1-K3 launched, the body in the frame (SPIN's camera
head zeroed), the offsets moved, the imitated frames changing, and K3
bit-equal to its plain version on the pipeline's batches. After `evaluate`:
`parallel` (`sharded_synthesize` on 13 frames over every visible card and over
[cuda:0, cuda:0], each shard bit-equal to `synthesize_frames` of its frames;
with a second card, K1-K3 on `cuda:1` while `cuda:0` is current) and
`streaming` (`StreamingSynthesizer` over 32 frames writing PNGs, byte-equal to
`imitate_sequence` + `write_frames`); `synth_data` (`compose_scene` at
`scripts/train_spin.py`'s defaults: K1 bit-equal on its renders, the scene
against the CPU fed the card's draws); last, `perception_train` (the six
training drivers of `ipercore_tpu_torch/scripts/` at the JAX drivers'
published defaults: K1, and K3 in the generator's, bit-equal to their plain
versions on the trainers' own batches, timed steps, one step against the
CPU, SPIN's statistics unchanged, each saved file loaded by its consumer);
then `drivers` (the SCHP, inpaintor and ESRGAN trainers at the JAX drivers'
published defaults with their pools or scenes through K1 bit-equal, one step
each against the CPU, the inpaintor's stage 2 through the fused contextual
attention's backward against the plain route; `accuracy_cost` at 512² with
K1-K3 bit-equal; `verify_perception`, `fit_gmm_prior`, the three
pseudo-labellers on clip frames written as PNGs, `visual_processed_data` with
K3 bit-equal, and `self_imitation` saying that it has no clip). The last
phase lines give each phase's seconds (`timing`).
Reads no weight file: every network is seeded (the GMM pose prior is data,
tracked in the repository).
Every phase prints one JSON line; any failed check raises, so the exit code
is non-zero. Needs one GPU; exits with code 2 when there is none.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import io
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

T_START = time.perf_counter()
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
    "spade_conv": "none: the JAX package left SPADE's convolutions to XLA",
}
TABLE_K = 2048  # faces per 8x128 tile of the table route, the JAX default
# the personalization default discriminator (`patch_global`) at its published width
DIS_CFG = {"ndf": 64, "n_layers": 4, "max_nf_mult": 8, "use_sigmoid": False}
NT = 1  # target frames per train step (`time_step`)
TRAIN_WARMUP, TRAIN_STEPS, SERVICE_ITERS = 3, 10, 4


PHASE_S: dict = {}  # seconds from one phase line to the next
_LAST_EMIT = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    now = time.perf_counter()
    PHASE_S[phase], _LAST_EMIT[0] = now - _LAST_EMIT[0], now
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


def kernel_times_and_wall(fn) -> tuple:
    """`kernel_times(fn)` and the host-clock milliseconds of that same
    profiled call, synchronised before and after: busy and wall time of one
    run (the profiler's own host cost is inside the wall time)."""
    walls = []

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    times = kernel_times(timed)
    return times, walls[-1]


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
    """Host syncs that one `fn()` makes, counted by torch's sync debug mode.
    The mode's one-time notice that it is a prototype ("Synchronization debug
    mode is a prototype feature ...") is no sync and is not counted."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    messages = [str(w.message).lower() for w in caught]
    return sum("synchroniz" in m and "prototype" not in m for m in messages)


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

    results["spade_conv"] = spade_conv_checks(device)
    return results


# SPADE's blocks on the main path, each on a chunk of CHUNK frames: (name, side, channels)
SPADE_SHAPES = (("enc_fusion_0", SIZE // 2, 64), ("enc_fusion_1", SIZE // 4, 128),
                ("enc_fusion_2", SIZE // 8, 256), ("res_fusion", SIZE // 8, 256))
SPADE_NARROW = ((8, 8), (16, 16), (32, 32), (5, 3), (6, 12))  # (channels, condition channels)


def spade_case(n: int, side_h: int, side_w: int, c: int, cond_c: int, seed: int, device) -> dict:
    """K5 on one SPADE block (seeded weights and non-zero biases) against its
    plain version in float64 and against the module's `nn.Conv2d` path
    (cuDNN, float32, TF32 off) on the same inputs; the largest absolute
    errors of both against float64."""
    from ipercore_tpu_torch.models.networks.blocks import SPADE
    from ipercore_tpu_torch.ops import spade_conv_cuda as k5

    torch.manual_seed(seed)
    spade = SPADE(norm_nc=c, cond_nc=cond_c).to(device)
    with torch.no_grad():
        for conv in (spade.Conv_0, spade.Conv_1, spade.Conv_2):
            conv.bias.uniform_(-0.1, 0.1)
    x = torch.randn((n, side_h, side_w, c), device=device)
    cond = torch.randn((n, side_h, side_w, cond_c), device=device)
    with torch.no_grad():
        out = spade(x, cond)
    with torch.enable_grad():
        lib = spade(x, cond).detach()
    (wp0, b0), (wp12, b12) = spade.packed_weights()
    d = lambda t: t.double()
    x64 = d(x)
    mean64 = x64.mean(dim=(1, 2), keepdim=True)
    rstd64 = torch.rsqrt(x64.var(dim=(1, 2), keepdim=True, unbiased=False) + 1e-5)
    ref = k5.spade_modulate_plain(k5.spade_conv_relu_plain(d(cond), d(wp0), d(b0)), d(wp12), d(b12),
                                  x64, mean64, rstd64)
    err = float((out.double() - ref).abs().max())
    err_lib = float((lib.double() - ref).abs().max())
    check(bool(torch.isfinite(out).all()) and err <= 2 * err_lib,
          f"spade_conv {n}x{side_h}x{side_w} c={c}: max abs error {err} against float64, "
          f"more than twice cuDNN's {err_lib}")
    return {"spade": spade, "x": x, "cond": cond, "max_abs_err": err, "library_max_abs_err": err_lib}


def spade_conv_checks(device) -> dict:
    """K5 at SPADE's main-path shapes, at a ragged one and at narrow and odd
    widths: error against float64 within twice cuDNN's, then the two launches
    of a block timed (`kernel_ms`) beside cuDNN's three `F.conv2d`
    (`library_ms`), the FFMA bound of the block's operations, and the
    packing of its weights that `SPADE` does on every call (`pack_ms`)."""
    import torch.nn.functional as Fn

    from ipercore_tpu_torch.models.networks import blocks as bl
    from ipercore_tpu_torch.models.networks.blocks import instance_norm_stats
    from ipercore_tpu_torch.ops import spade_conv_cuda as k5

    ragged = spade_case(3, 37, 53, 96, 48, 7, device)  # a partial row tile and a partial column tile
    # the smoke configuration's widths (`accuracy_cost.SMOKE_CFG`), and odd ones on K5's float path
    narrow = {}
    for i, (c, cond_c) in enumerate(SPADE_NARROW):
        case = spade_case(2, 33, 29, c, cond_c, 20 + i, device)
        narrow[f"c={c} cond_c={cond_c}"] = {k: case[k] for k in ("max_abs_err", "library_max_abs_err")}
    shapes = {}
    for i, (name, side, c) in enumerate(SPADE_SHAPES):
        case = spade_case(CHUNK, side, side, c, c, 10 + i, device)
        spade, x, cond = case["spade"], case["x"], case["cond"]
        (wp0, b0), (wp12, b12) = spade.packed_weights()
        mean, rstd = instance_norm_stats(x)
        actv = k5.spade_conv_relu(cond, wp0, b0)
        call = lambda: k5.spade_modulate(k5.spade_conv_relu(cond, wp0, b0), wp12, b12, x, mean, rstd)
        plain = lambda: k5.spade_modulate_plain(k5.spade_conv_relu_plain(cond, wp0, b0), wp12, b12,
                                                x, mean, rstd)
        lib = lambda: (Fn.relu(bl.conv_nhwc(spade.Conv_0, cond)), bl.conv_nhwc(spade.Conv_1, actv),
                       bl.conv_nhwc(spade.Conv_2, actv))
        with torch.no_grad():
            flops = 2.0 * x.shape[0] * side * side * 9 * (c * 128 + 128 * 2 * c)
            kernel_ms = cuda_ms(call)
            lib_us = device_us_by_kernel(lib)
            shapes[name] = {
                "shape": f"N={CHUNK} {side}x{side} c={c} nhidden=128",
                "max_abs_err": case["max_abs_err"], "library_max_abs_err": case["library_max_abs_err"],
                "kernel_ms": kernel_ms, "wrapper_ms": cuda_ms(lambda: spade(x, cond)),
                "plain_ms": cuda_ms(plain, reps=3), "library_ms": cuda_ms(lib),
                "bound_ms": flops / PEAK_F32_FLOPS * 1e3, "bound_by": "operations",
                "gflop": flops / 1e9, "tflop_per_s": flops / kernel_ms / 1e9,
                "device_us": device_us_by_kernel(call), "host_syncs": host_syncs(call),
                "pack_ms": cuda_ms(spade.packed_weights),
                "pack_device_us": sum(device_us_by_kernel(spade.packed_weights).values()),
                "relu_launch_ms": cuda_ms(lambda: k5.spade_conv_relu(cond, wp0, b0)),
                "modulate_launch_ms": cuda_ms(lambda: k5.spade_modulate(actv, wp12, b12, x, mean, rstd)),
                "library_device_us": sum(lib_us.values()),
                "library_kernels": sorted(lib_us, key=lib_us.get, reverse=True)[:4],
            }
        del case, spade, x, cond, actv
    total = lambda key: sum(v[key] for v in shapes.values())
    return {
        "route": "cuda", "source": "ipercore_tpu_torch/csrc/spade_conv.cu",
        "max_abs_err": max([ragged["max_abs_err"]] + [v["max_abs_err"] for v in shapes.values()]),
        "ragged_max_abs_err": ragged["max_abs_err"],
        "ragged_library_max_abs_err": ragged["library_max_abs_err"], "narrow": narrow,
        "kernel_ms": total("kernel_ms"), "wrapper_ms": total("wrapper_ms"), "plain_ms": total("plain_ms"),
        "library_ms": total("library_ms"), "bound_ms": total("bound_ms"), "bound_by": "operations",
        "binning_ms": None, "host_syncs": total("host_syncs"), "shapes": shapes,
        "shape": "; ".join(v["shape"] for v in shapes.values()),
    }


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
    """Launch counters, by their names in the port's counter registry: the
    five kernels, the device binning that K1 and K3 launch before their walk,
    and K4's device binning."""
    return {"raster_flows_csr": "k1.launches", "grid_sample_nhwc": "k2.launches",
            "raster_fim": "k3.launches", "raster_flows_table": "k4.launches",
            "spade_conv": "k5.launches",
            "raster_binning": "raster_binning.launches", "table_binning": "table_binning.launches"}


def zero_counts() -> None:
    from ipercore_tpu_torch.utils.logging import reset_counts

    reset_counts(counters().values())


def read_counts() -> dict:
    from ipercore_tpu_torch.utils.logging import counts

    torch.cuda.synchronize()
    now = counts()
    return {k: now.get(name, 0) for k, name in counters().items()}


def close_fraction(a, b, tol: float = 1e-3) -> float:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float(((a.float().cpu() - b.float().cpu()).abs() <= tol).float().mean())


def kernel_kind(key: str) -> str:
    """The kind of a profiled device kernel, by its name."""
    name = key.lower()
    # the hand-written kernels: K1/K3's and K4's binning, walk and epilogue, K2
    if HAND_WRITTEN.search(key):
        return "kernels"
    if any(w in name for w in ("conv", "cudnn", "gemm", "xmma", "cutlass", "winograd",
                               "implicit", "nchwtonhwc", "nhwctonchw", "dgrad",
                               "fft", "dse::", "pointwise_mult_and_sum_complex")) \
            or ("gemv" in name and "float2" in name):
        # cuDNN's f32 algorithms include FFT convolutions (DSE::*_fft*,
        # pointwise_mult_and_sum_complex, complex (float2) gemv and gemm
        # between the transforms) and dgrad engines for ConvTranspose
        return "convolutions"
    if any(w in name for w in ("sort", "radix", "scan", "searchsorted", "repeat_interleave")):
        return "binning_sort_scan"
    return "other"


def device_breakdown(fn, hand_written: bool = True) -> dict:
    """Device milliseconds of one `fn()` by kind of kernel, from torch.profiler
    (`hand_written`: `fn` launches one of the four kernels)."""
    kinds = {"convolutions": 0.0, "kernels": 0.0, "binning_sort_scan": 0.0, "other": 0.0}
    by_name = []
    for us, key in kernel_times(fn):
        by_name.append((us / 1e3, key[:70]))
        kinds[kernel_kind(key)] += us
    out = {k: v / 1e3 for k, v in kinds.items()}
    out["busy"] = sum(out.values())
    check((out["kernels"] > 0 or not hand_written) and out["convolutions"] > 0,
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
    # K5: two launches in each of the generator's nine SPADE blocks a chunk
    check(launches["spade_conv"] == 18 * (N_FRAMES // CHUNK),
          f"spade_conv launched {launches['spade_conv']} times for {N_FRAMES // CHUNK} chunks")
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
    """`read_png` (native row filters) of one 512² RGB image stored with Sub
    rows (the port's writer) and stored with Paeth rows; both must decode to
    the image."""
    from ipercore_tpu_torch.utils import video as vid

    img = np.random.RandomState(9).randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
    sub, paeth = os.path.join(root, "sub.png"), os.path.join(root, "paeth.png")
    vid.write_png(sub, img)
    with open(paeth, "wb") as f:
        f.write(png_paeth(img))
    out = {}
    for name, path in (("sub", sub), ("paeth", paeth)):
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


# ---------------------------------------------------------------------------
# phase 12: preprocessing part 1 (detection, tracking, the crop, 2D pose)
# ---------------------------------------------------------------------------

CLIP_FRAMES, CLIP_H, CLIP_W = 48, 1080, 1920  # detection's max_frames, a phone / camera clip
POSE_SIZE, SEG_WORK, MOBILENET_SIZE, CROP_SIZE = 368, 256, 256, 512
POSE_TRAINED_SIZE = 320  # the `__meta__/input_size` the repository's trained Body-25 weights carry


def person_clip(device, seed: int = 12, n: int = CLIP_FRAMES, x_from: float = 0.35,
                x_to: float = 0.65) -> np.ndarray:
    """(n, 1080, 1920, 3) frames in [-1, 1], made on the card from a seed: a
    static textured background, one person-shaped blob (head, torso, arms,
    legs, with its own texture) walking right from x_from to x_to of the
    width, and camera noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    yy = torch.arange(CLIP_H, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(CLIP_W, device=device, dtype=torch.float32)[None, :]
    tint = torch.tensor([0.5, 0.3, 0.2], device=device)
    bg = (0.4 * torch.sin(xx / 37.0) * torch.cos(yy / 53.0))[..., None] * tint \
        + 0.2 * (torch.rand(CLIP_H, CLIP_W, 3, generator=g, device=device) * 2 - 1) - 0.2
    tex = torch.stack([0.3 + 0.2 * torch.sin(yy / 9.0).expand(CLIP_H, CLIP_W),
                       -0.5 + 0.1 * torch.cos(xx / 11.0).expand(CLIP_H, CLIP_W),
                       torch.full((CLIP_H, CLIP_W), 0.6, device=device)], -1)
    s, cy = 0.78 * CLIP_H, 0.52 * CLIP_H
    frames = torch.empty(n, CLIP_H, CLIP_W, 3, device=device)
    for i in range(n):
        cx = x_from * CLIP_W + (x_to - x_from) * CLIP_W * i / (n - 1)
        m = (xx - cx) ** 2 + (yy - (cy - 0.42 * s)) ** 2 < (0.08 * s) ** 2
        m = m | (((xx - cx).abs() < 0.13 * s) & (yy > cy - 0.33 * s) & (yy < cy + 0.05 * s))
        for side in (-1, 1):
            m = m | (((xx - cx - side * 0.06 * s).abs() < 0.05 * s) & (yy >= cy + 0.05 * s) & (yy < cy + 0.5 * s))
            m = m | (((xx - cx - side * 0.18 * s).abs() < 0.04 * s) & (yy > cy - 0.3 * s) & (yy < cy + 0.02 * s))
        noise = 0.02 * torch.randn(CLIP_H, CLIP_W, 3, generator=g, device=device)
        frames[i] = torch.where(m[..., None], tex, bg) + noise
    return frames.clamp_(-1, 1).cpu().numpy()


def conv_flops(net: torch.nn.Module, x: torch.Tensor) -> float:
    """Multiply-adds x 2 of the convolutions and linear layers of one forward
    of `net` on `x`, from the output shapes their forward hooks see."""
    total = [0.0]

    def hook(m, inp, out):
        if isinstance(m, torch.nn.Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
            total[0] += 2.0 * out.numel() * k
        else:
            total[0] += 2.0 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def agreement(got: torch.Tensor, want: torch.Tensor, what: str, phase: str = "preprocess_2d") -> dict:
    """`got` (card) against `want` (CPU): the share within 1e-3 (>= 99.5 %
    required) and the largest error relative to the largest value (<= 1e-3
    required: seeded nets give small outputs, where 1e-3 alone says little)."""
    got, want = got.float().cpu(), want.float().cpu()
    out = {"close_fraction": close_fraction(got, want), "max_abs_err": float((got - want).abs().max()),
           "max_abs": float(want.abs().max())}
    out["max_rel_err"] = out["max_abs_err"] / max(out["max_abs"], 1e-30)
    check(out["close_fraction"] >= 0.995 and out["max_rel_err"] <= 1e-3,
          f"{phase}: {what} on the card against the CPU: {out}")
    return out


def person_masks(frames: np.ndarray) -> np.ndarray:
    """The drawn person of `person_clip`'s frames: its texture alone has a
    blue channel above 0.4 (the background's stays under 0.1, noise
    included)."""
    return frames[..., 2] > 0.4


def calibrated_seg_params(seg_flat: dict, frames: np.ndarray, work: int) -> tuple:
    """The seeded segmenter with its last 1x1 convolution rescaled on the
    first frame, so that its logits are -4 at the background's mean and +4 at
    the drawn person's: the seeded net separates the two textures (its
    logits differ by about 11 standard deviations of the background's) but
    at near-zero logits, which no component passes detection's gate with.
    Returns (params, {mean logits and the share of grid pixels classified
    right on that frame})."""
    from ipercore_tpu_torch.tools import detection as D
    from ipercore_tpu_torch.tools.mattors import HumanMattor

    small = D._resize(frames[:1], work)
    logit = HumanMattor(seg_params=seg_flat, device="cpu").segment(small)[0, ..., 0].numpy()
    person = person_masks(small)[0]
    lo, hi = float(logit[~person].mean()), float(logit[person].mean())
    a, mid = 8.0 / (hi - lo), 0.5 * (lo + hi)
    cal = dict(seg_flat)
    cal["params/Conv_2/kernel"] = seg_flat["params/Conv_2/kernel"] * a
    cal["params/Conv_2/bias"] = (seg_flat["params/Conv_2/bias"] - mid) * a
    right = float(((a * (logit - mid) > 0) == person).mean())
    return cal, {"background_logit": lo, "person_logit": hi, "scale": a, "pixels_right": right}


def planted_heatmaps(n: int, h: int, w: int, seed: int = 13) -> torch.Tensor:
    """(n, h, w, 26) Body-25 heatmaps with one Gaussian peak (sigma 1.5 px,
    height 0.5-1) per joint over noise under 1e-3, on the host: joints 0-4
    peak on the four edges and a corner, and joints 5-7 hold two equal peaks
    each (a tie the decode must break towards the first in row-major order).
    Returns the maps and the (n, 25, 2) planted (x, y) of the peak the decode
    should pick."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    maps = rng.uniform(0, 1e-3, (n, h, w, 26)).astype(np.float32)
    want = np.zeros((n, 25, 2), np.float32)
    edges = [(0, None), (w - 1, None), (None, 0), (None, h - 1), (0, 0)]
    for i in range(n):
        for j in range(25):
            x, y = rng.randint(2, w - 2), rng.randint(2, h - 2)
            if j < len(edges):
                ex, ey = edges[j]
                x, y = ex if ex is not None else x, ey if ey is not None else y
            peaks = [(x, y)]
            if 5 <= j < 8:  # a tie: a second, identical peak on another row
                peaks.append((rng.randint(2, w - 2), (y + rng.randint(6, 12)) % (h - 4) + 2))
            amp = rng.uniform(0.5, 1.0)
            for px, py in peaks:
                maps[i, ..., j] = np.maximum(
                    maps[i, ..., j], amp * np.exp(-((xx - px) ** 2 + (yy - py) ** 2) / (2 * 1.5 ** 2)))
            want[i, j] = min(peaks, key=lambda p: (p[1], p[0]))
    return torch.from_numpy(maps), want


def preprocess_phase(device) -> dict:
    """Preprocessing part 1 as `Preprocessor.execute` runs it (stage 1.1-1.2
    and the 2D half of 1.3) on a 48-frame 1080x1920 clip: `detect_person_boxes`
    with the segmenter and Body-25 (seeded weights given as parameters, so
    both count as trained and detection runs them; the segmenter's last layer
    rescaled so that the drawn person passes detection's gate and the
    segmentation branch is taken), the union box, the 48
    crops to 512², `run_tracked_robust` on them at the runner's trained size
    (320), the left/right swap filter and the cocoplus-19 mapping. Then each
    network on the card against itself on the CPU, the native routines
    against their plain versions, and the times."""
    from ipercore_tpu_torch.ops.sampling import resize_image
    from ipercore_tpu_torch.tools import detection as D
    from ipercore_tpu_torch.tools.mattors import PERSON_SEG_SEED, HumanMattor, PersonSegUNet
    from ipercore_tpu_torch.tools.pose2d import (OPENPOSE_SEED, OpenPoseBody25, OpenPoseRunner,
                                                 body25_to_cocoplus, decode_single_person)
    from ipercore_tpu_torch.tools.pose2d_mobilenet import (MOBILENET_SEED, MobilenetOpenPose,
                                                           MobilenetOpenPoseRunner)
    from ipercore_tpu_torch.tools.preprocessor import fmt_active_boxes, process_crop_img, update_active_boxes
    from ipercore_tpu_torch.tools.trackers import box_iou
    from ipercore_tpu_torch.utils import native
    from ipercore_tpu_torch.utils import video as vid
    from ipercore_tpu_torch.utils.checkpoint import seeded_flat_params
    from ipercore_tpu_torch.utils.smoothing import pose2d_temporal_filter

    t0 = time.perf_counter()
    frames = person_clip(device)
    clip_s = time.perf_counter() - t0
    pose_flat = seeded_flat_params(OpenPoseBody25(), OPENPOSE_SEED)
    seg_flat = seeded_flat_params(PersonSegUNet(), PERSON_SEG_SEED)
    mob_flat = seeded_flat_params(MobilenetOpenPose(), MOBILENET_SEED)
    seg_flat, out_cal = calibrated_seg_params(seg_flat, frames, SEG_WORK)
    runner = OpenPoseRunner(params=pose_flat, device=device)
    runner.trained_size = POSE_TRAINED_SIZE
    mattor = HumanMattor(seg_params=seg_flat, device=device)
    seg = D.SegmentationDetector(mattor=mattor, work=SEG_WORK, device=device)
    mobilenet = MobilenetOpenPoseRunner(params=mob_flat, device=device)
    out = {"clip": [CLIP_FRAMES, CLIP_H, CLIP_W], "clip_make_s": clip_s, "segmenter_calibration": out_cal}

    # --- the main path, launch counts set to 0 just before it ---------------
    zero_counts()
    t0 = time.perf_counter()
    boxes, method = D.detect_person_boxes(frames, seg_detector=seg, pose2d=runner, device=device)
    torch.cuda.synchronize()
    out["detect_s"], out["method"] = time.perf_counter() - t0, method
    H, W = frames.shape[1:3]
    # the calibrated segmenter finds the drawn person: its acceptance path
    # (components, the pose-seed filter, the gate, zoom refinement) runs
    check(method == "person_seg" and boxes is not None, f"preprocess_2d: detection took {method!r}")
    check(boxes.shape == (CLIP_FRAMES, 4) and np.isfinite(boxes).all()
          and (boxes[:, :2] >= 0).all() and (boxes[:, 2] <= W).all() and (boxes[:, 3] <= H).all()
          and (boxes[:, 2:] > boxes[:, :2]).all(), f"preprocess_2d: boxes {boxes[:2]} ({method})")
    ious = []
    for b, m in zip(boxes, person_masks(frames)):
        ys, xs = np.nonzero(m)
        drawn = np.asarray([[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]], np.float32)
        ious.append(float(box_iou(b, drawn)[0]))
    out["box_iou_with_drawn_person"] = {"min": min(ious), "mean": float(np.mean(ious))}
    check(min(ious) >= 0.4, f"preprocess_2d: person boxes miss the drawn person (IoU {min(ious)})")
    active = None
    for b in boxes:
        active = update_active_boxes(b, active)
    box = fmt_active_boxes(active, (H, W), factor=1.25)
    check(np.isfinite(box).all() and box[0] >= 0 and box[1] >= 0 and box[2] <= W and box[3] <= H,
          f"preprocess_2d: crop box {box}")
    t0 = time.perf_counter()
    crops = np.stack([process_crop_img(f, box, CROP_SIZE, device=device)[0] for f in frames])
    out["crop_s"] = time.perf_counter() - t0
    check(crops.shape == (CLIP_FRAMES, CROP_SIZE, CROP_SIZE, 3) and np.isfinite(crops).all(),
          "preprocess_2d: crops")
    pose_in = resize_image(torch.as_tensor(crops, device=device), POSE_TRAINED_SIZE,
                           POSE_TRAINED_SIZE).cpu().numpy()
    t0 = time.perf_counter()
    kps, scores, valid = runner.run_tracked_robust(pose_in)
    torch.cuda.synchronize()
    out["robust_s"] = time.perf_counter() - t0
    stacked = pose2d_temporal_filter(np.concatenate([kps, (scores * valid)[..., None]], axis=-1), window_size=5)
    kps19, conf19 = body25_to_cocoplus(stacked[..., :2], stacked[..., 2])
    check(kps19.shape == (CLIP_FRAMES, 19, 2) and np.isfinite(kps19).all() and np.isfinite(conf19).all()
          and (np.abs(kps19) <= 1.5).all(), "preprocess_2d: keypoints")
    out["launches"] = read_counts()
    out["box"] = [float(v) for v in box]
    # detection's parts, each again alone: the host pooling of the clip to the
    # segmenter's grid, the segmenter, the pose seeds, the background model
    split = {}
    for name, fn in (("pool_to_seg_grid", lambda: D._resize(frames, SEG_WORK)),
                     ("segmenter_probs", lambda: seg.run_probs(frames)),
                     ("pose_seeds", lambda: D.pose_person_boxes(frames, pose2d=runner, device=device)),
                     ("median_bg", lambda: D.track_person_boxes(frames))):
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        split[name] = time.perf_counter() - t0
        if name == "median_bg":
            out["median_bg_found"] = got is not None
    out["detect_split_s"] = split
    out["median_bg_s"] = split["median_bg"]
    out["confident_joints_per_frame"] = float((conf19 > 0.3).sum(1).mean())

    # --- Body-25 on the clip at 368² -----------------------------------------
    x368 = resize_image(torch.as_tensor(frames, device=device), POSE_SIZE, POSE_SIZE)
    forward = lambda: runner.heads(x368)
    ms = cuda_ms(forward, reps=2, warmup=1)
    n_chunks = -(-CLIP_FRAMES // 32)
    torch.cuda.reset_peak_memory_stats()
    _, wall = once_ms(forward)  # host clock around one forward, synchronised
    times, profiled_wall = kernel_times_and_wall(forward)
    by_kind = {"convolutions": 0.0, "other": 0.0}
    for us, key in times:
        by_kind["convolutions" if kernel_kind(key) == "convolutions" else "other"] += us / 1e3
    busy = sum(by_kind.values())
    flops = 2 * CLIP_FRAMES * conv_flops(runner.net, x368[:1])  # the flip doubles the batch
    out["openpose"] = {
        "forward_ms": ms, "frames_per_s": CLIP_FRAMES / (ms / 1e3), "chunk": 32,
        # busy and wall of one profiled forward; `wall_ms` is one forward without the profiler
        "device_ms": dict(by_kind, busy=busy), "profiled_wall_ms": profiled_wall,
        "device_idle_share": 1 - busy / profiled_wall, "wall_ms": wall,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "host_syncs_per_chunk": host_syncs(forward) / n_chunks,
        "conv_gflop_per_frame_with_tta": flops / CLIP_FRAMES / 1e9,
        "conv_tflop_per_s": flops / (ms / 1e3) / 1e12,
        "top": [{"ms": us / 1e3, "kernel": k[:70]} for us, k in sorted(times, reverse=True)[:5]]}
    out["openpose_frames_per_s"] = out["openpose"]["frames_per_s"]
    _, tracked_wall = once_ms(lambda: runner.run_tracked(x368, smooth=True))
    # two runs, unclipped: a negative reading would show that the forward's
    # wall time varies by more than the decode costs
    out["run_tracked_wall_ms"] = tracked_wall
    out["decode_ms_per_frame"] = (tracked_wall - wall) / CLIP_FRAMES

    # --- the networks on the card against the CPU, on 2 frames ---------------
    two = x368[:2]
    paf_k, hm_k = runner.heads(two)
    cpu_runner = OpenPoseRunner(params=pose_flat, device="cpu")
    paf_c, hm_c = cpu_runner.heads(two.cpu())
    checks = {"openpose_pafs": agreement(paf_k, paf_c, "Body-25 PAFs"),
              "openpose_heatmaps": agreement(hm_k, hm_c, "Body-25 heatmaps")}
    dec_k = decode_single_person(hm_k)
    dec_c = decode_single_person(hm_k.cpu())
    check(all(torch.equal(a.cpu(), b) for a, b in zip(dec_k, dec_c)),
          "preprocess_2d: decode_single_person on the card differs from the CPU's")
    # the seeded net's maps are near flat: the decode again on planted peaks
    # (edges, a corner, ties) at Body-25's 46² output grid
    planted, want_px = planted_heatmaps(4, POSE_SIZE // 8, POSE_SIZE // 8)
    dec_k = decode_single_person(planted.to(device))
    dec_c = decode_single_person(planted)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(dec_k, dec_c)),
          "preprocess_2d: decode_single_person on planted peaks differs between the card and the CPU")
    hw = np.asarray([planted.shape[2], planted.shape[1]], np.float32)
    px = (dec_c[0].numpy() * hw + hw - 1) / 2  # NDC -> pixel, sub-pixel offset included
    err = np.abs(px - want_px)
    checks["planted_decode"] = {"max_px_err_edges": float(err[:, :5].max()),
                                "max_px_err_interior_and_ties": float(err[:, 5:].max()),
                                "valid": int(dec_c[2].sum()), "joints": int(dec_c[2].numel())}
    check(err.max() <= 1.0 and err[:, 5:].max() < 0.05 and bool(dec_c[2].all()),
          f"preprocess_2d: the decode misses planted peaks: {checks['planted_decode']}")
    small = D._resize(frames[:2], SEG_WORK)
    cpu_mattor = HumanMattor(seg_params=seg_flat, device="cpu")
    checks["segmenter_probs"] = agreement(torch.sigmoid(mattor.segment(small)),
                                          torch.sigmoid(cpu_mattor.segment(small)), "segmenter probabilities")
    x256 = resize_image(torch.as_tensor(frames, device=device), MOBILENET_SIZE, MOBILENET_SIZE)
    cpu_mob = MobilenetOpenPoseRunner(params=mob_flat, device="cpu")
    hk, pk = mobilenet._apply(x256[:2])
    hc, pc = cpu_mob._apply(x256[:2].cpu())
    checks["mobilenet_heatmaps"] = agreement(hk, hc, "Mobilenet heatmaps")
    checks["mobilenet_pafs"] = agreement(pk, pc, "Mobilenet PAFs")
    out["checks"] = checks
    mob_ms = cuda_ms(lambda: mobilenet._apply(x256), reps=3, warmup=1)
    out["mobilenet_frames_per_s"] = CLIP_FRAMES / (mob_ms / 1e3)
    out["mobilenet_ms"] = mob_ms
    seg_small = D._resize(frames, SEG_WORK)
    seg_ms = cuda_ms(lambda: seg.run_probs_pre(seg_small), reps=2, warmup=1)
    out["segmenter_ms_48_frames"] = seg_ms

    # --- the native routines against their plain versions --------------------
    grid = D._resize(frames, D.WORK)
    fg = D.foreground_masks(grid, D.median_background(grid))
    masks = [D._clean(m) for m in fg]
    t0 = time.perf_counter()
    nat = [D.connected_component_boxes(m, min_area=1) for m in masks]
    nat_us = (time.perf_counter() - t0) / len(masks) * 1e6
    t0 = time.perf_counter()
    plain = [D._cc_boxes_plain(m, min_area=1) for m in masks]
    plain_us = (time.perf_counter() - t0) / len(masks) * 1e6
    for m, b in zip(masks, plain):  # every component, uncapped, against the BFS
        full = native.cc_boxes(m, max_comps=m.size)[:, :4]
        check(sorted(map(tuple, full.tolist())) == sorted(map(tuple, b.astype(np.int32).tolist())),
              "preprocess_2d: native component boxes differ from the BFS")
    out["cc_boxes_us"] = {"native": nat_us, "python_bfs": plain_us, "masks": len(masks),
                          "grid": D.WORK, "components_per_mask": float(np.mean([len(b) for b in plain]))}
    img = np.random.RandomState(9).randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
    with tempfile.TemporaryDirectory() as root:
        paeth, sub = os.path.join(root, "paeth.png"), os.path.join(root, "sub.png")
        with open(paeth, "wb") as f:
            f.write(png_paeth(img))
        t0 = time.perf_counter()
        got = vid.read_png(paeth)
        native_ms = (time.perf_counter() - t0) * 1e3
        raw, h, w, nch = vid.png_rows(paeth)
        t0 = time.perf_counter()
        rows = vid.unfilter_rows_plain(raw, h, w * nch, nch)
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(got, img) and np.array_equal(rows, img.reshape(h, -1)),
              "preprocess_2d: the native PNG decode differs from the plain loop")
        vid.write_png(sub, img)
        check(vid.png_rows(sub)[0] == vid.filter_sub_plain(img.reshape(SIZE, -1), 3),
              "preprocess_2d: native write_png rows differ from Sub filtering in Python")
    out["png_decode_ms"] = {"native": native_ms, "python_loop": plain_ms, "size": SIZE, "filter": "paeth"}
    # for the later phases: the crops, the calibrated segmenter, the raw frames they use
    return out, {"crops": crops, "seg_flat": seg_flat, "frames": frames[:PIPE_SRC + PIPE_REF].copy()}


SPIN_BATCH, SMPLIFY_FRAMES, DEFORM_FRAMES, MASK_SIZE = 32, 48, 4, 512
DEFORM_STEPS = 100  # the JAX test's 200, cut to hold the command's time
PIPE_DEFORM_STEPS = 50  # the pipeline's offset fit (its default is 500: depth cut to hold the command's time)


def natural_sequence(model, n: int, seed: int = 15):
    """`n` frames of a standing person on the host from a seed: the natural
    stance plus a shared offset and a per-frame drift on the body joints, a
    shared shape, a camera that drifts; the keypoints are their cocoplus-19
    joints plus N(0, 0.01) NDC noise, with a seeded 10 % of confidences 0.
    Returns (theta (n, 85), kps (n, 19, 2), conf (n, 19)) as tensors on the
    model's device."""
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.tools.pose3d import natural_stance_aa

    rng = np.random.RandomState(seed)
    pose = np.tile(natural_stance_aa() + 0.08 * rng.randn(72), (n, 1)) + 0.01 * rng.randn(n, 72).cumsum(0)
    pose[:, :3] = 0.0
    cam = np.stack([np.full(n, 1.3 + 0.2 * rng.rand()), 0.1 * rng.randn() + 0.002 * np.arange(n),
                    np.full(n, 0.1 * rng.randn())], axis=1)
    theta = np.concatenate([cam, pose, np.tile(0.3 * rng.randn(10), (n, 1))], axis=1).astype(np.float32)
    dev = model.v_template.device
    theta_t = torch.as_tensor(theta, device=dev)
    j2d = smpl_mod.get_details(model, theta_t)["j2d"]
    kps = j2d + torch.as_tensor(0.01 * rng.randn(*j2d.shape).astype(np.float32), device=dev)
    conf = torch.as_tensor((rng.rand(n, 19) >= 0.1).astype(np.float32), device=dev)
    return theta_t, kps, conf


def float64_model(model):
    """`model` with its float arrays in f64 (an exact reference on the CPU)."""
    fields = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "joint_regressor",
              "hands_mean")
    return model._replace(**{f: getattr(model, f).double() for f in fields},
                          chain=model.chain._replace(bottom=model.chain.bottom.double()))


def hard_silhouettes(model, theta, offsets, size: int):
    """(fim >= 0) of `theta` posed with `offsets`, rastered through K3."""
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops.rasterizer_cuda import raster_fim

    d = smpl_mod.get_details(model, theta, offsets=offsets)
    fv = rz.verts_to_faces(rz.project_verts(d["verts"], d["cam"]), model.faces).contiguous()
    return (raster_fim(fv, size).fim >= 0).float(), fv


def links_agree(got: np.ndarray, want: np.ndarray, y: np.ndarray) -> dict:
    """Cloth links on the card against the CPU: the same sources and flags;
    each target equal, or tied with the other's (the nearest vertex by y among
    vertices on one ring, which the two devices' skinning can round apart by
    an ulp): its y within 1e-6 of the other's."""
    check(got.shape == want.shape and np.array_equal(got[:, [0, 2]], want[:, [0, 2]]),
          f"preprocess_3d: cloth link sources differ card {got.shape} against CPU {want.shape}")
    differ = got[:, 1] != want[:, 1]
    gap = float(np.abs(y[got[differ, 1]] - y[want[differ, 1]]).max()) if differ.any() else 0.0
    check(gap <= 1e-6, f"preprocess_3d: cloth link targets differ beyond a tie ({gap})")
    return {"links": int(len(got)), "targets_equal": int((~differ).sum()), "tied_targets_y_gap": gap}


def preprocess_3d_phase(device, crops: np.ndarray) -> dict:
    """Preprocessing part 2 as `Preprocessor.execute` stage 1.3 and
    `digital_deform` run it: SPIN (seeded, at its published width) on the 48
    crops of `preprocess_2d` resized to 224², multi-hypothesis SMPLify from
    that theta against the keypoints of a seeded natural sequence with the
    GMM prior, the silhouette offset fit at the JAX test's settings but for
    DEFORM_STEPS steps (200 there; the pipeline phase runs PIPE_DEFORM_STEPS) against K3's
    hard silhouettes of a wider body on 4 of the fitted frames, with its IoU
    through K3, and cloth links. Then each part on the card against the CPU,
    K3 against its plain version on this phase's batches, and the times.
    Returns the line and SMPLify's 48 fitted thetas."""
    import types

    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.ops.sampling import resize_image
    from ipercore_tpu_torch.tools import deformers as dfm
    from ipercore_tpu_torch.tools import pose3d as p3
    from ipercore_tpu_torch.utils.checkpoint import seeded_flat_params

    model = smpl_mod.template_model(device=device)
    cpu_model = smpl_mod.template_model(device="cpu")
    spin_flat = seeded_flat_params(p3.SPINNet(), p3.SPIN_SEED)
    runner = p3.SPINRunner(params=spin_flat, device=device)
    prior = p3.load_gmm_prior(p3.GMM_DEFAULT_WEIGHTS, device=device)
    check(prior is not None, "preprocess_3d: the GMM pose prior is missing from the checkout")
    spin_in = resize_image(torch.as_tensor(crops, device=device), p3.HMR_IMG_SIZE, p3.HMR_IMG_SIZE)
    gt, kps, conf = natural_sequence(model, SMPLIFY_FRAMES)
    wide = torch.zeros_like(model.v_template)
    wide[:, 0] = 0.15 * model.v_template[:, 0]
    wide[:, 2] = 0.15 * model.v_template[:, 2]
    out = {"frames": SMPLIFY_FRAMES, "spin_parameters": sum(p.numel() for p in runner.net.parameters())}

    # --- the main path, launch counts set to 0 just before it ---------------
    zero_counts()
    t0 = time.perf_counter()
    theta_spin = torch.as_tensor(runner.run(spin_in, batch_size=SPIN_BATCH), device=device)
    torch.cuda.synchronize()
    out["spin_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    theta = p3.smplify_refine_multi(model, theta_spin, kps, conf, p3.SMPLifyConfig(), prior)
    torch.cuda.synchronize()
    smplify_s = time.perf_counter() - t0
    frames = theta[:DEFORM_FRAMES].contiguous()
    obs, obs_fv = hard_silhouettes(model, frames, wide, MASK_SIZE)
    info = types.SimpleNamespace(get_array={"smpls": frames.cpu().numpy(),
                                            "masks": (1.0 - obs)[..., None].cpu().numpy()}.get)
    # the fit at the JAX test's settings; the pipeline phase runs it at its defaults
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fitted = dfm.run_sil2smpl_offsets({}, info, n_steps=DEFORM_STEPS, lr=2e-3, reg=1.0, device=device)
    torch.cuda.synchronize()
    deform_s = time.perf_counter() - t0
    deform_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sil_fit, fit_fv = hard_silhouettes(model, frames, torch.as_tensor(fitted, device=device), MASK_SIZE)
    sil_zero, zero_fv = hard_silhouettes(model, frames, torch.zeros_like(wide), MASK_SIZE)
    legs_v = model.v_template.cpu().numpy()
    low = legs_v[:, 1] > 0.3
    legs = (np.nonzero(low & (legs_v[:, 0] > 0.02))[0], np.nonzero(low & (legs_v[:, 0] < -0.02))[0])
    skirt_y = float(np.random.RandomState(16).uniform(0.6, 1.0))
    links = dfm.smpl_link(model, frames[0].cpu().numpy(), skirt_y, leg_ids=legs)
    out["launches"] = read_counts()
    check(out["launches"]["raster_fim"] > 0, "preprocess_3d: K3 was not launched")

    # --- SPIN ---------------------------------------------------------------
    check(theta_spin.shape == (SMPLIFY_FRAMES, 85) and bool(torch.isfinite(theta_spin).all()),
          "preprocess_3d: SPIN theta")
    run = lambda: runner.run(spin_in, batch_size=SPIN_BATCH)
    n_batches = -(-SMPLIFY_FRAMES // SPIN_BATCH)
    ms = cuda_ms(run, reps=3, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    run()
    spin_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    by_kind = {"convolutions": 0.0, "other": 0.0}
    for us, key in kernel_times(run):
        by_kind["convolutions" if kernel_kind(key) == "convolutions" else "other"] += us / 1e3
    flops = conv_flops(runner.net, spin_in[:1]) * n_batches * SPIN_BATCH
    two = spin_in[:2]
    got, want = runner.run(two, batch_size=2), p3.SPINRunner(params=spin_flat, device="cpu").run(two.cpu(), batch_size=2)
    spin_err = float(np.abs(got - want).max())
    check(spin_err <= 1e-3 * float(np.abs(want).max()), f"preprocess_3d: SPIN card against CPU {spin_err}")
    out["spin"] = {"ms": ms, "batch": SPIN_BATCH, "padded_frames": n_batches * SPIN_BATCH,
                   "device_ms": dict(by_kind, busy=sum(by_kind.values())), "peak_memory_gib": spin_peak,
                   "host_syncs_per_batch": host_syncs(run) / n_batches,
                   "gflop_per_image": flops / (n_batches * SPIN_BATCH) / 1e9,
                   "tflop_per_s": flops / (ms / 1e3) / 1e12, "card_vs_cpu_max_abs_err": spin_err,
                   "theta_max_abs": float(np.abs(want).max())}
    out["spin_frames_per_s"] = SMPLIFY_FRAMES / (ms / 1e3)

    # --- SMPLify -------------------------------------------------------------
    cfg = p3.SMPLifyConfig()
    steps = cfg.n_iters * 2 + max(cfg.n_iters // 2, 10)
    err = lambda th: float(p3.reprojection_error(model, th, kps, conf).mean())
    e_init, e_fit, e_gt = err(theta_spin), err(theta), err(gt)
    check(bool(torch.isfinite(theta).all()) and e_fit < e_init and e_fit < 0.05,
          f"preprocess_3d: SMPLify reprojection error {e_fit} (init {e_init})")
    short = p3.SMPLifyConfig(n_iters=5)
    # syncs a step: the difference between 10 and 5 steps (set-up and the end cancel)
    syncs = [host_syncs(lambda: p3.smplify_refine(model, theta_spin, kps, conf, c, prior))
             for c in (short, p3.SMPLifyConfig(n_iters=10))]
    # the card against the CPU on 2 frames, 5 steps: from the keypoint-fit natural
    # stance within 1e-4; from the seeded SPIN theta, whose joints sit near pi where
    # the f32 objective's gradient is ill-conditioned, no further from an f64 run
    # on the CPU than twice the CPU's own f32 run is
    cpu_prior = p3.load_gmm_prior(p3.GMM_DEFAULT_WEIGHTS, device="cpu")
    model64, prior64 = float64_model(cpu_model), p3.GMMPosePrior(*[x.double() for x in cpu_prior])
    agree = {}
    for name, init in (("natural_stance", p3.keypoint_cam_init(model, kps[:2], conf[:2])),
                       ("spin", theta_spin[:2])):
        k = p3.smplify_refine(model, init, kps[:2], conf[:2], short, prior).cpu().double()
        c = p3.smplify_refine(cpu_model, init.cpu(), kps[:2].cpu(), conf[:2].cpu(), short, cpu_prior).double()
        c64 = p3.smplify_refine(model64, init.cpu().double(), kps[:2].cpu().double(), conf[:2].cpu().double(),
                                short, prior64)
        agree[name] = {"card_vs_cpu": float((k - c).abs().max()), "card_vs_cpu_f64": float((k - c64).abs().max()),
                       "cpu_f32_vs_f64": float((c - c64).abs().max())}
    check(agree["natural_stance"]["card_vs_cpu"] <= 1e-4,
          f"preprocess_3d: SMPLify card against CPU from the natural stance {agree['natural_stance']}")
    check(agree["spin"]["card_vs_cpu_f64"] <= max(1e-4, 2 * agree["spin"]["cpu_f32_vs_f64"]),
          f"preprocess_3d: SMPLify card against CPU from the SPIN theta {agree['spin']}")
    near_pi = float((np.pi - theta_spin[:, 3:75].reshape(-1, 24, 3).norm(dim=-1)).min())
    out["smplify"] = {"steps": steps, "reproj_err_init": e_init, "reproj_err_fit": e_fit,
                      "reproj_err_ground_truth": e_gt, "card_vs_cpu_5_steps": agree,
                      "spin_init_least_distance_to_pi": near_pi, "host_syncs_5_and_10_steps": syncs}
    out.update(smplify_s=smplify_s, smplify_ms_per_step=smplify_s * 1e3 / steps,
               host_syncs_per_step=(syncs[1] - syncs[0]) / 5, reproj_err={"init": e_init, "fit": e_fit})

    # --- the silhouette offset fit --------------------------------------------
    check(np.isfinite(fitted).all(), "preprocess_3d: offsets")
    iou = lambda a, b: float((a * b).sum() / (a + b - a * b).sum())
    area = lambda m: float(m.sum())
    iou_fit, iou_zero = iou(sil_fit, obs), iou(sil_zero, obs)
    a_obs, a_fit, a_zero = area(obs), area(sil_fit), area(sil_zero)
    check(iou_fit > iou_zero and a_zero < a_obs and a_zero < a_fit and abs(a_fit - a_obs) < abs(a_zero - a_obs),
          f"preprocess_3d: the fit does not move toward the observed silhouette "
          f"(IoU {iou_fit} against {iou_zero}; areas {a_fit}, {a_zero}, observed {a_obs})")
    per_step = [host_syncs(lambda: dfm.run_sil2smpl_offsets({}, info, n_steps=k, device=device)) for k in (2, 4)]
    obs_small = resize_image(obs[..., None], 128, 128)[..., 0]  # as the fit shrinks its masks
    off_t = torch.as_tensor(fitted, device=device)
    g_k = []
    for dev_model, th, ob, off in ((model, frames, obs_small, off_t),
                                   (cpu_model, frames.cpu(), obs_small.cpu(), off_t.cpu())):
        o = off.clone().requires_grad_(True)
        loss = dfm.sil_fit_loss(dev_model, th, ob, o, 1e4)
        g_k.append((float(loss.detach()), torch.autograd.grad(loss, [o])[0].cpu()))
    (lk, gk), (lc, gc) = g_k
    loss_err = abs(lk - lc) / abs(lc)
    grad_rel = float((gk - gc).norm() / gc.norm())
    check(loss_err <= 1e-5 and grad_rel <= 0.01,
          f"preprocess_3d: silhouette loss card against CPU {loss_err}, gradient {grad_rel}")
    out["deform"] = {"frames": DEFORM_FRAMES, "steps": DEFORM_STEPS, "size": 128, "mask_size": MASK_SIZE,
                     "peak_memory_gib": deform_peak, "host_syncs_per_step": (per_step[1] - per_step[0]) / 2,
                     "iou_fitted": iou_fit, "iou_unfitted": iou_zero,
                     "area_observed": a_obs, "area_fitted": a_fit, "area_unfitted": a_zero,
                     "offsets_max_abs_test_settings": float(np.abs(fitted).max()),
                     "card_vs_cpu_loss_rel_err": loss_err, "card_vs_cpu_grad_rel_l2": grad_rel}
    out.update(deform_s=deform_s, deform_ms_per_step=deform_s * 1e3 / DEFORM_STEPS, peak_memory_gib=deform_peak)
    check(deform_peak < 3.0, f"preprocess_3d: the deform fit peaked at {deform_peak} GiB")

    # --- K3 against its plain version on this phase's batches ------------------
    k3 = {}
    for name, fv in (("observed", obs_fv), ("fitted", fit_fv), ("unfitted", zero_fv)):
        got_r, ref = rc.raster_fim(fv, MASK_SIZE), rc.raster_fim_plain(fv, MASK_SIZE)
        raster_agreement(got_r.fim, ref.fim, got_r.wim, ref.wim, f"raster_fim/preprocess_3d {name}", bit_equal=True)
        k3[name] = {"N": int(fv.shape[0]), "bit_equal": True}
    out["k3"] = k3

    # --- cloth links ----------------------------------------------------------
    cpu_links = dfm.smpl_link(cpu_model, frames[0].cpu().numpy(), skirt_y, leg_ids=legs)
    y = dfm._posed_numpy(cpu_model, frames[0].cpu().numpy())["verts"][:, 1]
    out["cloth_links"] = dict(links_agree(links, cpu_links, y), skirt_y=skirt_y)
    return out, theta


# ---------------------------------------------------------------------------
# preprocessing part 3: mattes, parsing, inpainting; then the pipeline
# ---------------------------------------------------------------------------

PIPE_SRC, PIPE_REF = 8, 16  # raw frames of the pipeline's source and reference
INPAINT_CONTROL = 256


def mattes_kind(key: str) -> str:
    """`kernel_kind`, with the fused attention's kernels apart (PyTorch's
    memory-efficient attention is a CUTLASS kernel, `fmha_cutlass*`)."""
    name = key.lower()
    if "fmha" in name or "attention" in name:
        return "attention"
    return kernel_kind(key)


def device_ms_by_kind(fn) -> dict:
    kinds = {}
    for us, key in kernel_times(fn):
        k = mattes_kind(key)
        kinds[k] = kinds.get(k, 0.0) + us / 1e3
    kinds["busy"] = sum(kinds.values())
    return kinds


def peak_gib_of(fn) -> tuple:
    """(fn(), GiB that `fn` allocated at its peak above what was allocated before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


@contextlib.contextmanager
def leg_asset(model):
    """`smpl_part_info.json` with the body's leg vertices (split by x, as
    `preprocess_3d` splits them) in a temporary directory named by
    `IPERCORE_TPU_ASSETS`, for the cloth links; restored after."""
    v = model.v_template.cpu().numpy()
    low = v[:, 1] > 0.3
    legs = {"02_left_leg": {"vertex": np.nonzero(low & (v[:, 0] > 0.02))[0].tolist()},
            "03_right_leg": {"vertex": np.nonzero(low & (v[:, 0] < -0.02))[0].tolist()}}
    before = os.environ.get("IPERCORE_TPU_ASSETS")
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "smpl_part_info.json"), "w") as f:
            json.dump(legs, f)
        os.environ["IPERCORE_TPU_ASSETS"] = d
        try:
            yield
        finally:
            if before is None:
                os.environ.pop("IPERCORE_TPU_ASSETS", None)
            else:
                os.environ["IPERCORE_TPU_ASSETS"] = before


def preprocess_mattes_phase(device, clip: dict, theta: torch.Tensor) -> dict:
    """Preprocessing part 3 as `Preprocessor.execute` stages 1.4 and 1.6 and
    `digital_deform` run it, on `preprocess_2d`'s 48 crops at 512^2: the SMPL
    silhouettes of `preprocess_3d`'s 48 fits through K3 at 256^2 (the
    fallback mask); `HumanMattor.run` with the calibrated segmenter and a
    seeded `GCAMattingRefiner` at published widths (seed 8), whose contextual
    attention takes the fused route; `SchpParser` at published width (seed
    9) and `find_cloth_links_schp` on frame 0; `SuperResolutionInpaintor`
    (gated 10, refine 11, RRDBNet 23 blocks 12, control 256) on the mean
    background with the person hole at 512^2 (no SR) and on one 1080x1920
    frame (with SR). Then the fused attention against the plain one on 2
    frames of the real bottleneck, each network on the card against the CPU,
    K3 against its plain version on the silhouette batches, and the times."""
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.ops import attention as att
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.tools import deformers as dfm
    from ipercore_tpu_torch.tools import inpaintors as inp
    from ipercore_tpu_torch.tools import mattors as mt
    from ipercore_tpu_torch.tools import parsers as ps
    from ipercore_tpu_torch.tools.preprocessor import Preprocessor, background_visibility
    from ipercore_tpu_torch.utils.checkpoint import seeded_flat_params

    crops = clip["crops"]
    n = len(crops)
    theta = theta.cpu().numpy()
    model = smpl_mod.template_model(device=device)
    pre = Preprocessor(image_size=CROP_SIZE, body_model=model, device=device)
    mat_flat = seeded_flat_params(mt.GCAMattingRefiner(), mt.MATTING_SEED)
    mattor = mt.HumanMattor(seg_params=clip["seg_flat"], mat_params=mat_flat, device=device)
    check(mattor.trained and isinstance(mattor.mat, mt.GCAMattingRefiner), "preprocess_mattes: the mattor")
    parser = ps.SchpParser(device=device)
    inp_flats = {"inpaint_params": seeded_flat_params(inp.GatedInpaintor(), inp.INPAINT_SEED),
                 "refine_params": seeded_flat_params(inp.RefineInpaintor(), inp.REFINE_SEED),
                 "sr_params": seeded_flat_params(inp.RRDBNet(), inp.SR_SEED)}
    inpaintor = inp.SuperResolutionInpaintor(control_size=INPAINT_CONTROL, device=device, **inp_flats)
    check(inpaintor.trained and inpaintor.refine_trained and inpaintor.sr_trained, "preprocess_mattes: inpaintor")
    frame0 = clip["frames"][0]
    person0 = person_masks(frame0[None])[0][..., None].astype(np.float32)
    count = lambda net: sum(p.numel() for p in net.parameters())
    out = {"frames": n, "size": CROP_SIZE, "parameters": {
        "gca_refiner": count(mattor.mat), "schp": count(parser.net), "gated": count(inpaintor.net),
        "refine": count(inpaintor.refine), "rrdbnet": count(inpaintor.sr)}}

    # --- the main path, launch counts set to 0 just before it ---------------
    zero_counts()
    sil, sil_ms = once_ms(lambda: pre._smpl_silhouette(theta))
    (alpha, mask), mattes_first_ms = once_ms(lambda: mattor.run(crops, fallback_mask=sil))
    branches = dict(mattor.last_run)
    labels, schp_first_ms = once_ms(lambda: parser.parse(crops))
    vis = background_visibility(1.0 - alpha, sil, CROP_SIZE, device=device)
    acc = (crops * vis).sum(0) / np.maximum(vis.sum(0), 1e-5)
    hole = (vis.sum(0) < 0.5).astype(np.float32)
    bg, bg_first_ms = once_ms(lambda: inpaintor.run_inpainting(acc, hole))
    sr_bg, sr_first_ms = once_ms(lambda: inpaintor.run_inpainting(frame0, person0))
    with leg_asset(model):
        found, links = dfm.find_cloth_links_schp(parser, crops[0], theta[0], model)
    out["launches"] = read_counts()
    n_sil_chunks = -(-n // 16)
    check(out["launches"]["raster_fim"] == n_sil_chunks and not any(
        out["launches"][k] for k in ("raster_flows_csr", "grid_sample_nhwc", "raster_flows_table")),
        f"preprocess_mattes: launches {out['launches']}")

    check(sil.shape == (n, CROP_SIZE, CROP_SIZE, 1) and 0.01 < sil.mean() < 0.9, "preprocess_mattes: silhouettes")
    check(alpha.shape == mask.shape == sil.shape and np.isfinite(alpha).all()
          and alpha.min() >= 0 and alpha.max() <= 1, "preprocess_mattes: alpha")
    check(labels.shape == (n, CROP_SIZE, CROP_SIZE) and labels.min() >= 0 and labels.max() < ps.LIP_NUM_CLASSES,
          "preprocess_mattes: SCHP labels")
    check(bg.shape == (CROP_SIZE, CROP_SIZE, 3) and np.isfinite(bg).all() and np.abs(bg).max() <= 1.0,
          "preprocess_mattes: background")
    check(sr_bg.shape == (CLIP_H, CLIP_W, 3) and np.isfinite(sr_bg).all() and np.abs(sr_bg).max() <= 1.0,
          "preprocess_mattes: SR background")
    iou = lambda a, b: float((a * b).sum() / max(float(np.maximum(a, b).sum()), 1.0))
    out["branches"] = {"compact": branches["compact"], "use_band": branches["use_band"],
                       "sub_batch": branches["sub_batch"], "compact_share": float(np.mean(branches["compact"])),
                       "band_share": float(np.mean(branches["use_band"]))}
    out["mask_iou_with_silhouette"] = iou(mask, sil)
    out["hole_share_of_mean_background"] = float(hole.mean())
    out["cloth_links_frame0"] = {"found": bool(found), "links": int(len(links)),
                                 "skirt_dress_pixels": int(np.isin(labels[0], ps.LIP_TARGETS["skirt+dress"]).sum())}
    out["label_shares"] = np.bincount(labels.reshape(-1), minlength=ps.LIP_NUM_CLASSES).tolist()

    # --- the mattes: frames/s, device time by kind, memory, syncs ---------------
    run = lambda: mattor.run(crops, fallback_mask=sil)
    ms = cuda_ms(run, reps=2, warmup=1)
    _, peak = peak_gib_of(run)
    by_kind = device_ms_by_kind(run)
    x0 = torch.as_tensor(crops[:1], device=device)
    inp1 = torch.cat([x0, mt.generate_trimap(torch.as_tensor(mask[:1], device=device))], -1)
    hw = (CROP_SIZE // 4) ** 2
    att_flops = 2.0 * hw * hw * (9 * 128 + 128)
    gca_flops = conv_flops(mattor.mat, inp1) + att_flops
    out["mattes"] = {"ms": ms, "first_call_ms": mattes_first_ms, "chunk": 16, "sub_batch": branches["sub_batch"],
                     "device_ms": by_kind, "device_idle_share": 1 - by_kind["busy"] / ms,
                     "peak_memory_gib": peak, "estimated_bytes_per_pixel": mt.REFINER_BYTES_PER_PIXEL,
                     "budget_gib": mt.REFINER_BUDGET_BYTES / 2 ** 30,
                     "host_syncs_per_chunk": host_syncs(run) / n_sil_chunks,
                     "gca_tflop_per_frame": gca_flops / 1e12, "attention_share_of_flop": att_flops / gca_flops,
                     "silhouettes_ms": sil_ms}
    out["mattes_frames_per_s"] = n / (ms / 1e3)
    # the refiner's peak a frame (the slope between 2 and 4 frames a call), and
    # the segmenter's on the chunk of 16: what the sub-batch estimate must cover
    x16 = torch.as_tensor(crops[:16], device=device)
    inp16 = torch.cat([x16, mt.generate_trimap(torch.as_tensor(mask[:16], device=device))], -1)
    with torch.inference_mode():
        g2, g4 = (peak_gib_of(lambda k=k: mattor.mat(inp16[:k]))[1] for k in (2, 4))
        _, seg_peak = peak_gib_of(lambda: mattor.seg(x16))
    measured = (g4 - g2) / 2 * 2 ** 30 / CROP_SIZE ** 2
    out["mattes"].update(refiner_peak_gib_2_and_4_frames=[g2, g4], refiner_bytes_per_pixel=measured,
                         segmenter_peak_gib_16_frames=seg_peak)
    check(measured <= mt.REFINER_BYTES_PER_PIXEL,
          f"preprocess_mattes: the refiner takes {measured} bytes a pixel, above the estimate "
          f"{mt.REFINER_BYTES_PER_PIXEL} its sub-batch is sized by")

    # --- the fused attention against the plain one, 2 frames of the bottleneck ---
    caught = {}
    hook = mattor.mat.gca.register_forward_hook(lambda m, args, res: caught.update(f=args[0], u=args[1]))
    try:
        mattor.run(crops[:2], fallback_mask=sil[:2])
    finally:
        hook.remove()
    f, u = caught["f"], caught["u"]
    check(f.shape == (2, CROP_SIZE // 4, CROP_SIZE // 4, 128) and 0 < float(u.mean()) < 1,
          f"preprocess_mattes: the bottleneck {tuple(f.shape)}, unknown share {float(u.mean())}")
    with torch.inference_mode():
        fused, fused_peak = peak_gib_of(lambda: att.contextual_attention_fused(f, u))
        plain, plain_peak = peak_gib_of(lambda: att.contextual_attention_plain(f, u))
    err, scale = float((fused - plain).abs().max()), float(plain.abs().max())
    affinity_gib = 2 * hw * hw * 4 / 2 ** 30
    check(err <= 1e-4 * scale, f"preprocess_mattes: fused attention off the plain one by {err} (scale {scale})")
    check(fused_peak < 0.25 * affinity_gib, f"preprocess_mattes: the fused attention peaked at {fused_peak} GiB")
    with torch.inference_mode():
        att_kernels = [k for _, k in sorted(kernel_times(lambda: att.contextual_attention_fused(f, u)), reverse=True)
                       if mattes_kind(k) == "attention"]
    check(bool(att_kernels), "preprocess_mattes: no memory-efficient attention kernel ran")
    with torch.inference_mode():
        fused_ms = cuda_ms(lambda: att.contextual_attention_fused(f, u), reps=5, warmup=1)
        plain_ms = cuda_ms(lambda: att.contextual_attention_plain(f, u), reps=3, warmup=1)
    out["attention"] = {"frames": 2, "hw": hw, "c": 128, "qk_dim": 9 * 128,
                        "backend": "EFFICIENT_ATTENTION", "kernel": att_kernels[0][:90],
                        "fused_ms": fused_ms, "plain_ms": plain_ms, "fused_peak_gib": fused_peak,
                        "plain_peak_gib": plain_peak, "affinity_gib": affinity_gib,
                        "max_abs_err": err, "max_abs": scale, "unknown_share": float(u.mean()),
                        "fused_tflop_per_s": 2 * att_flops / (fused_ms / 1e3) / 1e12}

    # --- SCHP -------------------------------------------------------------------
    parse = lambda: parser.parse(crops)
    schp_ms = cuda_ms(parse, reps=2, warmup=1)
    _, schp_peak = peak_gib_of(parse)
    x473 = torch.zeros((1, ps.LIP_INPUT_SIZE, ps.LIP_INPUT_SIZE, 3), device=device)
    schp_flops = conv_flops(parser.net, x473) * n
    out["schp"] = {"ms": schp_ms, "first_call_ms": schp_first_ms, "batch": 8, "peak_memory_gib": schp_peak,
                   "gflop_per_frame": schp_flops / n / 1e9, "tflop_per_s": schp_flops / (schp_ms / 1e3) / 1e12,
                   "device_ms": device_ms_by_kind(parse)}
    out["schp_frames_per_s"] = n / (schp_ms / 1e3)

    # --- the inpaintors: wall and device ms -------------------------------------
    out["inpaint"] = {}
    for name, fn, first in (("mean_background_512", lambda: inpaintor.run_inpainting(acc, hole), bg_first_ms),
                            ("frame_1080x1920_sr", lambda: inpaintor.run_inpainting(frame0, person0), sr_first_ms)):
        _, wall = once_ms(fn)
        out["inpaint"][name] = {"wall_ms": wall, "first_call_ms": first, "device_ms": device_ms_by_kind(fn)}
    out["inpaint"]["frame_1080x1920_sr"]["rrdbnet_input"] = [INPAINT_CONTROL, INPAINT_CONTROL]

    # --- every network on the card against the CPU -----------------------------
    checks = {}
    cpu_mattor = mt.HumanMattor(seg_params=clip["seg_flat"], mat_params=mat_flat, device="cpu")
    with torch.inference_mode():
        checks["gca_refiner"] = agreement(mattor.mat(inp1), cpu_mattor.mat(inp1.cpu()), "GCA refiner",
                                          "preprocess_mattes")
    checks["segmenter"] = agreement(torch.sigmoid(mattor.segment(crops[:1])),
                                    torch.sigmoid(cpu_mattor.segment(crops[:1])), "segmenter", "preprocess_mattes")
    cpu_parser = ps.SchpParser(params=parser.params, device="cpu")
    lk, lc = parser.logits(crops[:1]), cpu_parser.logits(crops[:1])
    checks["schp_logits"] = agreement(lk, lc, "SCHP logits", "preprocess_mattes")
    checks["schp_label_agreement"] = float((lk.argmax(-1).cpu() == lc.argmax(-1)).float().mean())
    check(checks["schp_label_agreement"] >= 0.995, f"preprocess_mattes: SCHP labels {checks['schp_label_agreement']}")
    cpu_inp = inp.SuperResolutionInpaintor(control_size=INPAINT_CONTROL, device="cpu", **inp_flats)
    checks["inpaint_mean_background"] = agreement(torch.as_tensor(bg), torch.as_tensor(
        cpu_inp.run_inpainting(acc, hole)), "gated + refine inpainting", "preprocess_mattes")
    x64 = torch.as_tensor(np.random.RandomState(17).rand(1, 64, 64, 3).astype(np.float32))
    with torch.inference_mode():
        checks["rrdbnet_64"] = agreement(inpaintor.sr(x64.to(device)), cpu_inp.sr(x64), "RRDBNet", "preprocess_mattes")
    out["checks"] = checks

    # --- K3 against its plain version on the silhouette batches -----------------
    loads, k3 = [], {}
    for i in range(0, n, 16):
        d = smpl_mod.get_details(model, torch.as_tensor(theta[i:i + 16], device=device))
        fv = rz.verts_to_faces(rz.project_verts(d["verts"], d["cam"]), model.faces).contiguous()
        got, ref = rc.raster_fim(fv, 256), rc.raster_fim_plain(fv, 256)
        raster_agreement(got.fim, ref.fim, got.wim, ref.wim, f"raster_fim/silhouettes {i}", bit_equal=True)
        loads.append(rc.bin_faces_table(fv, 256, TABLE_K, with_stats=True).stats["max_tile_load"])
    k3["silhouette_batches"] = {"chunks": len(loads), "size": 256, "bit_equal": True,
                                "max_tile_load_8x128": max(loads), "jax_tile_cap": TABLE_K,
                                "jax_would_drop_faces": max(loads) > TABLE_K}
    out["k3"] = k3
    return out


def framed_spin_params(spin_flat: dict) -> dict:
    """The seeded SPIN with its camera head (`deccam`) zeroed, so that every
    frame's camera is SPIN's initial (0.9, 0, 0) and the body lies in the
    middle of the crop: the seeded head's camera puts the body outside the
    crop, where the fallback silhouettes are empty and the offset fit has no
    gradient. The pose and shape heads stay seeded."""
    framed = dict(spin_flat)
    for k in ("params/regressor/deccam/kernel", "params/regressor/deccam/bias"):
        framed[k] = np.zeros_like(spin_flat[k])
    return framed


def pipeline_k3_batches(model, infos, find_front_size: int) -> dict:
    """K3 against its plain version, bit for bit, on the batches the
    pipeline rastered: each input's written smpls in chunks of 32 at the
    find-front size (which also holds the silhouettes' chunks of 16 at
    256^2: 8 and 16 frames fit in one chunk) and in chunks of 8 at 512^2 (the
    overlay); with the densest 8x128 tile of each size."""
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc

    out = {}
    for name, size, step in (("find_front_and_silhouettes", find_front_size, 32), ("overlay", SIZE, 8)):
        loads, batches = [], 0
        for info in infos:
            smpls = info.get_array("smpls")
            for i in range(0, len(smpls), step):
                d = smpl_mod.get_details(model, torch.as_tensor(smpls[i:i + step], device=model.v_template.device))
                fv = rz.verts_to_faces(rz.project_verts(d["verts"], d["cam"]), model.faces).contiguous()
                got, ref = rc.raster_fim(fv, size), rc.raster_fim_plain(fv, size)
                raster_agreement(got.fim, ref.fim, got.wim, ref.wim, f"raster_fim/pipeline {name} {info.name} {i}",
                                 bit_equal=True)
                loads.append(rc.bin_faces_table(fv, size, TABLE_K, with_stats=True).stats["max_tile_load"])
                batches += 1
        out[name] = {"size": size, "batches": batches, "bit_equal": True, "max_tile_load_8x128": max(loads),
                     "jax_would_drop_faces": max(loads) > TABLE_K}
    return out


def pipeline_phase(device, clip: dict) -> dict:
    """A raw clip to frames, through the three stages a user runs: PNG
    folders of 8 source and 16 reference frames of the 1080x1920 clip, then
    `run_imitator(opt, device="cuda")` (preprocess: detection, crop, SPIN,
    mattes, find-front, inpainting, overlay for both inputs, the offset fit
    for the source, cut from its 500-step default to PIPE_DEFORM_STEPS; `personalize` for 4 iterations at full width;
    `imitate`), then `run_viewer` and `run_swapper` on the processed
    directories (their preprocess and personalize are skips). The seeded
    segmenter is the calibrated one, with a seeded GCA refiner, handed to the
    Preprocessor as its mattor (detection shares it), and SPIN is the seeded
    one with its camera head zeroed (`framed_spin_params`); every other
    network is what the Preprocessor builds without weight files (Body-25
    reports `trained` False, so SMPLify does not run, as in the JAX package).
    Then K3 against its plain version on the pipeline's batches."""
    from unittest import mock

    from ipercore_tpu_torch.services import options, personalization
    from ipercore_tpu_torch.services import preprocess as prep_mod
    from ipercore_tpu_torch.services import run_imitator as ri
    from ipercore_tpu_torch.services.meta_info import MetaProcess
    from ipercore_tpu_torch.services.process_info import ProcessInfo
    from ipercore_tpu_torch.services.run_swapper import run_swapper
    from ipercore_tpu_torch.services.run_viewer import run_viewer
    from ipercore_tpu_torch.tools import deformers as dfm
    from ipercore_tpu_torch.tools import mattors as mt
    from ipercore_tpu_torch.tools import pose3d as p3
    from ipercore_tpu_torch.tools.preprocessor import Preprocessor
    from ipercore_tpu_torch.utils import video as vid
    from ipercore_tpu_torch.utils.checkpoint import seeded_flat_params

    frames = clip["frames"]
    out = {"raw": {"source_frames": PIPE_SRC, "reference_frames": PIPE_REF, "size": [CLIP_H, CLIP_W]}}
    stage_s, returned = {}, {}

    def timed(module, name):
        fn = getattr(module, name)

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                returned[name] = fn(*a, **k)
                return returned[name]
            finally:
                torch.cuda.synchronize()
                stage_s[name] = time.perf_counter() - t0
        return mock.patch.object(module, name, run)

    def pred_frames(path):
        d = path if os.path.isdir(path) else os.path.dirname(path)
        names = sorted(f for f in os.listdir(d) if f.startswith("pred_"))
        return np.stack([vid.load_image(os.path.join(d, f)) for f in names])

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        for name, part in (("raw_src", frames[:PIPE_SRC]), ("raw_ref", frames[PIPE_SRC:])):
            os.makedirs(os.path.join(root, name))
            for i, f in enumerate(part):
                vid.save_image(os.path.join(root, name, f"{i:04d}.png"), f)
        out["write_raw_pngs_s"] = time.perf_counter() - t0
        opt = options.setup(None, [])
        opt.update(image_size=SIZE, num_source=NS, output_dir=root, model_id="pipeline", Generator=CFG,
                   view_frames=CHUNK, src_path=f"path?={root}/raw_src,name?=subject",
                   ref_path=f"path?={root}/raw_ref,name?=dance")
        opt.Train.update(niters_or_epochs_no_decay=SERVICE_ITERS, niters_or_epochs_decay=0)
        pre = Preprocessor(image_size=SIZE, device=device)
        pre._mattor = mt.HumanMattor(seg_params=clip["seg_flat"], device=device,
                                     mat_params=seeded_flat_params(mt.GCAMattingRefiner(), mt.MATTING_SEED))
        pre._spin = p3.SPINRunner(params=framed_spin_params(seeded_flat_params(p3.SPINNet(), p3.SPIN_SEED)),
                                  device=device)
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(prep_mod, "_preprocessor", lambda opt, device: pre))
            fit = dfm.run_sil2smpl_offsets  # the offset fit cut to PIPE_DEFORM_STEPS (default 500)
            stack.enter_context(mock.patch.object(dfm, "run_sil2smpl_offsets", lambda opt, info, **kw: fit(
                opt, info, **{"n_steps": PIPE_DEFORM_STEPS, **kw})))
            for module, name in ((prep_mod, "human_estimate"), (prep_mod, "digital_deform"),
                                 (prep_mod, "post_update_opt"), (personalization, "personalize"),
                                 (ri, "imitate")):
                stack.enter_context(timed(module, name))
            zero_counts()
            t0 = time.perf_counter()
            outputs = ri.run_imitator(opt, device=device)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            out["launches"] = read_counts()
        check(all(out["launches"][k] > 0 for k in ("raster_flows_csr", "grid_sample_nhwc", "raster_fim")),
              f"pipeline: launches {out['launches']}")

        # what the preprocessing wrote
        src = ProcessInfo.deserialize(MetaProcess("subject", root).processed_dir)
        ref = ProcessInfo.deserialize(MetaProcess("dance", root).processed_dir)
        for info, n_frames, is_src in ((src, PIPE_SRC, True), (ref, PIPE_REF, False)):
            check(info.check_has_been_processed(), f"pipeline: {info.name} is not processed")
            smpls, masks = info.get_array("smpls"), info.get_array("masks")
            check(smpls is not None and smpls.shape == (n_frames, 85) and np.isfinite(smpls).all(),
                  f"pipeline: {info.name} smpls")
            check(masks is not None and masks.shape == (n_frames, SIZE, SIZE, 1) and 0 < masks.mean() < 1,
                  f"pipeline: {info.name} masks")
            ids = np.concatenate([info.get_array("ft_ids"), info.get_array("bk_ids")])
            check(set(ids.tolist()) == set(range(n_frames)), f"pipeline: {info.name} front / back ids {ids}")
            bg = os.path.join(info.processed_dir, "background.png")
            check(os.path.exists(bg) == is_src, f"pipeline: {info.name} background.png")
        deformed = returned["digital_deform"]
        check(deformed == {"subject": "offsets" if src.get_array("links_ids") is None else "links"}
              and (src.get_array("offsets") is not None or src.get_array("links_ids") is not None),
              f"pipeline: digital_deform {deformed}")
        offsets = src.get_array("offsets")
        # the body in the frame: every source frame's SMPL silhouette holds
        # pixels, so the fit has a gradient and moves the offsets
        src_sil = pre._smpl_silhouette(src.get_array("smpls"))
        sil_share = src_sil.mean(axis=(1, 2, 3))
        src_person = (src.get_array("masks") < 0.5).astype(np.float32)
        check(bool((sil_share > 0.01).all()), f"pipeline: source silhouettes {sil_share.tolist()}")
        check(offsets is None or (np.isfinite(offsets).all() and np.abs(offsets).max() > 0),
              "pipeline: the offset fit left the offsets at 0")
        imitated = pred_frames(outputs[0])
        moved = float(np.abs(imitated[0] - imitated[-1]).max())
        check(imitated.shape == (PIPE_REF, SIZE, SIZE, 3) and np.isfinite(imitated).all()
              and np.abs(imitated).max() <= 1.0, f"pipeline: imitated frames {imitated.shape}")
        check(moved > 0.01, f"pipeline: the imitated frames do not change ({moved})")
        stages = {}
        for rep in pre.reports:
            for k, v in rep["stage_s"].items():
                stages[k] = stages.get(k, 0.0) + v
        out.update({
            "wall_s": total, "stage_s": stage_s, "human_estimate_split_s": stages,
            "per_input": [{"name": r["name"], "stage_s": r["stage_s"], "detect_method": r.get("detect_method"),
                           "matte_compact": r.get("matte", {}).get("compact"),
                           "matte_band": r.get("matte", {}).get("use_band"),
                           "refiner_sub_batch": r.get("matte", {}).get("sub_batch"),
                           "visual": os.path.relpath(r["visual"], root) if r.get("visual") else None}
                          for r in pre.reports],
            "pose2d_trained": bool(pre.pose2d.trained), "deform": deformed,
            "source_person_share": float(1.0 - src.get_array("masks").mean()),
            "source_silhouette_share": sil_share.tolist(),
            "source_mask_iou_with_silhouette": float(
                (src_sil * src_person).sum() / max(float(np.maximum(src_sil, src_person).sum()), 1.0)),
            "source_cam_mean": src.get_array("smpls")[:, :3].mean(0).tolist(),
            "offsets_max_abs": float(np.abs(offsets).max()) if offsets is not None else None,
            "num_source_after_update": int(opt.num_source),
            "output": os.path.relpath(outputs[0], root), "imitated_frames": int(imitated.shape[0]),
            "imitated_first_last_max_abs_diff": moved,
            "reference_pose_spread": float(np.abs(ref.get_array("smpls") - ref.get_array("smpls")[:1]).max()),
        })
        out["k3"] = pipeline_k3_batches(pre.body_model, (src, ref), pre.find_front_size)

        # the other two three-stage runners on the processed directories
        for name, fn, n_frames in (("run_viewer", run_viewer, CHUNK), ("run_swapper", run_swapper, PIPE_REF)):
            zero_counts()
            t0 = time.perf_counter()
            res = fn(opt, device=device)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_counts()
            got = pred_frames(res[0])
            check(got.shape == (n_frames, SIZE, SIZE, 3) and np.isfinite(got).all(),
                  f"pipeline: {name} frames {got.shape}")
            check(launches["raster_flows_csr"] > 0 and launches["grid_sample_nhwc"] > 0, f"pipeline: {name} {launches}")
            out[name] = {"wall_s": seconds, "frames": int(got.shape[0]), "launches": launches}
    return out


# ---------------------------------------------------------------------------
# phases 17-19: frame sharding, streaming synthesis, synthetic scenes
# ---------------------------------------------------------------------------

PAR_FRAMES = 13  # a count that is not a multiple of 2 or 4
STREAM_FRAMES = 32
# `scripts/train_spin.py`'s defaults: batch 16 at scene size 256 (K1 rasters
# 512^2), studio 0.35, garment 0.5, natural 0.65; no real-photo crops
SYNTH_BATCH, SYNTH_SIZE = 16, 256
SYNTH_KW = {"studio_frac": 0.35, "garment_frac": 0.5, "natural_frac": 0.65}


def sync_all(devices) -> None:
    for d in {d.index for d in devices}:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN's deterministic algorithms inside the block. Two runs of the same
    frames are bit-equal only so: some f32 algorithms the generator's
    convolutions and transposed convolutions take by default add partial sums
    in no fixed order (a run against a run of the same chunk differed by
    about 1e-6)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def batching_split(comp, gen, cache, smpls, n_shards: int, preds) -> dict:
    """Why `n_shards` shards of `smpls` (`preds`, gathered) differ from one
    unsplit call, all on `preds`' device: the geometry (SMPL LBS, K1, the
    flows) and the generator each run at the shards' batch size and at the
    whole batch's. "whole": the unsplit call's geometry and generator;
    "generator_at_shard_batch": the generator in the shards' batches on the
    whole call's geometry; "shard_geometry_at_whole_batch": the generator in
    one batch on the shards' geometry, against which the sharded frames are
    also held ("sharded_vs_shard_geometry")."""
    from ipercore_tpu_torch.models import imitator as imit
    from ipercore_tpu_torch.parallel.mesh import pad_to_multiple

    T = smpls.shape[0]
    padded, _ = pad_to_multiple(smpls, n_shards)
    per = padded.shape[0] // n_shards
    with torch.no_grad():
        w_tsf, w_Tst, w_info = imit.make_frame_inputs(comp, cache, smpls)
        parts = [imit.make_frame_inputs(comp, cache, padded[k * per:(k + 1) * per]) for k in range(n_shards)]
    s_tsf, s_Tst = (torch.cat([p[i] for p in parts])[:T] for i in (0, 1))
    s_fim, s_verts = (torch.cat([p[2][key] for p in parts])[:T] for key in ("fim", "verts"))
    flips = s_fim != w_info["fim"]  # (T, S, S)
    frames = lambda tsf, Tst: imit.generate_frames(gen, cache, tsf, Tst)[0]
    whole = frames(w_tsf, w_Tst)
    p_tsf, p_Tst = (pad_to_multiple(x, n_shards)[0] for x in (w_tsf, w_Tst))
    gen_split = torch.cat([frames(p_tsf[k * per:(k + 1) * per], p_Tst[k * per:(k + 1) * per])
                           for k in range(n_shards)])[:T]
    geo_split = frames(s_tsf, s_Tst)
    out = {"shard_frames": per, "pixels_of_another_face": int(flips.sum()),
           "frames_with_another_face": int(flips.any(-1).any(-1).sum()),
           "verts_max_diff": float((s_verts - w_info["verts"]).abs().max()),
           "inputs_max_diff_same_face": float(((s_tsf - w_tsf).abs() * ~flips[..., None]).max())}
    for name, got, want in (("generator_at_shard_batch", gen_split, whole),
                            ("shard_geometry_at_whole_batch", geo_split, whole),
                            ("sharded_vs_shard_geometry", preds, geo_split),
                            ("sharded", preds, whole)):
        d = (got - want).abs()
        out[name] = {"max_diff": float(d.max()), "values_over_2e-2": int((d > 2e-2).sum()),
                     "close_fraction": close_fraction(got, want)}
    return out


def sharded_run(comp, gen, cache, smpls, devices) -> dict:
    """One `sharded_synthesize` over `devices`: its shards held bit-equal to
    `synthesize_frames` of the same frames on `devices[0]`, then timed."""
    from ipercore_tpu_torch.models import imitator as imit
    from ipercore_tpu_torch.parallel.inference import sharded_synthesize
    from ipercore_tpu_torch.parallel.mesh import pad_to_multiple, replicate

    n_dev = len(devices)
    zero_counts()
    preds, masks = sharded_synthesize(comp, gen, cache, smpls, devices=devices)
    sync_all(devices)
    launches = read_counts()
    T = smpls.shape[0]
    check(preds.shape == (T, SIZE, SIZE, 3) and masks.shape == (T, SIZE, SIZE, 1)
          and preds.device == devices[0], f"sharded_synthesize gave {tuple(preds.shape)} on {preds.device}")
    check(bool(torch.isfinite(preds).all()), "sharded frames are not finite")
    for k in ("raster_flows_csr", "grid_sample_nhwc"):
        check(launches[k] == n_dev, f"{k} launched {launches[k]} times for {n_dev} shards")
    check(launches["raster_fim"] == 0, f"raster_fim launched {launches['raster_fim']} times")
    padded, _ = pad_to_multiple(smpls, n_dev)
    per = padded.shape[0] // n_dev
    with deterministic_convolutions():
        preds, masks = sharded_synthesize(comp, gen, cache, smpls, devices=devices)
        for k in range(n_dev):
            keep = min(per, T - k * per)  # a shard of padding alone returns nothing
            if keep <= 0:
                continue
            p, m = imit.synthesize_frames(comp, gen, cache, padded[k * per:(k + 1) * per])
            got = preds[k * per:k * per + keep]
            if not (torch.equal(got, p[:keep]) and torch.equal(masks[k * per:k * per + keep], m[:keep])):
                raise AssertionError(f"shard {k} on {devices[k]} differs from synthesize_frames of its "
                                     f"frames on {devices[0]} by {float((got - p[:keep]).abs().max())}")
    # Against one unsplit call. One shard: the main path's bar. Several: the
    # shards batch fewer frames, and SMPL's LBS then rounds the vertices a few
    # ulps otherwise, which moves pixels to another face and barycentric
    # samples of thin faces (ROADMAP Queue 3). That geometry is bounded by
    # ulps; everything else is held to the main path's bar and to JAX's
    # `assert_allclose(atol=2e-2)` of `test_parallel.py` on every value: the
    # generator in the shards' batches on the unsplit call's geometry, and the
    # sharded frames against the generator in one batch on the shards'
    # geometry. The sharded frames against the unsplit call are reported.
    whole, _ = imit.synthesize_frames(comp, gen, cache, smpls)
    split = None
    if n_dev == 1:
        close = close_fraction(preds, whole)
        check(close >= 0.995, f"sharded frames agree with one unsplit call on {close} of values, < 0.995")
    else:
        split = batching_split(comp, gen, cache, smpls, n_dev, preds)
        check(split["verts_max_diff"] <= 1e-6,
              f"SMPL vertices of {per}-frame shards differ from the unsplit batch's by {split['verts_max_diff']}")
        for part in ("generator_at_shard_batch", "sharded_vs_shard_geometry"):
            check(split[part]["values_over_2e-2"] == 0 and split[part]["close_fraction"] >= 0.995,
                  f"{part}: {split[part]}")

    sync_all(devices)
    t0 = time.perf_counter()
    for d in dict.fromkeys(devices):
        replicate((comp, gen, cache), d)
    sync_all(devices)
    copy_ms = (time.perf_counter() - t0) * 1e3
    sharded_synthesize(comp, gen, cache, smpls, devices=devices)  # warm-up
    sync_all(devices)
    t0 = time.perf_counter()
    sharded_synthesize(comp, gen, cache, smpls, devices=devices)
    sync_all(devices)
    wall = time.perf_counter() - t0
    return {"devices": [str(d) for d in devices], "frames": T, "frames_per_s": T / wall,
            "call_ms": wall * 1e3, "replica_copy_ms": copy_ms,
            "host_syncs_per_call": host_syncs(lambda: sharded_synthesize(comp, gen, cache, smpls,
                                                                         devices=devices)),
            "launches": launches,
            "launches_per_device": {k: launches[k] / n_dev
                                    for k in ("raster_flows_csr", "grid_sample_nhwc", "raster_fim")},
            "shards_bit_equal": True, "close_fraction_vs_unsplit": close_fraction(preds, whole),
            "max_abs_diff_vs_unsplit": float((preds - whole).abs().max()), "batching_split": split}


def other_device_checks(model, assets, device, other) -> dict:
    """The launch repair held directly: K1, K3 and K2 on `other`'s tensors,
    with `device` current, bit-equal to their plain versions there."""
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.ops import sampling_cuda as sc
    from ipercore_tpu_torch.ops.dispatch import force_plain

    tgt_fv, _, aux = (x.to(other) for x in geometry_inputs(model, assets, device))
    img = torch.rand((1, SIZE, SIZE, 3), device=other).expand(CHUNK, SIZE, SIZE, 3)
    with torch.cuda.device(device):
        check(torch.cuda.current_device() == device.index, "the current device is not the first")
        fim, flows = rc.raster_flows(tgt_fv, aux, SIZE)
        out = rc.raster_fim(tgt_fv, SIZE)
        grid = flows[..., 0, :]
        sampled = sc.grid_sample_nhwc(img, grid)
        torch.cuda.synchronize(other)
        with force_plain():
            fim_p, flows_p = rc.raster_flows(tgt_fv, aux, SIZE)
            out_p = rc.raster_fim(tgt_fv, SIZE)
            sampled_p = sc.grid_sample_nhwc(img, grid)
    for what, a, b in (("raster_flows fim", fim, fim_p), ("raster_flows flows", flows, flows_p),
                       ("raster_fim fim", out.fim, out_p.fim), ("raster_fim wim", out.wim, out_p.wim),
                       ("grid_sample_nhwc", sampled, sampled_p)):
        check(a.device == other and torch.equal(a, b),
              f"{what} on {other} with {device} current is not bit-equal to its plain version")
    return {"device": str(other), "current": str(device), "bit_equal": True}


def parallel_phase(ctx, device) -> dict:
    """`sharded_synthesize` over every visible card and over [cuda:0, cuda:0]
    on 13 target frames of the main path's configuration."""
    from ipercore_tpu_torch.parallel.mesh import local_devices

    comp, gen, cache = ctx["comp"], ctx["gen"], ctx["cache"]
    smpls = torch.as_tensor(ctx["smpls"][:PAR_FRAMES], device=device)
    out = {"local": sharded_run(comp, gen, cache, smpls, local_devices()),
           "cuda0_twice": sharded_run(comp, gen, cache, smpls, [device, device])}
    if torch.cuda.device_count() > 1:
        out["other_device"] = other_device_checks(comp.model, comp.assets, device, torch.device("cuda", 1))
    else:
        out["other_device"] = "not measured: one visible card"
    out["launches"] = {k: out["local"]["launches"][k] + out["cuda0_twice"]["launches"][k]
                       for k in out["local"]["launches"]}
    return out


def streaming_phase(ctx, device) -> dict:
    """`StreamingSynthesizer` over 32 frames in chunks of 8 writing PNGs,
    against `imitate_sequence` + `write_frames` on the same frames: frames/s
    with the disk, the device's idle share, and the files byte for byte."""
    from ipercore_tpu_torch.models import imitator as imit
    from ipercore_tpu_torch.parallel.streaming import StreamingSynthesizer
    from ipercore_tpu_torch.services.run_imitator import imitate_sequence, write_frames

    comp, gen, cache = ctx["comp"], ctx["gen"], ctx["cache"]
    smpls = imit.prepare_target_smpls(comp.model, cache, target_smpls(STREAM_FRAMES, 17))
    synth = StreamingSynthesizer(comp, gen, cache, chunk=CHUNK)

    def sequential(out_dir):
        os.makedirs(out_dir)
        return write_frames(imitate_sequence(comp, gen, cache, smpls, chunk=CHUNK, device=device), out_dir)

    def timed(fn, root, name):
        """(paths, frames/s, device busy ms, idle share) of a run after a warm-up run."""
        fn(os.path.join(root, name + "_warm"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = fn(os.path.join(root, name))
        torch.cuda.synchronize()
        fps = len(paths) / (time.perf_counter() - t0)
        times, wall = kernel_times_and_wall(lambda: fn(os.path.join(root, name + "_traced")))
        busy = sum(us for us, _ in times) / 1e3
        return paths, fps, busy, 1 - busy / wall, wall

    with tempfile.TemporaryDirectory() as root:
        zero_counts()
        synth.run(smpls, os.path.join(root, "first"))
        launches = read_counts()
        s_paths, s_fps, s_busy, s_idle, s_wall = timed(lambda d: synth.run(smpls, d), root, "stream")
        q_paths, q_fps, q_busy, q_idle, q_wall = timed(sequential, root, "sequence")
        with deterministic_convolutions():
            s_paths = synth.run(smpls, os.path.join(root, "stream_det"))
            q_paths = sequential(os.path.join(root, "sequence_det"))
        check([os.path.basename(p) for p in s_paths] == [os.path.basename(p) for p in q_paths]
              == [f"pred_{i:08d}.png" for i in range(STREAM_FRAMES)], "streaming: the file names differ")
        same = [open(a, "rb").read() == open(b, "rb").read() for a, b in zip(s_paths, q_paths)]
        from ipercore_tpu_torch.utils.video import read_png

        worst = max(int(np.abs(read_png(a).astype(int) - read_png(b).astype(int)).max())
                    for a, b in zip(s_paths, q_paths))
        check(all(same), f"streaming: {same.count(False)} PNG files differ from write_frames', "
                         f"by up to {worst} levels")
        png_bytes = sum(os.path.getsize(p) for p in s_paths)
    n_chunks = STREAM_FRAMES // CHUNK
    for k in ("raster_flows_csr", "grid_sample_nhwc"):
        check(launches[k] == n_chunks, f"streaming: {k} launched {launches[k]} times for {n_chunks} chunks")
    return {"frames": STREAM_FRAMES, "chunk": CHUNK, "io_workers": 4, "png_bytes": png_bytes,
            "pngs_byte_equal": True, "launches": launches,
            "streaming": {"frames_per_s_with_disk": s_fps, "device_busy_ms": s_busy,
                          "traced_wall_ms": s_wall, "device_idle_share": s_idle},
            "imitate_sequence_write_frames": {"frames_per_s_with_disk": q_fps, "device_busy_ms": q_busy,
                                              "traced_wall_ms": q_wall, "device_idle_share": q_idle}}


class RecordedDraws:
    """A `Draws` whose every draw is kept, in order."""

    def __init__(self, draws):
        self.draws, self.device, self.log = draws, draws.device, []

    def __getattr__(self, kind):
        def draw(*args, **kw):
            out = getattr(self.draws, kind)(*args, **kw)
            self.log.append(out)
            return out

        return draw


class ReplayedDraws:
    """Hands back recorded draws in order, whatever is asked."""

    def __init__(self, log, device):
        self.log, self.device, self.used = log, torch.device(device), 0

    def __getattr__(self, kind):
        def draw(*args, **kw):
            self.used += 1
            return self.log[self.used - 1]

        return draw


def synth_data_phase(device) -> dict:
    """`compose_scene` at `scripts/train_spin.py`'s defaults on the card with
    the template body: K1 on its renders bit-equal to the plain raster, the
    scene against the CPU fed the card's own draws and render, scenes/s."""
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.ops.dispatch import force_plain
    from ipercore_tpu_torch.tools import synth_data as sd

    model = smpl_mod.template_model(device=device)
    assets = load_assets(model, device=device)
    gen = torch.Generator(device=device)
    scene_of = lambda draws: sd.compose_scene(draws, model, assets, SYNTH_BATCH, SYNTH_SIZE, **SYNTH_KW)
    rec = RecordedDraws(sd.Draws(gen.manual_seed(0), device))
    zero_counts()
    scene = scene_of(rec)
    launches = read_counts()
    check(launches["raster_flows_csr"] == 1 and launches["raster_binning"] == 1
          and sum(launches.values()) == 2, f"synth_data: launches {launches}")
    for f in scene._fields:
        check(bool(torch.isfinite(getattr(scene, f)).all()), f"synth_data: {f} is not finite")
    coverage = float(scene.mask.mean())
    check(0.01 < coverage < 0.6 and float(scene.img.abs().max()) <= 1.0,
          f"synth_data: person coverage {coverage}, image max {float(scene.img.abs().max())}")

    # the render: K1 against the plain raster on the card, on this batch's bodies
    theta = scene.theta
    details = smpl_mod.get_details(model, theta)
    fim = sd.render_fim(model, theta, 2 * SYNTH_SIZE, f2uvs=assets.f2uvs, details=details)
    with force_plain():
        fim_p = sd.render_fim(model, theta, 2 * SYNTH_SIZE, f2uvs=assets.f2uvs, details=details)
    check(torch.equal(fim, fim_p), "synth_data: render_fim differs from the plain raster")

    # the rest of compose_scene on the CPU, fed the card's draws and render
    cpu_model = smpl_mod.template_model(device="cpu")
    cpu_assets = load_assets(cpu_model, device="cpu")
    replay = ReplayedDraws([d.cpu() for d in rec.log], "cpu")
    card_fim = fim.cpu()
    real_render = sd.render_fim
    sd.render_fim = lambda *a, **kw: card_fim
    try:
        cpu = sd.compose_scene(replay, cpu_model, cpu_assets, SYNTH_BATCH, SYNTH_SIZE, **SYNTH_KW)
    finally:
        sd.render_fim = real_render
    check(replay.used == len(rec.log), f"synth_data: the CPU run drew {replay.used} of {len(rec.log)}")
    # Every value of every field within 1e-5 of the field's largest value, but
    # for one case: where the posterization's round((img + 1) / 2 * q) sits on
    # a rounding boundary, the card's and the CPU's `pow` (the gamma just
    # before it) differ in the last bit and round one step 2/q apart. Those
    # image values must lie in a posterized scene, be at most one step apart
    # and be rare. q and the posterization's coin are `photo_augment`'s 4th
    # and 3rd draws from the end (then vignette, noise). `errors` is each
    # field's largest difference over the largest value, for the image over
    # the values that are not one step apart.
    q, posterized = rec.log[-4].cpu().double(), rec.log[-3].cpu() < 0.4
    errors, steps = {}, 0
    for f in scene._fields:
        a, b = getattr(scene, f).cpu().double(), getattr(cpu, f).double()
        d, scale = (a - b).abs(), max(float(b.abs().max()), 1e-30)
        off = d > 1e-5 * scale
        if f == "img":
            stepped = off & posterized.expand_as(d) & (d <= (2.0 / q).expand_as(d) + 1e-5 * scale)
            check(not bool((off & ~stepped).any()) and int(stepped.sum()) <= 1e-4 * d.numel(),
                  f"synth_data: {int(off.sum())} image values differ from the CPU's by more than "
                  f"1e-5 of the largest, {int((off & ~stepped).sum())} of them not one "
                  f"posterization step apart")
            steps, d = int(stepped.sum()), d[~stepped]
        else:
            check(not bool(off.any()), f"synth_data: {int(off.sum())} values of {f} differ from the "
                                       f"CPU's by up to {float(d.max()) / scale} of the largest, > 1e-5")
        errors[f] = float(d.max()) / scale

    ms = cuda_ms(lambda: scene_of(sd.Draws(gen, device)), reps=5, warmup=1)
    return {"batch": SYNTH_BATCH, "scene_size": SYNTH_SIZE, "render_size": 2 * SYNTH_SIZE, **SYNTH_KW,
            "draws": len(rec.log), "launches": launches, "render_fim_bit_equal": True,
            "card_vs_cpu_max_err_of_largest": errors,
            "card_vs_cpu_img_values_one_posterization_step_apart": steps, "person_coverage": coverage,
            "texture_bank_images": int(sd._texture_bank().shape[0]),
            "scene_batch_ms": ms, "scenes_per_s": SYNTH_BATCH / (ms / 1e3),
            "host_syncs_per_batch": host_syncs(lambda: scene_of(sd.Draws(gen, device)))}


# ---------------------------------------------------------------------------
# perception_train: the six training drivers of `ipercore_tpu_torch/scripts/`
# at their published defaults, K1 (and K3 in the generator's) on every batch
# ---------------------------------------------------------------------------

PT_WARMUP, PT_STEPS = 1, 3
PT_CPU_ROWS = 2  # rows of a card batch that the CPU's step takes (1 for the generator's)
# the JAX drivers' published defaults: batch per step, scene sizes
PT_BATCH = {"vgg": 8, "faceloss": 12, "spin": 16, "openpose": 8, "person_seg": 8, "lwg_pretrain": 2}
PT_SCENE, PT_FACE_SCENE = 256, 192


@contextlib.contextmanager
def captured_rasters():
    """Within the block every K1 / K3 call of the trainers is kept with its
    inputs and outputs; the kernels launch (and count) as usual."""
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.scripts import train_person_seg
    from ipercore_tpu_torch.tools import synth_data as sd

    from ipercore_tpu_torch.ops import rasterizer as rz

    from ipercore_tpu_torch.models import imitator as imit

    # K3 is reached through `rasterizer.rasterize_batch` (the composition's
    # `render_fim_wim`), which calls `rasterizer_cuda.raster_fim` itself, so
    # the wrapper and its launch count stay as they are; K1 and K2 also
    # through the names the imitator imported
    calls, k1, k3, k2 = [], rc.raster_flows, rz.rasterize_batch, imit.grid_sample_nhwc

    def flows(fv, aux, size, *a, **kw):
        out = k1(fv, aux, size, *a, **kw)
        calls.append(("raster_flows_csr", fv, aux, size, out))
        return out

    def fim(fv, size, *a, **kw):
        out = k3(fv, size, *a, **kw)
        calls.append(("raster_fim", fv, None, size, out))
        return out

    def sample(imgs, grids, *a, **kw):
        out = k2(imgs, grids, *a, **kw)
        calls.append(("grid_sample_nhwc", imgs, grids, None, (out if out is not None else kw["out"]).clone()))
        return out

    saved = (sd.raster_flows, train_person_seg.raster_flows, imit.raster_flows, rz.rasterize_batch,
             imit.grid_sample_nhwc)
    sd.raster_flows = train_person_seg.raster_flows = imit.raster_flows = flows
    rz.rasterize_batch, imit.grid_sample_nhwc = fim, sample
    try:
        yield calls
    finally:
        (sd.raster_flows, train_person_seg.raster_flows, imit.raster_flows, rz.rasterize_batch,
         imit.grid_sample_nhwc) = saved


def rasters_bit_equal(calls, what: str) -> dict:
    """Each kept K1 / K3 (and K2) call against its plain version on the same
    inputs, bit for bit: {kernel: calls checked}."""
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.ops.sampling_cuda import grid_sample_plain

    seen, done = {}, []

    def same(a, b):
        return a is b or (a is not None and b is not None and a.shape == b.shape and torch.equal(a, b))

    for name, fv, aux, size, out in calls:
        # a call on the inputs of one already held: its outputs must be that call's
        twin = next((c for c in done if c[0] == name and c[3] == size and same(c[1], fv) and same(c[2], aux)), None)
        if twin is not None:
            a, b = (out, twin[4]) if name != "raster_fim" else ((out.fim, out.wim), (twin[4].fim, twin[4].wim))
            check(all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) else torch.equal(a, b),
                  f"{what}: {name} differs between two calls on the same inputs")
        elif name == "grid_sample_nhwc":  # (imgs, grids) in the raster's slots
            check(torch.equal(out, grid_sample_plain(fv, aux).to(out.dtype)), f"{what}: K2 differs from its plain version")
        elif name == "raster_flows_csr":
            ref = rc.raster_flows_plain(fv, aux, size)
            raster_agreement(out[0], ref[0], out[1], ref[1], f"{what}: K1", bit_equal=True)
        else:
            ref = rc.raster_fim_plain(fv, size)
            raster_agreement(out.fim, ref.fim, out.wim, ref.wim, f"{what}: K3", bit_equal=True)
        if twin is None:
            done.append((name, fv, aux, size, out))
        seen[name] = seen.get(name, 0) + 1
    return seen


def to_device(x, device):
    """Tensors of a nested tuple / dict / NamedTuple moved to `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    if isinstance(x, tuple):
        return tuple(to_device(v, device) for v in x)
    return x


def rows_of(batch, n: int):
    """The first n rows of every tensor of a batch (tuple or dict)."""
    if isinstance(batch, dict):
        return {k: v[:n] for k, v in batch.items()}
    return tuple(v[:n] if v.dim() > 1 else v for v in batch)


def card_vs_cpu(net, loss_of, batch, what: str) -> dict:
    """One step's loss and gradients on the card against the CPU from the
    same parameters and batch rows: loss within 1e-4 relative, gradients
    within 1 % (L2 over all parameters)."""
    import copy

    from ipercore_tpu_torch.models.imitator import reference_precision
    from ipercore_tpu_torch.scripts import _common as cm

    with reference_precision():
        lc = loss_of(net, batch)[0]
        gc = cm.grads_of(net, lc)
    net_cpu = copy.deepcopy(net).cpu()
    lp = loss_of(net_cpu, to_device(batch, "cpu"))[0]
    gp = cm.grads_of(net_cpu, lp)
    g1 = torch.cat([gc[k].detach().reshape(-1).cpu() for k in gp]).double()
    g2 = torch.cat([gp[k].detach().reshape(-1) for k in gp]).double()
    out = {"rows": int(next(iter(batch.values() if isinstance(batch, dict) else batch)).shape[0]),
           "loss_card": float(lc), "loss_cpu": float(lp),
           "loss_rel_diff": abs(float(lc) - float(lp)) / max(abs(float(lp)), 1e-12),
           "grad_l2_rel": float((g1 - g2).norm() / g2.norm())}
    check(out["loss_rel_diff"] <= 1e-4 and out["grad_l2_rel"] <= 1e-2, f"{what}: card vs CPU {out}")
    return out


def timed_trainer(what: str, iterate, make, rows: int, hand_written: bool = True) -> dict:
    """Warm-up, then PT_STEPS iterations (batch + step) by CUDA events; the
    batch alone (`make`); peak memory, host syncs and device time by kind of
    kernel (profiler) of one iteration."""
    for _ in range(PT_WARMUP):
        iterate()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(PT_STEPS):
        loss, aux = iterate()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / PT_STEPS
    (loss, aux), peak = peak_gib_of(iterate)
    losses = {"loss": float(loss), **{k: float(v) for k, v in aux.items()}}
    check(all(np.isfinite(v) for v in losses.values()), f"{what}: losses not finite {losses}")
    kinds = device_breakdown(iterate, hand_written)
    busy = {k: v for k, v in kinds.items() if k != "top"}
    return {"step_ms": step_ms, "batch_ms": cuda_ms(make, reps=PT_STEPS, warmup=0),
            "scenes_per_s": rows / (step_ms / 1e3), "peak_memory_gib": peak,
            "host_syncs_per_step": host_syncs(iterate), "device_ms_per_step": busy,
            "device_idle_share": 1 - busy["busy"] / step_ms, "device_top_kernels": kinds["top"][:4],
            "losses": losses}


def moved(before: dict, after: dict) -> float:
    return max(float((after[k].detach() - before[k]).abs().max()) for k in before)


def saved_loads(module, save, device) -> dict:
    """The trainer's file, written and loaded strictly by its consumer."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, module.WEIGHTS_NAME)
        save(path)
        consumer = module.consumer(path, device)
        return {"file": module.WEIGHTS_NAME, "bytes": os.path.getsize(path),
                "consumer": type(consumer).__name__, "loads_strictly": True}


def simple_trainer(what: str, module, net, tx, make, loss_of, rows: int, device, step_kw=None,
                   frames: int = None, save=None) -> dict:
    """The run of a trainer whose state is one module and its Adam state:
    first iteration (launches, K1 bit-equal on its renders), timing, moved
    parameters, card against CPU, the saved file in its consumer."""
    from ipercore_tpu_torch.scripts import _common as cm

    opt = [cm.init_state(tx, net)]
    before = {k: v.detach().clone() for k, v in net.named_parameters()}

    def step(batch):
        opt[0], loss, aux = module.train_step(net, tx, opt[0], batch, **(step_kw or {}))
        return loss, aux

    launches = read_counts()
    with captured_rasters() as calls:
        step(make())
    launches = {k: v - launches[k] for k, v in read_counts().items()}
    bit_equal = rasters_bit_equal(calls, what)
    check(launches["raster_flows_csr"] >= 1 and bit_equal.get("raster_flows_csr") == launches["raster_flows_csr"],
          f"{what}: K1 launches {launches}, checked {bit_equal}")
    out = {"launches_per_step": launches, "bit_equal_calls": bit_equal,
           **timed_trainer(what, lambda: step(make()), make, frames or rows)}
    out["param_max_move"] = moved(before, dict(net.named_parameters()))
    check(out["param_max_move"] > 0, f"{what}: the parameters did not move")
    out["card_vs_cpu"] = card_vs_cpu(net, loss_of, rows_of(make(), PT_CPU_ROWS), what)
    out["saved"] = saved_loads(module, save or (lambda p: module.save(p, net)), device)
    return out


def perception_train_phase(device) -> dict:
    """The six trainers at the JAX drivers' published defaults, each from a
    CUDA generator and seeded weights on the template body."""
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.scripts import _common as cm
    from ipercore_tpu_torch.scripts import (train_faceloss, train_lwg_pretrain, train_openpose,
                                            train_person_seg, train_spin, train_vgg)
    from ipercore_tpu_torch.tools import synth_data as sd

    t0 = time.perf_counter()
    model = smpl_mod.template_model(device=device)
    assets = load_assets(model, device=device)
    cpu_model = smpl_mod.template_model(device="cpu")
    draws = lambda seed: sd.Draws(torch.Generator(device=device).manual_seed(seed), device)
    out = {}
    zero_counts()
    B, S = PT_BATCH, PT_SCENE
    # VGG perceptual: batch 8 at 256² (K1 at 512²)
    d = draws(42)
    out["vgg"] = simple_trainer("perception_train vgg", train_vgg, train_vgg.build(S, device), cm.adam(2e-4),
                                lambda: train_vgg.make_batch(d, model, assets, B["vgg"], S),
                                train_vgg.loss_fn, B["vgg"], device)
    # face: 12 identities, two views at 192² (K1 at 384²)
    d, n_batch = draws(555), [0]

    def face_batch():
        n_batch[0] += 1
        return train_faceloss.make_batch(d, lambda: draws(10_000 + n_batch[0]), model, assets,
                                         B["faceloss"], PT_FACE_SCENE)

    out["faceloss"] = simple_trainer("perception_train faceloss", train_faceloss, train_faceloss.build(device),
                                     cm.adam(1e-4, clip=1.0), face_batch, train_faceloss.loss_fn, B["faceloss"],
                                     device, frames=2 * B["faceloss"])
    # SPIN: batch 16 at 256² resized to 224, batch norm statistics frozen
    d = draws(123)
    net = train_spin.build(device)
    stats = {k: v.detach().clone() for k, v in net.named_parameters() if k in train_spin.frozen_stats(net)}
    models = {"cuda": model, "cpu": cpu_model}
    out["spin"] = simple_trainer(
        "perception_train spin", train_spin, net, train_spin.optimizer(net, 3e-4),
        lambda: train_spin.make_batch(d, model, assets, B["spin"], S, studio_frac=0.35, garment_frac=0.5,
                                      natural_frac=0.65),
        lambda m, b: train_spin.loss_fn(m, b, models[b[0].device.type]), B["spin"], device,
        step_kw={"model": model})
    params = dict(net.named_parameters())
    check(all(torch.equal(params[k], v) for k, v in stats.items()), "perception_train spin: statistics moved")
    out["spin"]["frozen_statistics"] = len(stats)
    out["spin"]["statistics_bit_unchanged"] = True
    # Body-25: batch 8 at 256² resized to 224, motion blur 0.5
    d, r = draws(321), train_openpose.Recipe(scene_size=S)
    net = train_openpose.build(device)
    out["openpose"] = simple_trainer("perception_train openpose", train_openpose, net, cm.adam(2e-4, clip=1.0),
                                     lambda: train_openpose.make_batch(d, model, assets, B["openpose"], r),
                                     train_openpose.loss_fn, B["openpose"], device,
                                     save=lambda p: train_openpose.save(p, net, r.input_size))
    # person segmenter + matting refiner: batch 8 at 256², K1 called directly at 512²
    d = draws(7)
    nets = train_person_seg.build(device)
    out["person_seg"] = simple_trainer("perception_train person_seg", train_person_seg, nets, cm.adam(2e-4),
                                       lambda: train_person_seg.make_batch(d, model, assets, B["person_seg"], S),
                                       lambda m, b: train_person_seg.loss_fn(m.pair(), b), B["person_seg"], device)
    out["lwg_pretrain"] = lwg_pretrain_run(model, assets, cpu_model, draws(1234), device)
    # every launch of the phase: each trainer's iterations, and the batches
    # of its card-vs-CPU check
    out["launches"] = read_counts()
    out["seconds"] = time.perf_counter() - t0
    return out


def lwg_pretrain_run(model, assets, cpu_model, d, device) -> dict:
    """The generator's pretraining step at the driver's defaults (batch 2
    identities of 2 sources + 2 targets at 256², AttLWB-SPADE at published
    width, `patch_global_body_head`, VGG19, Sphere20a, aug-bg, bf16 autocast):
    K1 on its renders and K3 in its composition bit-equal, timing, and one
    f32 step on the card against the CPU on the first identity."""
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.scripts import train_lwg_pretrain as L
    from ipercore_tpu_torch.trainers import lwg_trainer as T

    what = "perception_train lwg_pretrain"
    B, S = PT_BATCH["lwg_pretrain"], PT_SCENE
    rig = L.Rig(model, assets, S, device)
    state = [rig.state()]
    start = state[0].params_G

    def make():
        return L.make_identity_batch(d, model, assets, B, S)

    def iterate():
        state[0], metrics = L.train_step(rig, state[0], make())
        return metrics["g_total"], metrics

    launches = read_counts()
    with captured_rasters() as calls:
        iterate()
    launches = {k: v - launches[k] for k, v in read_counts().items()}
    bit_equal = rasters_bit_equal(calls, what)
    check(launches["raster_flows_csr"] == 1 == bit_equal.get("raster_flows_csr")
          and launches["raster_fim"] == 2 == bit_equal.get("raster_fim"),
          f"{what}: launches {launches}, checked {bit_equal}")
    out = {"launches_per_step": launches, "bit_equal_calls": bit_equal, "compute_dtype": rig.cfg.compute_dtype,
           **timed_trainer(what, iterate, make, 4 * B)}
    out["param_max_move"] = moved(start, state[0].params_G)
    check(out["param_max_move"] > 0 and int(state[0].opt_G.count) == int(state[0].step),
          f"{what}: G did not move or a step was skipped")

    # one f32 step from the same state on the first identity, card and CPU, both
    # on the card's composition: SMPL's LBS rounds a vertex by an ulp otherwise
    # on the CPU, which moves silhouette pixels and the D term by ~1e-3 (the
    # composition's own kernel, K3, is held bit-equal above)
    batch = rows_of(make(), 1)
    f32 = rig.cfg._replace(compute_dtype="float32")
    ns, m = 2, batch["masks"]
    with torch.no_grad():
        composed = T.fc.forward(rig.comp, batch["images"][:, :ns], batch["images"][:, ns:],
                                batch["smpls"][:, :ns], batch["smpls"][:, ns:], src_mask=m[:, :ns],
                                ref_mask=m[:, ns:])
    cpu_rig = L.Rig(cpu_model, load_assets(cpu_model, device="cpu"), S, "cpu", "float32")
    forward = T.fc.forward
    try:
        T.fc.forward = lambda *a, **k: composed
        card_state, card_m = T.train_step(state[0], batch, rig.comp, rig.gen, rig.dis, rig.vgg, rig.face, f32)
        T.fc.forward = lambda *a, **k: to_device(composed, "cpu")
        cpu_state, cpu_m = T.train_step(to_device(state[0], "cpu"), to_device(batch, "cpu"), cpu_rig.comp,
                                        cpu_rig.gen, cpu_rig.dis, cpu_rig.vgg, cpu_rig.face, f32)
    finally:
        T.fc.forward = forward
    rel = {k: abs(float(card_m[k]) - float(cpu_m[k])) / max(abs(float(cpu_m[k])), 1e-6) for k in cpu_m}
    check(max(rel.values()) <= 1e-4, f"{what}: card vs CPU losses {rel}")
    out["card_vs_cpu"] = {"rows": 1, "loss_rel_diff": rel,
                          "state": state_agreement(to_device(card_state, "cpu"), cpu_state, f32.lr_g,
                                                   f"{what} card vs CPU")}
    out["saved"] = saved_loads(L, lambda p: L.save(p, rig, state[0].params_G), device)
    return out


# ---------------------------------------------------------------------------
# drivers: the last drivers of `ipercore_tpu_torch/scripts/` (the SCHP,
# inpaintor and ESRGAN trainers, the GMM prior fit, the perception check, the
# pseudo-labellers, the dataset view and the accuracy-cost ladder)
# ---------------------------------------------------------------------------

DRV_FRAMES = 12  # clip frames the pseudo-labellers read (JAX: the 160 before its held-out band)
DRV_THETA_ITERS = 50  # SMPLify steps of `pseudo_label_theta` (its default 150)
# the trainers at the JAX drivers' published defaults: batch, scene or control size, pool
DRV_SCHP, DRV_INPAINT, DRV_ESRGAN = (4, 256, 48), (8, 256, 64), (4, 192, 0)
DRV_VERIFY_ARGS: list = []  # `verify_perception` at its defaults (8 frames at 256²)
DRV_VISUAL_SIZE = 256  # `visual_processed_data`'s default --image_size


def pool_rendered(what: str, render) -> tuple:
    """(pool, {seconds, K1 launches, bit-equal calls}) of a trainer's pool,
    every K1 call of it held bit-equal to the plain raster."""
    launches = read_counts()
    with captured_rasters() as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool = render()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {k: v - launches[k] for k, v in read_counts().items()}
    bit_equal = rasters_bit_equal(calls, what)
    check(launches["raster_flows_csr"] >= 1 and bit_equal.get("raster_flows_csr") == launches["raster_flows_csr"],
          f"{what}: pool K1 launches {launches}, checked {bit_equal}")
    return pool, {"pool_s": seconds, "pool_shape": list(pool.shape), "pool_k1_launches": launches["raster_flows_csr"],
                  "pool_bit_equal_calls": bit_equal}


def driver_trainer(what: str, step, make, loss_of, net, rows: int, k1_per_step: int) -> dict:
    """A trainer's step (`step(batch)` -> (loss, aux)): its launches on the
    first iteration (each K1 held bit-equal), the timing of `timed_trainer`,
    moved parameters and the step on the card against the CPU."""
    t0 = time.perf_counter()
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    launches = read_counts()
    with captured_rasters() as calls:
        step(make())
    launches = {k: v - launches[k] for k, v in read_counts().items()}
    bit_equal = rasters_bit_equal(calls, what)
    check(launches["raster_flows_csr"] == k1_per_step == bit_equal.get("raster_flows_csr", 0)
          and launches["raster_fim"] == 0, f"{what}: launches {launches}, checked {bit_equal}")
    out = {"launches_per_step": launches, "bit_equal_calls": bit_equal,
           **timed_trainer(what, lambda: step(make()), make, rows, hand_written=k1_per_step > 0)}
    out["param_max_move"] = moved(before, dict(net.named_parameters()))
    check(out["param_max_move"] > 0, f"{what}: the parameters did not move")
    t1 = time.perf_counter()
    out["card_vs_cpu"] = card_vs_cpu(net, loss_of, rows_of(make(), PT_CPU_ROWS), what)
    out["card_vs_cpu"]["seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


def reloads(save, load, name: str) -> dict:
    """A trainer's file (`name`, as the driver names it) written, then loaded
    strictly by its consumer."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, name)
        t0 = time.perf_counter()
        save(path)
        t1 = time.perf_counter()
        consumer = load(path)
        return {"bytes": os.path.getsize(path), "consumer": type(consumer).__name__, "loads_strictly": True,
                "save_s": t1 - t0, "load_s": time.perf_counter() - t1}


def attention_routes(nets, batch) -> dict:
    """Stage 2's loss and the refinement's gradient through the fused
    contextual attention (one memory-efficient SDPA, backward included)
    against the plain two-product route on the same card, and the
    attention kernels the profiler sees in one fused step."""
    from ipercore_tpu_torch.models.imitator import reference_precision
    from ipercore_tpu_torch.ops.dispatch import force_plain
    from ipercore_tpu_torch.scripts import _common as cm
    from ipercore_tpu_torch.scripts import train_inpaintor as T

    def loss_grad():
        with reference_precision():
            loss = T.loss_fn(nets, batch)[0]
            g = cm.grads_of(nets.net, loss)
        return float(loss), torch.cat([v.reshape(-1) for v in g.values()]).double()

    (lf, gf), peak_fused = peak_gib_of(loss_grad)
    with force_plain():
        (lp, gp), peak_plain = peak_gib_of(loss_grad)
    out = {"route": "fused: scaled_dot_product_attention, EFFICIENT_ATTENTION (forward and backward)",
           "q_k_shape": [int(batch[0].shape[0]), 1, (batch[0].shape[1] // 4) ** 2, 9 * 4 * 48],
           "loss_rel_diff": abs(lf - lp) / max(abs(lp), 1e-12),
           "grad_l2_rel": float((gf - gp).norm() / gp.norm()),
           "peak_gib_fused": peak_fused, "peak_gib_plain": peak_plain,
           "fused_ms": cuda_ms(loss_grad, reps=3, warmup=1)}
    with force_plain():
        out["plain_ms"] = cuda_ms(loss_grad, reps=3, warmup=1)
    attn = [(us, key) for us, key in kernel_times(loss_grad) if "fmha" in key.lower() or "attention" in key.lower()]
    out["attention_kernels"] = [{"us": us, "kernel": key[:80]} for us, key in sorted(attn, reverse=True)[:4]]
    check(out["loss_rel_diff"] <= 1e-5 and out["grad_l2_rel"] <= 1e-4, f"drivers inpaintor stage 2: routes {out}")
    check(any("fmha" in a["kernel"].lower() for a in out["attention_kernels"]),
          f"drivers inpaintor stage 2: no fused attention kernel in the step {out['attention_kernels']}")
    return out


def trainers_run(device) -> dict:
    """The SCHP, inpaintor (both stages) and ESRGAN trainers at the JAX
    drivers' published defaults, from CUDA generators and seeded weights on
    the template body."""
    import types

    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.scripts import _common as cm
    from ipercore_tpu_torch.scripts import train_esrgan as E
    from ipercore_tpu_torch.scripts import train_inpaintor as T
    from ipercore_tpu_torch.scripts import train_schp as P
    from ipercore_tpu_torch.tools import synth_data as sd

    t0 = time.perf_counter()
    model = smpl_mod.template_model(device=device)
    assets = load_assets(model, device=device)
    draws = lambda seed: sd.Draws(torch.Generator(device=device).manual_seed(seed), device)
    out = {"body_s": time.perf_counter() - t0}

    # SCHP: a pool of 48 part maps at 256² (K1), batch 4
    B, S, N = DRV_SCHP
    pool, pool_info = pool_rendered("drivers schp", lambda: P.render_pool(draws(606), model, assets, N, B, S))
    net, tx, d = P.build(device), cm.adam(3e-4, clip=1.0), draws(404)
    state = [cm.init_state(tx, net)]

    def schp_step(batch):
        state[0], loss, aux = P.train_step(net, tx, state[0], batch)
        return loss, aux

    out["schp"] = {**pool_info, **driver_trainer("drivers schp", schp_step, lambda: P.make_batch(d, pool, B, S),
                                                  P.loss_fn, net, B, k1_per_step=0)}
    out["schp"]["saved"] = reloads(lambda p: P.save(p, net), lambda p: P.consumer(p, device), P.WEIGHTS_NAME)

    # the inpaintor, stage 1: a pool of 64 dilated silhouettes at control 256² (K1), batch 8
    B, S, N = DRV_INPAINT
    pool, pool_info = pool_rendered("drivers inpaintor", lambda: T.render_pool(draws(101), model, assets, N, B, S))
    d = draws(55)
    make = lambda: T.make_batch(d, pool, B, S)
    with tempfile.TemporaryDirectory() as tmp:
        stage1 = os.path.join(tmp, T.WEIGHTS_NAME)
        for stage in (1, 2):
            nets = T.build(device, stage, stage1)
            tx = cm.adam(2e-4, clip=1.0)
            state = [cm.init_state(tx, nets.net)]

            def inpaint_step(batch, nets=nets, tx=tx, state=state):
                state[0], loss, aux = T.train_step(nets, tx, state[0], batch)
                return loss, aux

            coarse_cpu = copy.deepcopy(nets.coarse).cpu() if stage == 2 else None
            by_device = {"cuda": nets.coarse, "cpu": coarse_cpu}
            loss_of = lambda m, b, stage=stage, by_device=by_device: T.loss_fn(
                types.SimpleNamespace(stage=stage, net=m, coarse=by_device[b[0].device.type]), b)
            key = f"inpaintor_stage{stage}"
            out[key] = {**pool_info, **driver_trainer(f"drivers {key}", inpaint_step, make, loss_of, nets.net, B,
                                                         k1_per_step=0)}
            if stage == 2:
                t0 = time.perf_counter()
                out[key]["attention"] = attention_routes(nets, make())
                out[key]["attention"]["seconds"] = time.perf_counter() - t0
                out[key]["saved"] = reloads(lambda p: T.save(p, nets), lambda p: T.consumer(p, device, 2, stage1),
                                            T.REFINE_WEIGHTS_NAME)
            else:
                T.save(stage1, nets)  # stage 2 trains on these weights
                out[key]["saved"] = reloads(lambda p: T.save(p, nets), lambda p: T.consumer(p, device),
                                            T.WEIGHTS_NAME)

    # ESRGAN: fresh scenes at 192² (K1 at 384²) each batch, batch 4
    B, S, _ = DRV_ESRGAN
    net, tx, d = E.build(device), cm.adam(2e-4, clip=1.0), draws(77)
    state = [cm.init_state(tx, net)]

    def esrgan_step(batch):
        state[0], loss, aux = E.train_step(net, tx, state[0], batch)
        return loss, aux

    get = lambda dr: E.render_scenes(dr, model, assets, B, S)
    out["esrgan"] = driver_trainer("drivers esrgan", esrgan_step, lambda: E.make_batch(d, get, B, S), E.loss_fn, net,
                                   B, k1_per_step=1)
    out["esrgan"]["saved"] = reloads(lambda p: E.save(p, net), lambda p: E.consumer(p, device), E.WEIGHTS_NAME)
    return out


def accuracy_run(device) -> dict:
    """`accuracy_cost` at its defaults (512², 8 frames, full width, the six
    configurations): the golden frames under cuDNN's deterministic
    algorithms, each shortcut's SSIM / PSNR / mean |delta| against them, and
    every K1 / K2 / K3 call bit-equal to its plain version."""
    from ipercore_tpu_torch.scripts.evaluate import accuracy_cost as A

    zero_counts()
    with captured_rasters() as calls:
        t0 = time.perf_counter()
        comp, gens, cache = A.build(SIZE, False, device)
        tgt = torch.as_tensor(A.golden_sequence(SIZE, NS, CHUNK)[2], device=device)
        with deterministic_convolutions():
            golden = A.run_configs(comp, gens, cache, tgt)[A.CONFIGS[0][0]]
        frames = A.run_configs(comp, gens, cache, tgt)
        frames[A.CONFIGS[0][0]] = golden
        rows = A.score(frames, device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = read_counts()
    bit_equal = rasters_bit_equal(calls, "drivers accuracy_cost")
    for k in ("raster_flows_csr", "grid_sample_nhwc", "raster_fim"):
        check(launches[k] >= 1 and bit_equal.get(k) == launches[k], f"drivers accuracy_cost: {k} {launches} {bit_equal}")
    check(np.isfinite(golden).all() and golden.shape == (CHUNK, SIZE, SIZE, 3), "drivers accuracy_cost: golden frames")
    for r in rows:
        check(np.isfinite([r["ssim_vs_golden"], r["mean_abs_delta"]]).all() and r["ssim_vs_golden"] > 0.9,
              f"drivers accuracy_cost: {r}")
    return {"seconds": seconds, "rows": rows, "launches": launches, "bit_equal_calls": bit_equal}


def perception_check_run(device) -> dict:
    """`verify_perception` at its defaults (8 frames at 256² on the template
    body) with the seeded networks (no weight file in the checkout): each
    `*_trained` flag, K1 on the render and K3 on the re-render bit-equal."""
    from ipercore_tpu_torch.scripts import verify_perception as V

    zero_counts()
    with captured_rasters() as calls:
        t0 = time.perf_counter()
        result = V.main(DRV_VERIFY_ARGS + ["--device", str(device)])
        seconds = time.perf_counter() - t0
    launches = read_counts()
    bit_equal = rasters_bit_equal(calls, "drivers verify_perception")
    for k in ("raster_flows_csr", "raster_fim"):
        check(launches[k] >= 1 and bit_equal.get(k) == launches[k], f"drivers verify_perception: {k} {launches}")
    check(np.isfinite([result["j2d_px_256_spin"], result["bg_l1"]]).all(), f"drivers verify_perception: {result}")
    return {"seconds": seconds, "result": result, "launches": launches, "bit_equal_calls": bit_equal}


def gmm_run(device) -> dict:
    """`fit_gmm_prior` at its defaults (16384 poses, 8 components) into a
    temporary directory; the fit read back by `load_gmm_prior` on the card
    and on the CPU, and the mean NLL of the driver's hold-out poses on each."""
    from ipercore_tpu_torch.scripts import fit_gmm_prior as G
    from ipercore_tpu_torch.tools.pose3d import GMM_DEFAULT_WEIGHTS, gmm_prior_nll, load_gmm_prior
    from ipercore_tpu_torch.tools.synth_data import Draws, natural_pose

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, os.path.basename(GMM_DEFAULT_WEIGHTS))
        t0 = time.perf_counter()
        result = G.main(["--out", path, "--device", str(device)])
        seconds = time.perf_counter() - t0
        prior, cpu_prior = load_gmm_prior(path, device=device), load_gmm_prior(path, device="cpu")
    hold = natural_pose(Draws(torch.Generator(device=device).manual_seed(99), device), 256)[:, 3:]
    nll = {"card": float(gmm_prior_nll(prior, hold).mean()), "cpu": float(gmm_prior_nll(cpu_prior, hold.cpu()).mean())}
    check(prior.means.shape == (8, 69) and bool(torch.isfinite(prior.precisions).all())
          and abs(nll["card"] - nll["cpu"]) <= 1e-4 * abs(nll["cpu"])
          and abs(nll["card"] - result["nll_natural_holdout"]) <= 0.01, f"drivers fit_gmm_prior: {result} {nll}")
    return {"seconds": seconds, **{k: v for k, v in result.items() if k != "out"}, "holdout_nll": nll}


def pseudo_pool(device, n: int = 8, size: int = 320) -> dict:
    """A pose pseudo-label pool in `pseudo_label_pose`'s layout from drawn
    scenes (K1) with their exact Body-25 keypoints, for `pseudo_label_theta`."""
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.tools import synth_data as sd

    model = smpl_mod.template_model(device=device)
    sb = sd.compose_scene(sd.Draws(torch.Generator(device=device).manual_seed(31), device), model,
                          load_assets(model, device=device), n, size, yaw=False, natural_frac=1.0)
    b25, valid = sd.body25_from_cocoplus(sb.j2d)
    vis = (b25.abs() < 0.98).all(-1).cpu().numpy() & (valid[None] > 0)
    return {"crops": sb.img.cpu().numpy().astype(np.float16), "kps_ndc": b25.cpu().numpy().astype(np.float32),
            "valid": vis.astype(np.float32), "frames": np.arange(n)}


def pseudo_labels_run(device, clip: dict) -> dict:
    """The three pseudo-labellers on DRV_FRAMES 1080x1920 frames of the
    preprocessing clip's person walking across the whole width (so that the
    clip's median is its background), written as PNGs into a temporary
    `FRAME_DIR`: the calibrated segmenter, the seeded Body-25 (at its 320²
    scale) and the seeded SPIN with its camera head zeroed, as weight files in
    the same directory; theta on a drawn pool with exact keypoints."""
    from unittest import mock

    from ipercore_tpu_torch.scripts import eval_real_photos as real
    from ipercore_tpu_torch.scripts import pseudo_label_pose, pseudo_label_seg, pseudo_label_theta
    from ipercore_tpu_torch.tools import mattors as mt
    from ipercore_tpu_torch.tools import pose2d as p2
    from ipercore_tpu_torch.tools import pose3d as p3
    from ipercore_tpu_torch.utils import video as vid
    from ipercore_tpu_torch.utils.checkpoint import seeded_flat_params

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        frame_dir = os.path.join(tmp, "real_frames")
        os.makedirs(frame_dir)
        t0 = time.perf_counter()
        frames = person_clip(device, n=DRV_FRAMES, x_from=0.1, x_to=0.9)
        for i, f in enumerate(frames):
            vid.save_image(os.path.join(frame_dir, f"akun_{i:04d}.png"), f)
        out["write_pngs_s"] = time.perf_counter() - t0
        # the three weight files, each where its runner looks by default, under its own file name
        defaults = {"person_seg": (mt, "DEFAULT_WEIGHTS"), "openpose": (p2, "OPENPOSE_DEFAULT_WEIGHTS"),
                    "spin": (p3, "SPIN_DEFAULT_WEIGHTS")}
        weights = {"person_seg": {**{f"seg/{k}": v for k, v in clip["seg_flat"].items()},
                                  **{f"mat/{k}": v for k, v in seeded_flat_params(mt.MattingRefiner(),
                                                                                  mt.MATTING_SEED).items()}},
                   "openpose": {**seeded_flat_params(p2.OpenPoseBody25(), p2.OPENPOSE_SEED),
                                "__meta__/input_size": np.asarray(POSE_TRAINED_SIZE)},
                   "spin": framed_spin_params(seeded_flat_params(p3.SPINNet(), p3.SPIN_SEED))}
        patches = [(real, "FRAME_DIR", frame_dir), (pseudo_label_pose, "VAL_BAND_START", DRV_FRAMES),
                   (pseudo_label_seg, "VAL_BAND_START", DRV_FRAMES), (mt, "GCA_WEIGHTS", os.path.join(tmp, "no_gca"))]
        for name, (module, attr) in defaults.items():  # uncompressed: the loaders read either
            path = os.path.join(tmp, os.path.basename(getattr(module, attr)))
            with open(path, "wb") as f:
                np.savez(f, **weights[name])
            patches.append((module, attr, path))
        # the files the three drivers write, named as they name them
        names = {"pose": os.path.basename(pseudo_label_theta.IN_NPZ),
                 "seg": os.path.basename(pseudo_label_seg.OUT), "theta": os.path.basename(pseudo_label_theta.OUT_NPZ)}
        labels = os.path.join(tmp, "labels")
        pool_path = os.path.join(tmp, "pool", names["pose"])
        os.makedirs(os.path.dirname(pool_path))
        with open(pool_path, "wb") as f:
            np.savez_compressed(f, **pseudo_pool(device))
        with contextlib.ExitStack() as stack:
            for module, attr, value in patches:
                stack.enter_context(mock.patch.object(module, attr, value))
            for name, run, argv in (("pose", pseudo_label_pose.main, []), ("seg", pseudo_label_seg.main, []),
                                    ("theta", pseudo_label_theta.main, ["--in_npz", pool_path,
                                                                        "--iters", str(DRV_THETA_ITERS)])):
                zero_counts()
                t0 = time.perf_counter()
                stats = run(argv + ["--out", os.path.join(labels, names[name]), "--device", str(device)])
                torch.cuda.synchronize()
                out[name] = {"seconds": time.perf_counter() - t0, "stats": stats, "launches": read_counts()}
        wrote = {k: os.path.exists(os.path.join(labels, n)) for k, n in names.items()}
        out["wrote"] = wrote
        check(out["pose"]["stats"]["n_frames"] == DRV_FRAMES and out["seg"]["stats"]["n_frames"] == DRV_FRAMES,
              f"drivers pseudo-labels: {out}")
        check(out["seg"]["stats"]["kept"] > 0 and wrote["seg"], f"drivers pseudo_label_seg kept nothing: {out['seg']}")
        frac = out["seg"]["stats"]["mean_mask_frac"]
        check(0.02 < frac < 0.5, f"drivers pseudo_label_seg masks cover {frac}")
        out["seg"]["clip_person_frac"] = float(person_masks(frames).mean())
        check(out["theta"]["stats"]["n"] == 8 and np.isfinite(out["theta"]["stats"]["err_mean"]),
              f"drivers pseudo_label_theta: {out['theta']}")
    return out


def visual_run(device) -> dict:
    """`visual_processed_data` on a processed directory of 6 frames at 256²
    (its default size): the grids written, K3 bit-equal on its batches."""
    from ipercore_tpu_torch.scripts import visual_processed_data as VP
    from ipercore_tpu_torch.utils import video as vid

    with tempfile.TemporaryDirectory() as root:
        write_processed(root, "clip", 6, seed=3, masks=True)
        grids = os.path.join(root, "grids")
        zero_counts()
        with captured_rasters() as calls:
            t0 = time.perf_counter()
            rc = VP.main(["--dataset_dir", root, "--out_dir", grids, "--num_batches", "2",
                          "--image_size", str(DRV_VISUAL_SIZE), "--device", str(device)])
            seconds = time.perf_counter() - t0
        launches = read_counts()
        bit_equal = rasters_bit_equal(calls, "drivers visual_processed_data")
        names = sorted(os.listdir(grids))
        img = vid.load_image(os.path.join(grids, names[0]))
    check(rc == 0 and names == ["batch_000.png", "batch_001.png"] and img.shape == (DRV_VISUAL_SIZE, 5 * DRV_VISUAL_SIZE, 3)
          and img.std() > 0, f"drivers visual_processed_data: {rc} {names} {img.shape}")
    check(launches["raster_fim"] >= 4 and bit_equal.get("raster_fim") == launches["raster_fim"],
          f"drivers visual_processed_data: K3 {launches} {bit_equal}")
    return {"seconds": seconds, "grids": names, "launches": launches, "bit_equal_calls": bit_equal}


def drivers_phase(device, clip: dict) -> dict:
    """The drivers of the last slice on the card, each with the launch counts
    set to 0 before it (`launches` sums the phase)."""
    from ipercore_tpu_torch.scripts.evaluate import self_imitation

    t0 = time.perf_counter()
    zero_counts()
    total = {k: 0 for k in counters()}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    out = {}
    zero_counts()
    t1 = time.perf_counter()
    out["trainers"] = trainers_run(device)
    out["trainers"]["seconds"] = time.perf_counter() - t1
    add(read_counts())
    out["accuracy_cost"] = accuracy_run(device)
    add(out["accuracy_cost"]["launches"])
    out["verify_perception"] = perception_check_run(device)
    add(out["verify_perception"]["launches"])
    zero_counts()
    out["fit_gmm_prior"] = gmm_run(device)
    add(read_counts())
    t1 = time.perf_counter()
    out["pseudo_labels"] = pseudo_labels_run(device, clip)
    out["pseudo_labels"]["seconds"] = time.perf_counter() - t1
    for k in ("pose", "seg", "theta"):
        add(out["pseudo_labels"][k]["launches"])
    out["visual_processed_data"] = visual_run(device)
    add(out["visual_processed_data"]["launches"])
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()) as said:
        rc = self_imitation.main(["--out_dir", tmp, "--device", str(device)])
    out["self_imitation"] = {"rc": rc, "said": said.getvalue().strip()}
    check(rc == 1 and "no sample clip" in said.getvalue(), f"drivers self_imitation: {out['self_imitation']}")
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t0
    return out


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
    emit("build", seconds=time.perf_counter() - t0, sources=list(cuda_build.SOURCES + cuda_build.HOST_SOURCES))

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
    parallel = parallel_phase(ctx, device)
    emit("parallel", **parallel)
    streaming = streaming_phase(ctx, device)
    emit("streaming", **streaming)
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
    pre, clip = preprocess_phase(device)
    emit("preprocess_2d", **pre)
    pre3, theta = preprocess_3d_phase(device, clip["crops"])
    emit("preprocess_3d", **pre3)
    mattes = preprocess_mattes_phase(device, clip, theta)
    emit("preprocess_mattes", **mattes)
    pipe = pipeline_phase(device, clip)
    emit("pipeline", **pipe)
    synth = synth_data_phase(device)
    emit("synth_data", **synth)
    trainers = perception_train_phase(device)
    emit("perception_train", **trainers)
    drivers = drivers_phase(device, clip)
    emit("drivers", **drivers)

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
    for name in kernels:  # preprocessing part 1 runs none of the four; parts 2 and 3 run K3
        kernels[name]["launches_preprocess_2d"] = pre["launches"][name]
        kernels[name]["launches_preprocess_3d"] = pre3["launches"][name]
        kernels[name]["launches_preprocess_mattes"] = mattes["launches"][name]
        kernels[name]["launches_pipeline"] = pipe["launches"][name]
        kernels[name]["launches_parallel"] = parallel["launches"][name]
        kernels[name]["launches_streaming"] = streaming["launches"][name]
        kernels[name]["launches_synth_data"] = synth["launches"][name]
        kernels[name]["launches_perception_train"] = trainers["launches"][name]
        kernels[name]["launches_drivers"] = drivers["launches"][name]
    emit("timing", phase_s=dict(PHASE_S), command_s=time.perf_counter() - T_START)
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
