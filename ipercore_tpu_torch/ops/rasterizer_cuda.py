"""Hopper raster kernels: wrappers, tile binning and plain versions.

`raster_flows` replaces the Pallas TPU kernel `_raster_flow_kernel_csr`
(`ipercore_tpu/ops/rasterizer_pallas.py`, entry `rasterize_flows_pallas_csr`);
`raster_fim` replaces `_raster_kernel` (entry `rasterize_pallas` /
`rasterize_pallas_batch`). Their device code is `csrc/raster.cu` (the walk and
the epilogue), fed by the device binning of `csrc/raster_bin.cu`; see the
headers there for the design and for what bounds it on an H100.
`raster_flows_table` replaces `_raster_flow_kernel` (entry
`rasterize_flows_pallas`), the fixed-capacity variant that keeps the JAX
package's 8x128 tiles and nearest-first tables; its device code is
`csrc/raster_table.cu`, fed by the device binning of
`csrc/raster_table_bin.cu`, and its section below says why the tile stays.

Binning of K1 and K3 (`prepare_raster`). Each valid face's box, padded by
2 px, touches an inclusive range of 16x16 tiles. A face whose range holds at
most `E_CAP` tiles is listed in each of them; a larger face goes onto its
frame's wide list, which every tile of the frame walks as well. The buffers
have static sizes, as in the JAX package (`entries_per_face` = 16), but
nothing is truncated: T*F*E_CAP tile entries, T*F wide ids. On a CUDA tensor
the binning is three kernels with no host sync and no sort; a tile's list is
then in no fixed order, which the walk's winner rule (smallest depth, then
lowest face id) does not see. On a CPU tensor `prepare_raster_plain` builds
the same layout with PyTorch (lists by face id). The `with_stats` contract is
kept (`max_span`, `total_entries`, `max_tile_load`, `n_overflow_tiles` = 0,
and now `listed_entries`, `wide_faces`); the stats stay on the device and are
read, in one sync, only when a caller asks for them.

A wrapper runs its plain version only for a CPU tensor (or inside
`dispatch.force_plain()`); for a CUDA tensor it launches the kernel or raises,
on that tensor's device and its current stream (`dispatch.kernel_stream`),
whichever device is current. Each wrapper counts its launches in the
registry of `utils.logging.count`: `k1.launches` (`raster_flows`),
`k3.launches` (`raster_fim`), `k4.launches` (`raster_flows_table`),
`raster_binning.launches` (`prepare_raster`) and `table_binning.launches`
(`prepare_table`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ipercore_tpu_torch.ops import rasterizer as rz
from ipercore_tpu_torch.ops.dispatch import kernel_stream, use_kernel
from ipercore_tpu_torch.utils import cuda_build
from ipercore_tpu_torch.utils.logging import count

# must equal TILE, E_CAP, ITEM in csrc/raster_common.cuh
TILE = 16  # pixels per tile side
E_CAP = 16  # tile entries one face may write before it goes onto the wide list
ITEM = 64  # list entries per work item of the walk
ZBUF_FRAMES = 8  # frames per pass through the walk's z-buffer
_BIN_MARGIN_PX = 2.0  # bbox guard is 1 px; one more absorbs rounding in to_px
STAT_KEYS = ("max_span", "total_entries", "listed_entries", "max_tile_load", "wide_faces")


def _check_constants(lib: ctypes.CDLL, fn: str) -> None:
    got = (ctypes.c_int * 5)()
    getattr(lib, fn)(got)
    if tuple(got) != (TILE, E_CAP, ITEM, 16, len(STAT_KEYS)):
        raise RuntimeError(f"csrc/raster_common.cuh and rasterizer_cuda.py disagree: {tuple(got)}")


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("raster")
    if not getattr(lib, "_ipercore_ready", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.raster_constants.argtypes = [p]
        lib.raster_flows_launch.argtypes = [p] * 8 + [ll, i, i, i, i, p, i, p, p, p]
        lib.raster_flows_launch.restype = i
        lib.raster_fim_launch.argtypes = [p] * 7 + [i, i, i, p, i, p, p, p]
        lib.raster_fim_launch.restype = i
        _check_constants(lib, "raster_constants")
        lib._ipercore_ready = True
    return lib


def _bin_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("raster_bin")
    if not getattr(lib, "_ipercore_ready", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.raster_bin_constants.argtypes = [p]
        lib.raster_bin_launch.argtypes = [p, i, i, i] + [p] * 9
        lib.raster_bin_launch.restype = i
        _check_constants(lib, "raster_bin_constants")
        lib._ipercore_ready = True
    return lib


def face_geometry(face_verts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-face kernel rows [M 9 | z 3 | bbox 4] and validity.

    face_verts: (T, F, 3, 3) -> geom (T, F, 16) f32 contiguous, valid (T, F).
    """
    M, valid = rz._face_bary_matrices(face_verts)
    geom = torch.cat([M.reshape(M.shape[:-2] + (9,)), face_verts[..., 2],
                      rz._face_bbox(face_verts)], dim=-1)
    return geom.contiguous(), valid


def _bin_entries(tx0: torch.Tensor, tx1: torch.Tensor, ty0: torch.Tensor, ty1: torch.Tensor,
                 valid: torch.Tensor, gx: int, n_tiles: int,
                 key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (tile, face) entry for every tile in each valid face's inclusive
    tile range, sorted by global tile and then by `key`.

    Args:
        tx0, tx1, ty0, ty1: (T, F) int64 tile ranges; valid: (T, F) bool;
        gx: tiles per row; n_tiles: tiles per frame;
        key: (T, F) int64 order of the faces inside a tile, unique per frame
            and in [0, F).

    Returns:
        tiles (E,) global tile `frame * n_tiles + tile` of every entry, sorted;
        keys (E,) the entries' keys; seg (T * n_tiles + 1,) segment starts;
        span (T * F,) entries per face. One host sync sizes the entries.
    """
    T, F = key.shape
    dev = key.device
    ntx = (tx1 - tx0 + 1).reshape(-1)
    span = torch.where(valid.reshape(-1), ntx * (ty1 - ty0 + 1).reshape(-1), torch.zeros_like(ntx))
    ends = torch.cumsum(span, 0)
    total = int(ends[-1]) if ends.numel() else 0  # host sync: sizes the arrays below
    face = torch.repeat_interleave(torch.arange(T * F, device=dev), span, output_size=total)
    e = torch.arange(total, device=dev) - (ends - span)[face]
    dy = e // ntx[face]
    dx = e - dy * ntx[face]
    frame = face // F
    tile = frame * n_tiles + (ty0.reshape(-1)[face] + dy) * gx + tx0.reshape(-1)[face] + dx
    sorted_key, _ = torch.sort(tile * F + key.reshape(-1)[face])
    tiles = sorted_key // F
    seg = torch.searchsorted(tiles, torch.arange(T * n_tiles + 1, device=dev))
    return tiles, sorted_key - tiles * F, seg, span


def _tile_ranges(face_verts: torch.Tensor, size: int) -> tuple[torch.Tensor, ...]:
    """Inclusive 16x16 tile ranges (tx0, tx1, ty0, ty1), each (T, F) int64, of
    the faces' boxes padded by 2 px, in f32 as `csrc/raster_bin.cu` computes
    them: floor(((v + 1) * S/2 - 0.5 -+ 2) / 16), clipped to the grid."""
    g = (size + TILE - 1) // TILE

    def one_axis(v):
        lo = (v.amin(-1) + 1.0) * (size * 0.5) - 0.5 - _BIN_MARGIN_PX
        hi = (v.amax(-1) + 1.0) * (size * 0.5) - 0.5 + _BIN_MARGIN_PX
        return (torch.floor(lo / TILE).clamp(0, g - 1).long(),
                torch.floor(hi / TILE).clamp(0, g - 1).long())

    return one_axis(face_verts[..., 0]) + one_axis(face_verts[..., 1])


def _check_faces(face_verts: torch.Tensor) -> None:
    if face_verts.dim() != 4 or face_verts.shape[-2:] != (3, 3):
        raise ValueError(f"face_verts must be (T, F, 3, 3), got {tuple(face_verts.shape)}")
    if face_verts.dtype != torch.float32:
        raise TypeError(f"face_verts must be float32, got {face_verts.dtype}")


class RasterPlan(NamedTuple):
    """The binning of T frames into 16x16 tiles, n_tiles = g*g, g = ceil(S/16).

    geom: (T, F, 16) f32 face rows [M 9 | z 3 | bbox 4];
    counts: (T * n_tiles,) int32 faces listed per tile;
    seg: (T * n_tiles,) int32 start of each tile's list in `ids`; frame f's
        lists lie in its region [f*F*E_CAP, (f+1)*F*E_CAP);
    ids: (T * F * E_CAP,) int32; tile k's list is ids[seg[k] : seg[k] + counts[k]]
        (by face id from the plain version, in no fixed order from the
        kernel); the other slots are unspecified;
    wide_ids: (T, F) int32, frame f's wide list in its first wide_count[f]
        slots (likewise ordered or not);
    wide_count: (T,) int32 faces whose padded box spans more than E_CAP
        tiles; every tile of the frame walks them too;
    items: (T, n_tiles + 1) int32 first work item of each tile and, last, the
        frame's item count: tile t has ceil((counts + wide_count) / ITEM) items;
    stats: (5,) int32 on the device, in the order of STAT_KEYS
        (`plan_stats` reads them).
    """

    geom: torch.Tensor
    counts: torch.Tensor
    seg: torch.Tensor
    ids: torch.Tensor
    wide_ids: torch.Tensor
    wide_count: torch.Tensor
    items: torch.Tensor
    stats: torch.Tensor


def plan_stats(plan: RasterPlan) -> dict:
    """The binning stats as python ints: one host sync."""
    return dict(zip(STAT_KEYS, plan.stats.tolist()), n_overflow_tiles=0)


def prepare_raster_plain(face_verts: torch.Tensor, size: int) -> RasterPlan:
    """Plain version of `prepare_raster`: the same layout from the exact
    sort-based binning, lists and wide lists by face id. Runs on the tensor's
    device; one host sync sizes the entries."""
    T, F = face_verts.shape[0], face_verts.shape[1]
    dev = face_verts.device
    g = (size + TILE - 1) // TILE
    n_tiles = g * g
    geom, valid = face_geometry(face_verts)
    tx0, tx1, ty0, ty1 = _tile_ranges(face_verts, size)
    span = torch.where(valid, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), torch.zeros_like(tx0))
    wide = span > E_CAP
    face_id = torch.arange(F, device=dev).expand(T, F)
    tiles, fids, seg_exact, _ = _bin_entries(tx0, tx1, ty0, ty1, valid & ~wide, g, n_tiles, face_id)
    counts = (seg_exact[1:] - seg_exact[:-1]).reshape(T, n_tiles)
    seg = torch.arange(T, device=dev)[:, None] * (F * E_CAP) + torch.cumsum(counts, 1) - counts
    ids = torch.full((T * F * E_CAP,), -1, dtype=torch.int32, device=dev)
    slot = seg.reshape(-1)[tiles] + torch.arange(tiles.numel(), device=dev) - seg_exact[tiles]
    ids[slot] = fids.to(torch.int32)
    wide_count = wide.sum(1)
    wide_ids = torch.sort(torch.where(wide, face_id, F), dim=1).values
    wide_ids = torch.where(wide_ids < F, wide_ids, -1)
    load = counts + wide_count[:, None]
    items = torch.cat([torch.zeros_like(load[:, :1]), torch.cumsum((load + ITEM - 1) // ITEM, 1)], 1)
    stats = (torch.stack([span.max(), span.sum(), counts.sum(), load.max(), wide_count.sum()])
             if span.numel() else torch.zeros(len(STAT_KEYS), dtype=torch.int64, device=dev))
    i32 = lambda a: a.to(torch.int32).contiguous()
    return RasterPlan(geom, i32(counts.reshape(-1)), i32(seg.reshape(-1)), ids, i32(wide_ids),
                      i32(wide_count), i32(items), i32(stats))


def prepare_raster(face_verts: torch.Tensor, size: int) -> RasterPlan:
    """Everything before the walk: face geometry and tile binning. On a CUDA
    tensor three kernels of `csrc/raster_bin.cu`, no host sync; on a CPU
    tensor the plain version."""
    _check_faces(face_verts)
    if not use_kernel(face_verts):
        return prepare_raster_plain(face_verts, size)
    face_verts = face_verts.contiguous()
    T, F = face_verts.shape[0], face_verts.shape[1]
    if T * F * E_CAP >= 2 ** 31:
        raise ValueError(f"T*F*E_CAP = {T * F * E_CAP} entries do not fit int32 offsets")
    g = (size + TILE - 1) // TILE
    n_tiles = g * g
    dev = face_verts.device
    sizes = (T * F * 4, T * n_tiles + 2 * T + len(STAT_KEYS), T * n_tiles, T * n_tiles,
             T * (n_tiles + 1), T * F * E_CAP, T * F)
    with kernel_stream(face_verts) as stream:
        geom = torch.empty((T, F, 16), dtype=torch.float32, device=dev)
        # frange first: its int4 rows need the buffer's 16-byte alignment
        frange, zeroed, seg, cursor, items, ids, wide_ids = torch.split(
            torch.empty(sum(sizes), dtype=torch.int32, device=dev), sizes)
        err = _bin_lib().raster_bin_launch(
            face_verts.data_ptr(), T, F, size, geom.data_ptr(), frange.data_ptr(),
            zeroed.data_ptr(), seg.data_ptr(), cursor.data_ptr(), items.data_ptr(), ids.data_ptr(),
            wide_ids.data_ptr(), stream)
    cuda_build.check_launch(err, "raster binning")
    count("raster_binning.launches")
    n_counts = T * n_tiles
    return RasterPlan(geom, zeroed[:n_counts], seg, ids, wide_ids.view(T, F),
                      zeroed[n_counts:n_counts + T], items.view(T, n_tiles + 1),
                      zeroed[-len(STAT_KEYS):])


def _zbuf(T: int, size: int, device) -> tuple[torch.Tensor, int]:
    """The walk's scratch: a z-buffer of min(T, ZBUF_FRAMES) frames of 64-bit
    keys, then one work counter per frame."""
    frames = max(1, min(T, ZBUF_FRAMES))
    return torch.empty(frames * (size * size + 1), dtype=torch.int64, device=device), frames


def _plan_ptrs(plan: RasterPlan) -> tuple[int, ...]:
    return tuple(a.data_ptr() for a in (plan.geom, plan.counts, plan.seg, plan.items, plan.ids,
                                        plan.wide_ids, plan.wide_count))


# --------------------------------------------------------------------------
# K1: fused raster + flows
# --------------------------------------------------------------------------

def raster_flows_plain(face_verts: torch.Tensor, aux_pts: torch.Tensor, size: int,
                       chunk: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `raster_flows`: `rasterize` + `cal_bc_transform`."""
    T = face_verts.shape[0]
    per_frame = aux_pts.dim() == 5
    fims, flows = [], []
    for t in range(T):
        out = rz.rasterize(face_verts[t], size, chunk)
        aux = aux_pts[t] if per_frame else aux_pts  # (J, F, 3, 2)
        J = aux.shape[0]
        fl = rz.cal_bc_transform(aux, out.fim[None].expand(J, size, size),
                                 out.wim[None].expand(J, size, size, 3))  # (J, S, S, 2)
        fims.append(out.fim)
        flows.append(fl.permute(1, 2, 0, 3))
    return torch.stack(fims), torch.stack(flows)


def raster_flows(face_verts: torch.Tensor, aux_pts: torch.Tensor, size: int,
                 with_stats: bool = False, chunk: int | None = None):
    """Batched rasterize + flows: the imitator's per-frame-batch geometry op.

    Args:
        face_verts: (T, F, 3, 3) f32 projected target-pose faces.
        aux_pts: (J, F, 3, 2) f32 per-flow-set source coordinates shared by
            the batch, or (T, J, F, 3, 2) when they vary per frame.
        size: image size S (any positive size).
        chunk: face chunk of the plain version (CPU tensors only).

    Returns:
        fim (T, S, S) int32 (-1 background), flows (T, S, S, J, 2) f32
        (FLOW_SENTINEL on background) [, stats].
    """
    _check_faces(face_verts)
    T, F = face_verts.shape[0], face_verts.shape[1]
    if aux_pts.dtype != torch.float32 or aux_pts.device != face_verts.device:
        raise TypeError("aux_pts must be float32 on the device of face_verts")
    if aux_pts.dim() not in (4, 5):
        raise ValueError(f"aux_pts must have 4 or 5 dims, got {aux_pts.dim()}")
    per_frame = aux_pts.dim() == 5
    want = (T, aux_pts.shape[1], F, 3, 2) if per_frame else (aux_pts.shape[0], F, 3, 2)
    if tuple(aux_pts.shape) != want:
        raise ValueError(f"aux_pts must be (J, F, 3, 2) or (T, J, F, 3, 2) with T={T}, "
                         f"F={F}; got {tuple(aux_pts.shape)}")
    J = want[-4]

    if not use_kernel(face_verts):
        fim, flows = raster_flows_plain(face_verts, aux_pts, size, chunk)
        if with_stats:
            return fim, flows, plan_stats(prepare_raster(face_verts, size))
        return fim, flows

    plan = prepare_raster(face_verts, size)
    fim, flows = launch_raster_flows(plan, aux_pts.contiguous(), T, F, size, J, per_frame)
    if with_stats:
        return fim, flows, plan_stats(plan)
    return fim, flows


def launch_raster_flows(plan: RasterPlan, aux: torch.Tensor, T: int, F: int, size: int,
                        J: int, per_frame: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the outputs and launch the walk and the flow epilogue (the one
    place where they are launched and counted). `aux` must be contiguous f32
    on the GPU."""
    dev = plan.geom.device
    with kernel_stream(plan.geom, aux) as stream:
        fim = torch.empty((T, size, size), dtype=torch.int32, device=dev)
        flows = torch.empty((T, size, size, J, 2), dtype=torch.float32, device=dev)
        zbuf, zb_frames = _zbuf(T, size, dev)
        err = _lib().raster_flows_launch(
            *_plan_ptrs(plan), aux.data_ptr(), J * F * 6 if per_frame else 0, T, F, size, J,
            zbuf.data_ptr(), zb_frames, fim.data_ptr(), flows.data_ptr(), stream)
    cuda_build.check_launch(err, "raster_flows")
    count("k1.launches")
    return fim, flows


# --------------------------------------------------------------------------
# K3: face-index map + barycentric weight map
# --------------------------------------------------------------------------

def raster_fim_plain(face_verts: torch.Tensor, size: int,
                     chunk: int | None = None) -> rz.RasterOutput:
    """Plain version of `raster_fim`: `rasterize` frame by frame."""
    outs = [rz.rasterize(fv, size, chunk) for fv in face_verts]
    return rz.RasterOutput(fim=torch.stack([o.fim for o in outs]),
                           wim=torch.stack([o.wim for o in outs]))


def raster_fim(face_verts: torch.Tensor, size: int, with_stats: bool = False,
               chunk: int | None = None):
    """Batched z-buffer raster.

    Args:
        face_verts: (N, F, 3, 3) f32 projected faces.

    Returns:
        RasterOutput(fim (N, S, S) int32, wim (N, S, S, 3) f32; wim is the
        winner's `M @ (x, y, 1)` in full f32, zero on background) [, stats].
    """
    _check_faces(face_verts)
    N, F = face_verts.shape[0], face_verts.shape[1]

    if not use_kernel(face_verts):
        out = raster_fim_plain(face_verts, size, chunk)
        if with_stats:
            return out, plan_stats(prepare_raster(face_verts, size))
        return out

    plan = prepare_raster(face_verts, size)
    out = launch_raster_fim(plan, N, F, size)
    if with_stats:
        return out, plan_stats(plan)
    return out


def launch_raster_fim(plan: RasterPlan, N: int, F: int, size: int) -> rz.RasterOutput:
    """Allocate the outputs and launch the walk and the fim/wim epilogue (the
    one place where they are launched and counted)."""
    dev = plan.geom.device
    with kernel_stream(plan.geom) as stream:
        fim = torch.empty((N, size, size), dtype=torch.int32, device=dev)
        wim = torch.empty((N, size, size, 3), dtype=torch.float32, device=dev)
        zbuf, zb_frames = _zbuf(N, size, dev)
        err = _lib().raster_fim_launch(
            *_plan_ptrs(plan), N, F, size, zbuf.data_ptr(), zb_frames, fim.data_ptr(),
            wim.data_ptr(), stream)
    cuda_build.check_launch(err, "raster_fim")
    count("k3.launches")
    return rz.RasterOutput(fim=fim, wim=wim)


# --------------------------------------------------------------------------
# K4: fused raster + flows over a nearest-first, fixed-capacity tile table
# --------------------------------------------------------------------------
#
# Twin of `rasterize_flows_pallas` and its binning `_bin_faces`. Unlike K1 and
# K3 this function has a capacity: each 8x128-pixel tile keeps at most `k`
# faces, the nearest first by minimum vertex depth, and drops the rest. Which
# faces survive an overflow depends on which tiles a face's box touches, so
# the tile shape (8 rows x 128 columns) is part of the function, not a TPU
# detail: it is kept here, and so is the table order, which also decides
# depth ties (the entry earlier in the table wins: smaller minimum depth,
# then lower face id).
#
# Pixel centres are JAX K4's: y = (gy*8 + r) * f32(2/S) + f32((1-S)/S), the
# product and the sum each rounded to f32 (x likewise with 128). For S a power
# of two this equals K1's (2i + 1 - S) / S bit for bit; for other multiples
# of 128 the two may differ in the last bit.
#
# On a CUDA tensor the tables are built on the device (`prepare_table`,
# `csrc/raster_table_bin.cu`: count, scan, fill and a per-tile select, no host
# sync and no PyTorch sort) and walked by `csrc/raster_table.cu`.
# `bin_faces_table` is the plain binning (the CPU path and the checks);
# `prepare_table_plain` mirrors the device's layout and its sort key.

# must equal TILE_H, TILE_W, ITEM, PARTS in csrc/raster_table.cuh
TABLE_TILE_H, TABLE_TILE_W = 8, 128
TABLE_ITEM = 64  # table entries per work item of the walk
TABLE_PARTS = 4  # column blocks of 8x32 pixels per tile, one work item each
TABLE_STAT_KEYS = ("max_tile_load", "n_overflow_tiles", "total_entries")


class TableBins(NamedTuple):
    """The per-tile face tables of one batch.

    ids: (T, n_tiles, k) int32 face ids in table order, -1 past `kept`;
    kept: (T, n_tiles) int32 = min(true_counts, k);
    true_counts: (T, n_tiles) int32 faces whose box touches the tile;
    stats: max_tile_load, n_overflow_tiles, total_entries (python ints), or
        None when the caller did not ask for them.
    Tiles are numbered row-major: tile = ty * (S // 128) + tx.
    """

    ids: torch.Tensor
    kept: torch.Tensor
    true_counts: torch.Tensor
    stats: dict


class TablePlan(NamedTuple):
    """K4's binning as its walk reads it.

    geom: (T, F, 16) f32 face rows [M 9 | z 3 | bbox 4];
    bins: the tables (`TableBins`, stats None);
    items: (T, n_tiles + 1) int32 first work item of each tile and, last, the
        frame's item count: tile t has TABLE_PARTS * ceil(kept / TABLE_ITEM);
    stats: (3,) int32 on the device, in the order of TABLE_STAT_KEYS
        (`table_stats` reads them).
    """

    geom: torch.Tensor
    bins: TableBins
    items: torch.Tensor
    stats: torch.Tensor


def _check_table_inputs(face_verts: torch.Tensor, size: int) -> None:
    if face_verts.dim() != 4 or face_verts.shape[-2:] != (3, 3):
        raise ValueError(f"face_verts must be (T, F, 3, 3), got {tuple(face_verts.shape)}")
    if face_verts.dtype != torch.float32:
        raise ValueError(f"face_verts must be float32, got {face_verts.dtype}")
    if size <= 0 or size % TABLE_TILE_W:
        raise ValueError(f"size must be a positive multiple of {TABLE_TILE_W}, got {size}")


def _table_tile_ranges(face_verts: torch.Tensor, size: int) -> tuple[torch.Tensor, ...]:
    """Inclusive 8x128 tile ranges (tx0, tx1, ty0, ty1), each (T, F) int64, of
    the faces' boxes padded by 1 px: `to_px(v) = (v + 1) * (S/2) - 0.5` in f32,
    then `floor((lo - 1) / 128)`, `floor((hi + 1) / 128)` (rows by 8), clipped."""
    gy, gx = size // TABLE_TILE_H, size // TABLE_TILE_W
    x, y = face_verts[..., 0], face_verts[..., 1]

    def to_px(v):
        return (v + 1.0) * (size * 0.5) - 0.5

    def tiles(lo, hi, tile, g):
        t0 = torch.floor((to_px(lo) - 1) / tile).clamp(0, g - 1).long()
        t1 = torch.floor((to_px(hi) + 1) / tile).clamp(0, g - 1).long()
        return t0, t1

    return (tiles(x.amin(-1), x.amax(-1), TABLE_TILE_W, gx)
            + tiles(y.amin(-1), y.amax(-1), TABLE_TILE_H, gy))


def _bin_table(face_verts: torch.Tensor, size: int, k: int, rank: torch.Tensor,
               with_stats: bool) -> TableBins:
    """Tables from a per-frame rank of the faces (a permutation of [0, F),
    nearest first): each tile keeps its first min(true_count, k) faces by rank."""
    T, F = face_verts.shape[0], face_verts.shape[1]
    dev = face_verts.device
    n_tiles = (size // TABLE_TILE_H) * (size // TABLE_TILE_W)
    _, valid = rz._face_bary_matrices(face_verts)
    tx0, tx1, ty0, ty1 = _table_tile_ranges(face_verts, size)
    order = torch.empty_like(rank)
    order.scatter_(1, rank, torch.arange(F, device=dev).expand(T, F).contiguous())  # rank -> face id
    tile_s, rank_s, seg, _ = _bin_entries(tx0, tx1, ty0, ty1, valid, size // TABLE_TILE_W, n_tiles,
                                          rank)
    fid = order.reshape(-1)[(tile_s // n_tiles) * F + rank_s]
    true_counts = (seg[1:] - seg[:-1]).to(torch.int32)
    pos = torch.arange(tile_s.numel(), device=dev) - seg[tile_s]
    # entries past the capacity go to one extra slot that is cut off after
    # the scatter: no boolean mask, so no host sync
    slot = torch.where(pos < k, tile_s * k + pos, torch.full_like(pos, T * n_tiles * k))
    ids = torch.full((T * n_tiles * k + 1,), -1, dtype=torch.int32, device=dev)
    ids.scatter_(0, slot, fid.to(torch.int32))
    kept = true_counts.clamp(max=k)
    stats = None
    if with_stats:
        max_load, n_over = (torch.stack([true_counts.max(), (true_counts > k).sum()]).tolist()
                            if true_counts.numel() else (0, 0))  # host sync: the stats
        stats = {"max_tile_load": max_load, "n_overflow_tiles": n_over,
                 "total_entries": tile_s.numel()}
    return TableBins(ids[:-1].reshape(T, n_tiles, k), kept.reshape(T, n_tiles),
                     true_counts.reshape(T, n_tiles), stats)


def bin_faces_table(face_verts: torch.Tensor, size: int, k: int = 2048,
                    with_stats: bool = False) -> TableBins:
    """Nearest-first fixed-capacity binning into 8x128 tiles (JAX `_bin_faces`):
    the plain version of K4's binning.

    A valid face belongs to every tile whose index range its pixel box, padded
    by 1 px, covers (`_table_tile_ranges`). Faces are ranked per frame by a
    stable argsort of their minimum vertex depth; each tile keeps its first
    `min(true_count, k)` faces in that order. Runs on the tensors' device; one
    host sync sizes the entry array, and `with_stats` adds one more for the
    stats.

    Args:
        face_verts: (T, F, 3, 3) f32 projected faces.
        size: S, a multiple of 128.
        k: capacity per tile.
        with_stats: fill `stats`; otherwise it is None.
    """
    _check_table_inputs(face_verts, size)
    T, F = face_verts.shape[0], face_verts.shape[1]
    order = torch.argsort(face_verts[..., 2].amin(-1), dim=-1, stable=True)  # (T, F) nearest first
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(F, device=face_verts.device).expand(T, F).contiguous())
    return _bin_table(face_verts, size, k, rank, with_stats)


def table_depth_key(z: torch.Tensor) -> torch.Tensor:
    """The device binning's 32-bit sort key of a depth (`depth_key` in
    `csrc/raster_table_bin.cu`), as int64: it orders as the floats compare,
    -0.0 equal to +0.0."""
    u = z.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def _table_items(kept: torch.Tensor) -> torch.Tensor:
    """(T, n_tiles + 1) int32 work-item starts of each tile and the frame's total."""
    n = TABLE_PARTS * ((kept.long() + TABLE_ITEM - 1) // TABLE_ITEM)
    return torch.cat([torch.zeros_like(n[:, :1]), torch.cumsum(n, 1)], 1).to(torch.int32)


def prepare_table_plain(face_verts: torch.Tensor, size: int, k: int = 2048) -> TablePlan:
    """Plain mirror of `prepare_table`: the same plan from the device's sort key
    (`table_depth_key(minimum depth) << 32 | face id`, ascending) with
    PyTorch. Runs on the tensor's device; one host sync sizes the entries."""
    _check_table_inputs(face_verts, size)
    T, F = face_verts.shape[0], face_verts.shape[1]
    dev = face_verts.device
    # the unsigned 64-bit key, less 2**63 so that int64 orders it alike
    key = ((table_depth_key(face_verts[..., 2].amin(-1)) - 2 ** 31) << 32) | torch.arange(F, device=dev)
    rank = torch.argsort(torch.argsort(key, dim=-1), dim=-1)
    bins = _bin_table(face_verts, size, k, rank, with_stats=False)
    tc = bins.true_counts
    stats = (torch.stack([tc.max(), (tc > k).sum(), tc.sum()]) if tc.numel()
             else torch.zeros(3, dtype=torch.int64, device=dev))
    return TablePlan(face_geometry(face_verts)[0], bins, _table_items(bins.kept),
                     stats.to(torch.int32))


def table_stats(plan: TablePlan) -> dict:
    """The table binning's stats as python ints: one host sync."""
    return dict(zip(TABLE_STAT_KEYS, plan.stats.tolist()))


def _check_table_constants(lib: ctypes.CDLL, fn: str) -> None:
    got = (ctypes.c_int * 6)()
    getattr(lib, fn)(got)
    if tuple(got) != (TABLE_TILE_H, TABLE_TILE_W, E_CAP, TABLE_ITEM, TABLE_PARTS, 16):
        raise RuntimeError(f"csrc/raster_table.cuh and rasterizer_cuda.py disagree: {tuple(got)}")


def _table_bin_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("raster_table_bin")
    if not getattr(lib, "_ipercore_ready", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.raster_table_bin_constants.argtypes = [p]
        lib.raster_table_bin_launch.argtypes = [p, i, i, i, i] + [p] * 13
        lib.raster_table_bin_launch.restype = i
        _check_table_constants(lib, "raster_table_bin_constants")
        lib._ipercore_ready = True
    return lib


def prepare_table(face_verts: torch.Tensor, size: int, k: int = 2048) -> TablePlan:
    """K4's binning: face geometry and the nearest-first tables. On a CUDA
    tensor the kernels of `csrc/raster_table_bin.cu`, no host sync; on a CPU
    tensor the plain mirror."""
    _check_table_inputs(face_verts, size)
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if not use_kernel(face_verts):
        return prepare_table_plain(face_verts, size, k)
    face_verts = face_verts.contiguous()
    T, F = face_verts.shape[0], face_verts.shape[1]
    gy, gx = size // TABLE_TILE_H, size // TABLE_TILE_W
    n_tiles = gy * gx
    if T * F * E_CAP >= 2 ** 31 or T * n_tiles * k >= 2 ** 31:
        raise ValueError(f"T={T}, F={F}, k={k}: the binning's entries do not fit int32 offsets")
    dev = face_verts.device
    sizes = (T * F * 4, T * F, T * F, T * n_tiles + T + len(TABLE_STAT_KEYS) + 2, T * n_tiles,
             T * n_tiles, T * n_tiles, T * n_tiles, T * (n_tiles + 1), T * F * E_CAP + T * n_tiles)
    with kernel_stream(face_verts) as stream:
        geom = torch.empty((T, F, 16), dtype=torch.float32, device=dev)
        # frange first: its int4 rows need the buffer's 16-byte alignment
        frange, zkey, wide_ids, zeroed, seg, cursor, true_counts, kept, items, list_ids = \
            torch.split(torch.empty(sum(sizes), dtype=torch.int32, device=dev), sizes)
        ids = torch.empty((T, n_tiles, k), dtype=torch.int32, device=dev)
        err = _table_bin_lib().raster_table_bin_launch(
            face_verts.data_ptr(), T, F, size, k, geom.data_ptr(), zkey.data_ptr(),
            frange.data_ptr(), wide_ids.data_ptr(), zeroed.data_ptr(), seg.data_ptr(),
            cursor.data_ptr(), true_counts.data_ptr(), kept.data_ptr(), items.data_ptr(),
            list_ids.data_ptr(), ids.data_ptr(), stream)
    cuda_build.check_launch(err, "table binning")
    count("table_binning.launches")
    bins = TableBins(ids, kept.view(T, n_tiles), true_counts.view(T, n_tiles), None)
    n_stats = len(TABLE_STAT_KEYS)
    return TablePlan(geom, bins, items.view(T, n_tiles + 1), zeroed[-n_stats - 2:-2])


def _table_pixel_centres(size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_tiles, 1024) x and y of every tile's pixels, row-major in the tile,
    by JAX K4's formula."""
    gy, gx = size // TABLE_TILE_H, size // TABLE_TILE_W
    step = torch.tensor(2.0 / size, dtype=torch.float32, device=device)
    off = torch.tensor((1.0 - size) / size, dtype=torch.float32, device=device)
    r = torch.arange(size, device=device, dtype=torch.float32) * step + off  # (S,)
    py = r.reshape(gy, 1, TABLE_TILE_H, 1).expand(gy, gx, TABLE_TILE_H, TABLE_TILE_W)
    px = r.reshape(1, gx, 1, TABLE_TILE_W).expand(gy, gx, TABLE_TILE_H, TABLE_TILE_W)
    n = gy * gx
    return px.reshape(n, -1), py.reshape(n, -1)


def table_bary(a, b, c, px, py):
    """K4's barycentric `a*px + b*py + c` as `fma(a, px, b*py) + c`: the order
    of the JAX kernel in interpret mode on the CPU, found by experiment
    (`tests/test_torch_raster_table.py::test_table_bary_order`). It is not
    K1's `fma(b, py, a*px) + c`: XLA contracts the kernel body otherwise."""
    return rz.fma32(a, px, b * py) + c


def _check_table_aux(face_verts: torch.Tensor, aux_pts: torch.Tensor) -> int:
    F = face_verts.shape[1]
    if aux_pts.dim() != 4 or tuple(aux_pts.shape[1:]) != (F, 3, 2):
        raise ValueError(f"aux_pts must be (J, F, 3, 2) with F={F} and shared by the batch; "
                         f"got {tuple(aux_pts.shape)}")
    if aux_pts.dtype != torch.float32 or aux_pts.device != face_verts.device:
        raise ValueError("aux_pts must be float32 on the device of face_verts")
    return aux_pts.shape[0]


def raster_flows_table_plain(face_verts: torch.Tensor, aux_pts: torch.Tensor, size: int,
                             k: int = 2048, bins: TableBins | None = None,
                             max_elems: int = 1 << 24) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `raster_flows_table`: every tile tests its kept table
    entries in table order, `max_elems` (tile, entry, pixel) triples at a time.
    On equal depth the first entry in table order wins: `min` takes the first
    minimum inside a chunk, and only a strictly smaller depth replaces the best
    across chunks."""
    _check_table_inputs(face_verts, size)
    _check_table_aux(face_verts, aux_pts)
    T, F = face_verts.shape[0], face_verts.shape[1]
    dev = face_verts.device
    if bins is None:
        bins = bin_faces_table(face_verts, size, k)
    geom, _ = face_geometry(face_verts)  # (T, F, 16)
    px, py = _table_pixel_centres(size, dev)  # (n_tiles, P)
    n_tiles, P = px.shape
    step = max(1, max_elems // (n_tiles * P))
    eps = 2.0 / size
    px3, py3 = px[:, None, :], py[:, None, :]
    fims, wims = [], []
    for t in range(T):
        kept = bins.kept[t].long()
        best_z = torch.full((n_tiles, P), float("inf"), device=dev)
        best_id = torch.full((n_tiles, P), -1, dtype=torch.int32, device=dev)
        best_w = torch.zeros((n_tiles, P, 3), device=dev)
        for c0 in range(0, int(kept.max()) if kept.numel() else 0, step):
            ids = bins.ids[t, :, c0:c0 + step].long()  # (n_tiles, C)
            live = (torch.arange(c0, c0 + ids.shape[1], device=dev)[None] < kept[:, None])
            g = geom[t][ids.clamp(min=0)][..., None]  # (n_tiles, C, 16, 1)
            w = [table_bary(g[:, :, 3 * i], g[:, :, 3 * i + 1], g[:, :, 3 * i + 2], px3, py3)
                 for i in range(3)]  # 3 x (n_tiles, C, P)
            inside = (w[0] >= -1e-6) & (w[1] >= -1e-6) & (w[2] >= -1e-6)
            in_bbox = ((px3 >= g[:, :, 12] - eps) & (px3 <= g[:, :, 13] + eps)
                       & (py3 >= g[:, :, 14] - eps) & (py3 <= g[:, :, 15] + eps))
            depth = (w[0] * g[:, :, 9] + w[1] * g[:, :, 10]) + w[2] * g[:, :, 11]
            ok = inside & in_bbox & live[..., None] & (depth > rz.NEAR) & (depth < rz.FAR)
            depth = torch.where(ok, depth, torch.full_like(depth, float("inf")))
            cz, arg = depth.min(dim=1)  # first minimum in table order
            take = cz < best_z
            best_z = torch.where(take, cz, best_z)
            best_id = torch.where(take, torch.gather(ids, 1, arg).to(torch.int32), best_id)
            cw = torch.stack([torch.gather(wi, 1, arg[:, None]).squeeze(1) for wi in w], -1)
            best_w = torch.where(take[..., None], cw, best_w)
        fims.append(best_id)
        wims.append(best_w)
    gy, gx = size // TABLE_TILE_H, size // TABLE_TILE_W

    def untile(a):  # (T, n_tiles, P, ...) -> (T, S, S, ...)
        tail = tuple(a.shape[3:])
        a = a.reshape((T, gy, gx, TABLE_TILE_H, TABLE_TILE_W) + tail)
        return a.transpose(2, 3).reshape((T, size, size) + tail)

    fim, wim = untile(torch.stack(fims)), untile(torch.stack(wims))
    J = aux_pts.shape[0]
    flows = [rz.cal_bc_transform(aux_pts[j][None].expand(T, F, 3, 2), fim, wim) for j in range(J)]
    return fim, torch.stack(flows, dim=3)


def raster_flows_table(face_verts: torch.Tensor, aux_pts: torch.Tensor, size: int,
                       k: int = 2048, with_stats: bool = False):
    """Batched rasterize + flows over nearest-first k-capacity tile tables:
    the `IPERCORE_CSR_RASTER=0` route of `make_frame_inputs`.

    Args:
        face_verts: (T, F, 3, 3) f32 projected target-pose faces.
        aux_pts: (J, F, 3, 2) f32 coordinate sets shared by the batch (the
            JAX kernel has no per-frame form; a (T, J, F, 3, 2) aux raises).
        size: S, a multiple of 128.
        k: faces kept per 8x128 tile; beyond it the farthest are dropped.

    Returns:
        fim (T, S, S) int32 (-1 background), flows (T, S, S, J, 2) f32
        (FLOW_SENTINEL on background) [, stats with max_tile_load,
        n_overflow_tiles, total_entries].
    """
    _check_table_inputs(face_verts, size)
    J = _check_table_aux(face_verts, aux_pts)
    if not use_kernel(face_verts):
        bins = bin_faces_table(face_verts, size, k, with_stats)
        fim, flows = raster_flows_table_plain(face_verts, aux_pts, size, k, bins)
        return (fim, flows, bins.stats) if with_stats else (fim, flows)
    plan = prepare_table(face_verts, size, k)
    fim, flows = launch_raster_flows_table(plan, aux_pts.contiguous(), size, J)
    return (fim, flows, table_stats(plan)) if with_stats else (fim, flows)


def _table_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("raster_table")
    if not getattr(lib, "_ipercore_ready", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.raster_table_constants.argtypes = [p]
        lib.raster_flows_table_launch.argtypes = [p] * 5 + [i] * 5 + [p, i, p, p, p]
        lib.raster_flows_table_launch.restype = i
        _check_table_constants(lib, "raster_table_constants")
        lib._ipercore_ready = True
    return lib


def launch_raster_flows_table(plan: TablePlan, aux: torch.Tensor, size: int,
                              J: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the outputs and launch the table walk and its epilogue (the
    one place where they are launched and counted). `aux` (J, F, 3, 2) must be
    contiguous f32 on the GPU."""
    T, F = plan.geom.shape[0], plan.geom.shape[1]
    k = plan.bins.ids.shape[-1]
    dev = plan.geom.device
    with kernel_stream(plan.geom, aux) as stream:
        fim = torch.empty((T, size, size), dtype=torch.int32, device=dev)
        flows = torch.empty((T, size, size, J, 2), dtype=torch.float32, device=dev)
        zbuf, zb_frames = _zbuf(T, size, dev)
        err = _table_lib().raster_flows_table_launch(
            plan.geom.data_ptr(), plan.bins.ids.data_ptr(), plan.bins.kept.data_ptr(),
            plan.items.data_ptr(), aux.data_ptr(), T, F, size, J, k, zbuf.data_ptr(), zb_frames,
            fim.data_ptr(), flows.data_ptr(), stream)
    cuda_build.check_launch(err, "raster_flows_table")
    count("k4.launches")
    return fim, flows
