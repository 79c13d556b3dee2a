"""SMPL mesh rasterization in plain PyTorch: face-index maps, barycentric
weight maps, dense flows.

Twin of `ipercore_tpu/ops/rasterizer.py` and the reference every raster kernel
of the port is held against. Same coordinate convention:

  * projected vertices live in grid-sample NDC: x in [-1, 1] left -> right,
    y in [-1, 1] top -> bottom; pixel (row r, col c) centre is
    x = (2c + 1 - S) / S, y = (2r + 1 - S) / S;
  * `project_verts` applies the weak-perspective camera, flips y into image
    orientation and offsets z by the fixed eye distance, so depth is positive
    with smaller = closer.

Arithmetic order (load-bearing). Pixel centres of the synthetic UV atlas lie
exactly on triangle edges, so the last bit of a barycentric decides who owns
such a pixel. The JAX package's CPU build (XLA's LLVM backend contracts
multiply-add pairs into fused multiply-adds) evaluates, found by experiment
(the candidates are the cases of `tests/test_torch_raster.py::test_fma_order_*`)
and bit-exact on body and UV-template faces:

    det     = fma(x2, y0 - y1, fma(x0, y1 - y2, -(x1 * (y0 - y2))))
    M[.,2]  = fma(xi, yj, -(xj * yi)) * inv_det
    w       = fma(b, py, a * px) + c          (w = a*px + b*py + c)

`fma32` below reproduces a single-rounded f32 fused multiply-add by forming
the product and sum in f64 (the f32 x f32 product is exact there) and rounding
once to f32. The CUDA kernels in `csrc/raster.cu` use the same order through
`__fmaf_rn` / `__fmul_rn` / `__fadd_rn`, so kernel and plain version agree on
edge pixels too. Depth and flow blends are plain left-to-right sums with every
product and sum rounded to f32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

VIEWING_ANGLE = 30.0
EYE_DISTANCE = 1.0 / math.tan(math.radians(VIEWING_ANGLE)) + 1.0
NEAR = 0.1
FAR = 25.0
# Flow sentinel for "no source here": grid_sample of -2 lands outside and yields 0.
FLOW_SENTINEL = -2.0


class RasterOutput(NamedTuple):
    """fim: (..., S, S) int32 face-index map, -1 = background;
    wim: (..., S, S, 3) f32 barycentric weights of each pixel in its face."""

    fim: torch.Tensor
    wim: torch.Tensor


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add a * b + c with one rounding (see module note)."""
    return (a.double() * b.double() + c.double()).float()


def project_verts(verts: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Weak-perspective project (..., V, 3) vertices with (..., 3) cameras
    (scale, tx, ty) into screen NDC: (x, y) y-down, z = depth + EYE_DISTANCE."""
    s = cam[..., None, 0:1]
    t = cam[..., None, 1:3]
    xy = s * (verts[..., 0:2] + t)
    x = xy[..., 0:1]
    y = -xy[..., 1:2]
    z = verts[..., 2:3] + EYE_DISTANCE
    return torch.cat([x, y, z], dim=-1)


def verts_to_faces(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Gather per-face vertex attributes: (..., V, D), (F, 3) -> (..., F, 3, D)."""
    return verts[..., faces, :]


def _pixel_centers(size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(S*S, 3) homogeneous pixel-centre coordinates in NDC (x, y, 1).

    Computed on the CPU and moved: PyTorch's CUDA division by a scalar
    multiplies by its rounded reciprocal, which moves the centres by an ulp
    where S is not a power of two (at 384 the plain raster on the card then
    missed the CPU's, and K1's, face at shared edges)."""
    coords = ((2.0 * torch.arange(size, dtype=dtype) + 1.0 - size) / size).to(device)
    ys, xs = torch.meshgrid(coords, coords, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones(size * size, dtype=dtype, device=device)], dim=-1)


def _face_bary_matrices(face_verts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-face matrices mapping homogeneous pixel coords to barycentrics.

    Args:
        face_verts: (..., F, 3, 3) projected (x, y, z) per face vertex.

    Returns:
        M: (..., F, 3, 3) with w = M @ (x, y, 1);
        valid: (..., F) mask of non-degenerate (|det| >= 1e-12), in-depth-range
        faces that are not wholly outside [-1.5, 1.5].
    """
    x = face_verts[..., 0]
    y = face_verts[..., 1]
    z = face_verts[..., 2]
    x0, x1, x2 = x.unbind(-1)
    y0, y1, y2 = y.unbind(-1)
    det = fma32(x2, y0 - y1, fma32(x0, y1 - y2, -(x1 * (y0 - y2))))
    degenerate = det.abs() < 1e-12
    inv_det = torch.where(degenerate, torch.zeros_like(det),
                          1.0 / torch.where(degenerate, torch.ones_like(det), det))

    def row(i, j):
        xi, xj, yi, yj = x[..., i], x[..., j], y[..., i], y[..., j]
        return torch.stack([yi - yj, xj - xi, fma32(xi, yj, -(xj * yi))], dim=-1)

    M = torch.stack([row(1, 2), row(2, 0), row(0, 1)], dim=-2) * inv_det[..., None, None]
    z_ok = (z.amin(-1) < FAR) & (z.amax(-1) > NEAR)
    on_screen = ~((x.amax(-1) < -1.5) | (x.amin(-1) > 1.5)
                  | (y.amax(-1) < -1.5) | (y.amin(-1) > 1.5))
    valid = (~degenerate) & z_ok & on_screen
    return M, valid


def _face_bbox(face_verts: torch.Tensor) -> torch.Tensor:
    """(..., F, 4) NDC bounding box (xmin, xmax, ymin, ymax) per face."""
    x = face_verts[..., 0]
    y = face_verts[..., 1]
    return torch.stack([x.amin(-1), x.amax(-1), y.amin(-1), y.amax(-1)], dim=-1)


def _auto_chunk(size: int) -> int:
    """Face-chunk size bounding the (chunk, 3, S*S) barycentric intermediate."""
    P = size * size
    budget_elems = 32_000_000
    c = max(64, budget_elems // (3 * P))
    return min(4096, (c // 64) * 64 or 64)


def rasterize(face_verts: torch.Tensor, size: int, chunk: int | None = None) -> RasterOutput:
    """Z-buffer rasterize one image's triangles (plain reference).

    A pixel takes the nearest face whose barycentrics are all >= -1e-6, that
    lies inside the face's bounding box +- 2/S, whose interpolated depth is in
    (NEAR, FAR) and that is valid. On equal depth the lowest face id wins:
    `argmin` takes the first minimum inside a chunk and only a strictly
    smaller depth replaces the best across chunks.

    Args:
        face_verts: (F, 3, 3) projected per-face vertices.
        size: output image size S.
        chunk: faces per step.

    Returns:
        RasterOutput(fim (S, S) int32, wim (S, S, 3) f32).
    """
    if chunk is None:
        chunk = _auto_chunk(size)
    F = face_verts.shape[0]
    dev, dt = face_verts.device, face_verts.dtype
    pixels = _pixel_centers(size, dt, dev)
    eps_px = 2.0 / size

    M_all, valid_all = _face_bary_matrices(face_verts)
    bbox_all = _face_bbox(face_verts)

    coords = pixels[:size, 0]  # the pixel-centre values of both axes
    best_z = torch.full((size, size), float("inf"), dtype=dt, device=dev)
    best_id = torch.full((size, size), -1, dtype=torch.int32, device=dev)
    best_w = torch.zeros((size, size, 3), dtype=dt, device=dev)

    def span(lo, hi):
        # the pixel indices whose centre lies in [lo, hi]: a range, since the
        # centres increase
        idx = ((coords >= lo) & (coords <= hi)).nonzero()
        return (int(idx[0]), int(idx[-1]) + 1) if idx.numel() else (0, 0)

    for start in range(0, F, chunk):
        M = M_all[start:start + chunk]  # (c, 3, 3)
        valid = valid_all[start:start + chunk]
        bbox = bbox_all[start:start + chunk]
        zf = face_verts[start:start + chunk, :, 2]  # (c, 3)
        # only the pixels inside the union of the chunk's guarded boxes can
        # pass `in_bbox` (rounding is monotonic, so min(b) - eps <= b - eps):
        # the others are skipped, with the same result
        x0, x1 = span(bbox[:, 0].min() - eps_px, bbox[:, 1].max() + eps_px)
        y0, y1 = span(bbox[:, 2].min() - eps_px, bbox[:, 3].max() + eps_px)
        if x0 == x1 or y0 == y1:
            continue
        px = coords[x0:x1].expand(y1 - y0, x1 - x0).reshape(-1)
        py = coords[y0:y1, None].expand(y1 - y0, x1 - x0).reshape(-1)
        a, b, c = M[..., 0, None], M[..., 1, None], M[..., 2, None]  # (c, 3, 1)
        W = fma32(b, py, a * px) + c  # (c, 3, p)
        inside = (W >= -1e-6).all(dim=1)
        in_bbox = ((px >= bbox[:, 0:1] - eps_px) & (px <= bbox[:, 1:2] + eps_px)
                   & (py >= bbox[:, 2:3] - eps_px) & (py <= bbox[:, 3:4] + eps_px))
        depth = (W[:, 0] * zf[:, 0:1] + W[:, 1] * zf[:, 1:2]) + W[:, 2] * zf[:, 2:3]
        ok = inside & in_bbox & valid[:, None] & (depth > NEAR) & (depth < FAR)
        depth = torch.where(ok, depth, torch.full_like(depth, float("inf")))
        cand_z, arg = depth.min(dim=0)  # first minimum
        bz = best_z[y0:y1, x0:x1].reshape(-1)
        take = cand_z < bz
        shape = (y1 - y0, x1 - x0)
        best_z[y0:y1, x0:x1] = torch.where(take, cand_z, bz).reshape(shape)
        best_id[y0:y1, x0:x1] = torch.where(
            take, (arg + start).to(torch.int32), best_id[y0:y1, x0:x1].reshape(-1)).reshape(shape)
        w = W[arg, :, torch.arange(px.numel(), device=dev)]
        best_w[y0:y1, x0:x1] = torch.where(
            take[:, None], w, best_w[y0:y1, x0:x1].reshape(-1, 3)).reshape(shape + (3,))

    return RasterOutput(fim=best_id, wim=best_w)


def rasterize_batch(face_verts: torch.Tensor, size: int, chunk: int | None = None) -> RasterOutput:
    """Rasterize a batch (N, F, 3, 3). A CUDA tensor goes to the
    `raster_fim` kernel, a CPU tensor to the plain loop."""
    from ipercore_tpu_torch.ops.rasterizer_cuda import raster_fim

    return raster_fim(face_verts, size, chunk=chunk)


def render_fim_wim(
    verts: torch.Tensor, cam: torch.Tensor, faces: torch.Tensor, size: int,
    chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project + rasterize a batch: verts (N, V, 3), cam (N, 3), faces (F, 3)
    -> f2pts (N, F, 3, 2), fim (N, S, S) int32, wim (N, S, S, 3)."""
    proj = project_verts(verts, cam)
    face_verts = verts_to_faces(proj, faces)
    out = rasterize_batch(face_verts, size, chunk)
    return face_verts[..., 0:2], out.fim, out.wim


def rasterize_uv_template(f2uvs: torch.Tensor, size: int, chunk: int | None = None) -> RasterOutput:
    """Rasterize the static UV-unwrap template once: f2uvs (F, 3, 2) at z = 1
    -> RasterOutput for a single (S, S) UV-space image."""
    z = torch.ones(f2uvs.shape[:-1] + (1,), dtype=f2uvs.dtype, device=f2uvs.device)
    fv = torch.cat([f2uvs, z], dim=-1)
    out = rasterize_batch(fv[None], size, chunk)
    return RasterOutput(fim=out.fim[0], wim=out.wim[0])


def cal_bc_transform(src_f2pts: torch.Tensor, dst_fim: torch.Tensor,
                     dst_wim: torch.Tensor) -> torch.Tensor:
    """Dense backward flow from a destination raster to source coordinates.

    For each destination pixel covered by face f with barycentrics w, the flow
    is the w-blend of that face's source screen positions.

    Args:
        src_f2pts: (N, F, 3, 2); dst_fim: (N, S, S) int; dst_wim: (N, S, S, 3).

    Returns:
        (N, S, S, 2) flow grid for grid_sample; background = FLOW_SENTINEL.
    """
    N = dst_fim.shape[0]
    safe = dst_fim.clamp(min=0).long()
    batch = torch.arange(N, device=dst_fim.device)[:, None, None]
    tri = src_f2pts[batch, safe]  # (N, S, S, 3, 2)
    w = dst_wim[..., None]
    flow = (tri[..., 0, :] * w[..., 0, :] + tri[..., 1, :] * w[..., 1, :]) + tri[..., 2, :] * w[..., 2, :]
    return torch.where((dst_fim >= 0)[..., None], flow, torch.full_like(flow, FLOW_SENTINEL))


def visible_face_mask(fim: torch.Tensor, n_faces: int) -> torch.Tensor:
    """Boolean (N, F) mask of faces visible in each face-index map."""
    N = fim.shape[0]
    flat = fim.reshape(N, -1).long()
    # background (-1) is routed to an extra slot that is cut off again
    hits = torch.zeros((N, n_faces + 1), dtype=torch.bool, device=fim.device)
    hits.scatter_(1, torch.where(flat < 0, torch.full_like(flat, n_faces), flat), True)
    return hits[:, :n_faces]


def expand_mask_by_knn(mask: torch.Tensor, face_k_nearest: torch.Tensor) -> torch.Tensor:
    """Dilate an (N, F) face mask through per-face k-nearest face ids (F, K):
    the union of the k-nearest sets of all masked faces."""
    N, F = mask.shape
    src = torch.where(mask[:, :, None], face_k_nearest.long()[None],
                      torch.full_like(face_k_nearest.long()[None], F)).reshape(N, -1)
    out = torch.zeros((N, F + 1), dtype=torch.bool, device=mask.device)
    out.scatter_(1, src, True)
    return out[:, :F]


def select_f2pts(f2pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace non-selected faces' coords (N, F, 3, 2) with the flow sentinel."""
    return torch.where(mask[..., None, None], f2pts, torch.full_like(f2pts, FLOW_SENTINEL))


def encode_fim(fim: torch.Tensor, map_fn: torch.Tensor) -> torch.Tensor:
    """Face-index map (N, S, S) -> part-colour condition map (N, S, S, C);
    map_fn is (F + 1, C) with the background colour in the last row."""
    n = map_fn.shape[0]
    idx = torch.where(fim < 0, torch.full_like(fim, n - 1), fim).long()
    return map_fn[idx]
