"""Plain body geometry: SMPL linear blend skinning, the weak-perspective
projection, the z-buffer raster, barycentric flows and the part condition map.

The arithmetic follows the port's published plain versions operation for
operation (the same contraction order of the barycentric matrices through a
single-rounded fused multiply-add, the same left-to-right blends, the same
level-by-level walk of the kinematic tree), so that on the same inputs the
reference lands every pixel on the same face. Departures, none of which
changes a result:
  * the raster takes up to `RASTER_CHUNK` faces a step instead of the
    port's 64; the winner is the nearest face and, on equal depth, the lowest
    face id, whatever the chunking;
  * the flows come from the raster's face-index and weight maps
    (`bc_flow`), where the program fuses them into its raster kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

EYE_DISTANCE = 1.0 / math.tan(math.radians(30.0)) + 1.0
NEAR, FAR = 0.1, 25.0
FLOW_SENTINEL = -2.0
RASTER_CHUNK = 512


class Body:
    """The body model's arrays as tensors on one device."""

    def __init__(self, arrays: dict, device):
        f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
        for k in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
                  "joint_regressor"):
            setattr(self, k, f32(arrays[k]))
        self.faces = torch.as_tensor(np.asarray(arrays["faces"], np.int64), device=device)
        parents = np.asarray(arrays["parents"], np.int64)
        self.parents = torch.as_tensor(parents, device=device)
        depth = np.zeros(len(parents), np.int64)
        for j in range(1, len(parents)):
            depth[j] = depth[parents[j]] + 1
        self.levels = []
        for d in range(1, int(depth.max()) + 1):
            ids = np.nonzero(depth == d)[0]
            self.levels.append((torch.as_tensor(ids, device=device),
                                torch.as_tensor(parents[ids], device=device)))
        self.bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3); angles under 1e-6
    take the first-order form."""
    angle = torch.sqrt(torch.sum(aa * aa, dim=-1, keepdim=True) + 1e-16)
    axis = aa / angle
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    o = torch.zeros_like(x)
    K = torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                     torch.stack([-y, x, o], -1)], dim=-2)
    a = angle[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    R = eye + torch.sin(a) * K + (1.0 - torch.cos(a)) * (K @ K)
    return torch.where(a < 1e-6, eye + K * a, R)


def lbs(body: Body, shape: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Skinned vertices (N, V, 3) of betas (N, 10) and axis-angle poses (N, 72)."""
    N = pose.shape[0]
    J = body.parents.shape[0]
    rot = rodrigues(pose.reshape(N, J, 3))
    v_shaped = body.v_template + torch.einsum("vds,ns->nvd", body.shapedirs, shape)
    joints = torch.einsum("jv,nvd->njd", body.j_regressor, v_shaped)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    v_posed = v_shaped + torch.einsum("vdp,np->nvd", body.posedirs, (rot[:, 1:] - eye).reshape(N, -1))
    rel = joints - joints[:, body.parents]
    rel[:, 0] = joints[:, 0]
    top = torch.cat([rot, rel[..., None]], dim=-1)
    local = torch.cat([top, body.bottom.to(rot.dtype).expand(N, J, 1, 4)], dim=-2)
    A = local.clone()
    for ids, par in body.levels:
        A[:, ids] = A[:, par] @ local[:, ids]
    correction = torch.einsum("njab,njb->nja", A[..., :3, :3], joints)
    A_rel = A.clone()
    A_rel[..., :3, 3] = A_rel[..., :3, 3] - correction
    T = torch.einsum("vj,njab->nvab", body.lbs_weights, A_rel)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    return torch.einsum("nvab,nvb->nva", T, v_h)[..., :3]


def verts_of(body: Body, theta: torch.Tensor) -> torch.Tensor:
    """theta (N, 85) = camera 3 | pose 72 | shape 10 -> vertices (N, V, 3)."""
    return lbs(body, theta[:, 75:], theta[:, 3:75])


def project(verts: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Weak perspective (s, tx, ty) into grid-sample coordinates, y down,
    depth offset by the eye distance."""
    xy = cam[..., None, 0:1] * (verts[..., 0:2] + cam[..., None, 1:3])
    return torch.cat([xy[..., 0:1], -xy[..., 1:2], verts[..., 2:3] + EYE_DISTANCE], dim=-1)


def face_verts_of(body: Body, theta: torch.Tensor) -> torch.Tensor:
    """Projected per-face vertices (N, F, 3, 3) of theta (N, 85)."""
    return project(verts_of(body, theta), theta[:, 0:3])[:, body.faces]


def fma32(a, b, c):
    """a * b + c rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def face_bary(fv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """M (..., F, 3, 3) with barycentrics w = M @ (x, y, 1), and the mask of
    faces that are not degenerate, lie in depth range and touch the screen."""
    x, y, z = fv[..., 0], fv[..., 1], fv[..., 2]
    x0, x1, x2 = x.unbind(-1)
    y0, y1, y2 = y.unbind(-1)
    det = fma32(x2, y0 - y1, fma32(x0, y1 - y2, -(x1 * (y0 - y2))))
    degenerate = det.abs() < 1e-12
    inv = torch.where(degenerate, torch.zeros_like(det),
                      1.0 / torch.where(degenerate, torch.ones_like(det), det))

    def row(i, j):
        xi, xj, yi, yj = x[..., i], x[..., j], y[..., i], y[..., j]
        return torch.stack([yi - yj, xj - xi, fma32(xi, yj, -(xj * yi))], dim=-1)

    M = torch.stack([row(1, 2), row(2, 0), row(0, 1)], dim=-2) * inv[..., None, None]
    z_ok = (z.amin(-1) < FAR) & (z.amax(-1) > NEAR)
    on_screen = ~((x.amax(-1) < -1.5) | (x.amin(-1) > 1.5) | (y.amax(-1) < -1.5)
                  | (y.amin(-1) > 1.5))
    return M, (~degenerate) & z_ok & on_screen


def face_bbox(fv: torch.Tensor) -> torch.Tensor:
    x, y = fv[..., 0], fv[..., 1]
    return torch.stack([x.amin(-1), x.amax(-1), y.amin(-1), y.amax(-1)], dim=-1)


def pixel_coords(size: int, device) -> torch.Tensor:
    """Pixel-centre coordinates (2i + 1 - S) / S, computed on the host."""
    return ((2.0 * torch.arange(size, dtype=torch.float32) + 1.0 - size) / size).to(device)


def rasterize(fv: torch.Tensor, size: int, chunk: int = RASTER_CHUNK):
    """Z-buffer one image's faces (F, 3, 3): fim (S, S) int32 (-1 background)
    and wim (S, S, 3). A pixel takes the nearest valid face whose
    barycentrics are all >= -1e-6 and whose guarded box (+- 2/S) holds it."""
    F_ = fv.shape[0]
    dev, dt = fv.device, fv.dtype
    coords = pixel_coords(size, dev)
    eps = 2.0 / size
    M_all, valid_all = face_bary(fv)
    box_all = face_bbox(fv)
    best_z = torch.full((size, size), float("inf"), dtype=dt, device=dev)
    best_id = torch.full((size, size), -1, dtype=torch.int32, device=dev)
    best_w = torch.zeros((size, size, 3), dtype=dt, device=dev)

    def span(lo, hi):
        idx = ((coords >= lo) & (coords <= hi)).nonzero()
        return (int(idx[0]), int(idx[-1]) + 1) if idx.numel() else (0, 0)

    for s in range(0, F_, chunk):
        M, valid, box = M_all[s:s + chunk], valid_all[s:s + chunk], box_all[s:s + chunk]
        zf = fv[s:s + chunk, :, 2]
        x0, x1 = span(box[:, 0].min() - eps, box[:, 1].max() + eps)
        y0, y1 = span(box[:, 2].min() - eps, box[:, 3].max() + eps)
        if x0 == x1 or y0 == y1:
            continue
        px = coords[x0:x1].expand(y1 - y0, x1 - x0).reshape(-1)
        py = coords[y0:y1, None].expand(y1 - y0, x1 - x0).reshape(-1)
        a, b, c = M[..., 0, None], M[..., 1, None], M[..., 2, None]
        W = fma32(b, py, a * px) + c
        inside = (W >= -1e-6).all(dim=1)
        in_box = ((px >= box[:, 0:1] - eps) & (px <= box[:, 1:2] + eps)
                  & (py >= box[:, 2:3] - eps) & (py <= box[:, 3:4] + eps))
        depth = (W[:, 0] * zf[:, 0:1] + W[:, 1] * zf[:, 1:2]) + W[:, 2] * zf[:, 2:3]
        ok = inside & in_box & valid[:, None] & (depth > NEAR) & (depth < FAR)
        depth = torch.where(ok, depth, torch.full_like(depth, float("inf")))
        cand, arg = depth.min(dim=0)
        shape = (y1 - y0, x1 - x0)
        bz = best_z[y0:y1, x0:x1].reshape(-1)
        take = cand < bz
        best_z[y0:y1, x0:x1] = torch.where(take, cand, bz).reshape(shape)
        best_id[y0:y1, x0:x1] = torch.where(
            take, (arg + s).to(torch.int32), best_id[y0:y1, x0:x1].reshape(-1)).reshape(shape)
        w = W[arg, :, torch.arange(px.numel(), device=dev)]
        best_w[y0:y1, x0:x1] = torch.where(
            take[:, None], w, best_w[y0:y1, x0:x1].reshape(-1, 3)).reshape(shape + (3,))
        del W, depth, ok, inside, in_box
    return best_id, best_w


def rasterize_batch(fv: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    outs = [rasterize(f, size) for f in fv]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def bc_flow(src_pts: torch.Tensor, fim: torch.Tensor, wim: torch.Tensor) -> torch.Tensor:
    """Backward flow (N, S, S, 2): each covered pixel takes the weight blend of
    its face's source points (N, F, 3, 2); background takes the sentinel."""
    N = fim.shape[0]
    tri = src_pts[torch.arange(N, device=fim.device)[:, None, None], fim.clamp(min=0).long()]
    w = wim[..., None]
    flow = (tri[..., 0, :] * w[..., 0, :] + tri[..., 1, :] * w[..., 1, :]) + tri[..., 2, :] * w[..., 2, :]
    return torch.where((fim >= 0)[..., None], flow, torch.full_like(flow, FLOW_SENTINEL))


def encode_fim(fim: torch.Tensor, map_fn: torch.Tensor) -> torch.Tensor:
    """Face-index map -> part colours (N, S, S, 3), the last row for background."""
    n = map_fn.shape[0]
    return map_fn[torch.where(fim < 0, torch.full_like(fim, n - 1), fim).long()]


def visible_faces(fim: torch.Tensor, n_faces: int) -> torch.Tensor:
    """(N, F) bool: the faces that own a pixel."""
    N = fim.shape[0]
    flat = fim.reshape(N, -1).long()
    hits = torch.zeros((N, n_faces + 1), dtype=torch.bool, device=fim.device)
    hits.scatter_(1, torch.where(flat < 0, torch.full_like(flat, n_faces), flat), True)
    return hits[:, :n_faces]


def expand_by_knn(mask: torch.Tensor, knn: torch.Tensor) -> torch.Tensor:
    """Union of the k-nearest sets of the masked faces: (N, F) -> (N, F)."""
    N, F_ = mask.shape
    src = torch.where(mask[:, :, None], knn.long()[None],
                      torch.full_like(knn.long()[None], F_)).reshape(N, -1)
    out = torch.zeros((N, F_ + 1), dtype=torch.bool, device=mask.device)
    out.scatter_(1, src, True)
    return out[:, :F_]
