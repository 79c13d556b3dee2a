"""Human digitalization deformers: silhouette-fitted vertex offsets and
cloth links.

The port's copy of `ipercore_tpu/tools/deformers.py` (the reference's
`human_digitalizer/deformers/`):
  * `run_sil2smpl_offsets`: per-vertex offsets (V, 3) fitted so that the
    body's differentiable soft silhouette matches the observed masks (Adam,
    500 steps, MSE + L2), with a SoftRas-style silhouette over the real
    triangles (`soft_silhouette_raster`) or a vertex-splat one
    (`soft_silhouette`);
  * cloth links: inner leg vertices below a skirt hem linked to the other
    leg (`smpl_link`; the hem from SCHP's skirt+dress mask in
    `find_cloth_links_schp`), or leg vertices below a cloth hem linked to the
    hem ring (`find_cloth_links`).

The silhouette is differentiable, so it runs in PyTorch, not in the raster
kernels: those give hard face-index maps.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.ops.rasterizer import _face_bary_matrices, _pixel_centers, project_verts, verts_to_faces
from ipercore_tpu_torch.ops.sampling import resize_image


def soft_silhouette(verts: torch.Tensor, cam: torch.Tensor, size: int,
                    sigma: float = 2.0) -> torch.Tensor:
    """Differentiable vertex-splat silhouette: verts (..., V, 3), cam (..., 3)
    -> (..., size, size) coverage in [0, 1], the sum of separable Gaussian
    splats through 1 - exp(-acc)."""
    proj = project_verts(verts, cam)
    px = (proj[..., 0] + 1.0) * (size * 0.5) - 0.5
    py = (proj[..., 1] + 1.0) * (size * 0.5) - 0.5
    xs = torch.arange(size, dtype=verts.dtype, device=verts.device)
    gx = torch.exp(-((xs - px[..., None]) ** 2) / (2 * sigma ** 2))  # (..., V, S)
    gy = torch.exp(-((xs - py[..., None]) ** 2) / (2 * sigma ** 2))
    acc = gy.transpose(-1, -2) @ gx  # (..., S, S): sum over vertices of splat outer products
    return 1.0 - torch.exp(-acc)


def _chunk_log_miss(M: torch.Tensor, valid: torch.Tensor, pix: torch.Tensor, sigma: float) -> torch.Tensor:
    """sum over the chunk's faces of log(1 - c_f(p)): M (..., f, 3, 3),
    valid (..., f) -> (..., P)."""
    w = torch.einsum("...fab,pb->...fpa", M, pix)  # (..., f, P, 3)
    c = torch.sigmoid(torch.amin(w, dim=-1) / sigma) * valid[..., None]
    return torch.sum(torch.log1p(-torch.clamp(c, 0.0, 1.0 - 1e-6)), dim=-2)


def soft_silhouette_raster(verts: torch.Tensor, cam: torch.Tensor, faces: torch.Tensor, size: int,
                           sigma: float | None = None, chunk: int = 512) -> torch.Tensor:
    """SoftRas-style differentiable silhouette through the real triangles.

    Per pixel p and face f the coverage is c_f(p) = sigmoid(min_bary(p, f) /
    sigma) (the smallest barycentric is positive inside f), aggregated as
    1 - prod_f (1 - c_f) in log space over chunks of `chunk` faces. Each
    chunk runs under `torch.utils.checkpoint`, so the backward recomputes its
    (..., chunk, P, 3) barycentrics instead of keeping all of them: autograd
    holds O(P) per frame, not O(F P) (the JAX twin remats its scan body).

    Args:
        verts: (..., V, 3); cam: (..., 3); faces: (F, 3) int.
        sigma: defaults to 1 / size, about a pixel's change of min_bary.

    Returns:
        (..., size, size) coverage in [0, 1], differentiable in verts.
    """
    if sigma is None:
        sigma = 1.0 / size
    fv = verts_to_faces(project_verts(verts, cam), faces)  # (..., F, 3, 3)
    M, valid = _face_bary_matrices(fv)
    pix = _pixel_centers(size, fv.dtype, fv.device)  # (P, 3)
    valid = valid.to(fv.dtype)
    log_miss = torch.zeros(fv.shape[:-3] + (pix.shape[0],), dtype=fv.dtype, device=fv.device)
    for f0 in range(0, M.shape[-3], chunk):
        log_miss = log_miss + checkpoint(_chunk_log_miss, M[..., f0:f0 + chunk, :, :],
                                         valid[..., f0:f0 + chunk], pix, sigma, use_reentrant=False)
    return (1.0 - torch.exp(log_miss)).reshape(fv.shape[:-3] + (size, size))


def sil_fit_loss(model, theta: torch.Tensor, obs: torch.Tensor, offsets: torch.Tensor,
                 reg: float) -> torch.Tensor:
    """The silhouette fit's objective: the mean squared difference between
    the soft silhouettes of `theta` (N, 85) posed with `offsets` (V, 3) and
    the observed person masks `obs` (N, S, S), plus `reg` times the mean
    squared offset."""
    details = smpl_mod.get_details(model, theta, offsets=offsets)
    sils = soft_silhouette_raster(details["verts"], details["cam"], model.faces, obs.shape[-1])
    return torch.mean((sils - obs) ** 2) + reg * torch.mean(offsets ** 2)


def run_sil2smpl_offsets(opt, info, n_steps: int = 500, lr: float = 1e-4,
                         reg: float = 1e4, size: int = 128, device="cuda") -> np.ndarray:
    """Fit per-vertex offsets to observed silhouettes (`sil_deformer.py:79-118`)
    with Adam (optax's `adam(lr)`) on the device.

    Args:
        info: a ProcessInfo with `smpls` (N, 85) and `masks` (N, H, W, 1),
            background = 1. The first 4 frames are fitted, their masks
            resized to `size`² (linear, antialiased when shrinking).

    Returns:
        offsets: (V, 3) float32, zeros when `info` lacks either array.
    """
    from ipercore_tpu_torch.trainers.lwg_trainer import Adam

    smpls = info.get_array("smpls")
    masks = info.get_array("masks")
    model = smpl_mod.resolve_body_model(opt, device=device)
    if getattr(opt, "get", None) and opt.get("smoke_model", False):
        n_steps = min(n_steps, 10)
    V = model.v_template.shape[0]
    if smpls is None or masks is None or len(smpls) == 0:
        return np.zeros((V, 3), np.float32)

    n = min(4, len(smpls))  # a few frames suffice (the reference uses the sources)
    dev = model.v_template.device
    theta = torch.as_tensor(np.asarray(smpls[:n], np.float32), device=dev)
    obs = 1.0 - torch.as_tensor(np.asarray(masks[:n], np.float32), device=dev)  # person = 1
    obs = resize_image(obs, size, size)[..., 0]

    tx = Adam(lr, grad_clip=0.0, b1=0.9, skip_nonfinite=False)
    params = {"offsets": torch.zeros((V, 3), dtype=torch.float32, device=dev)}
    state = tx.init(params)
    for _ in range(n_steps):
        with torch.enable_grad():
            off = params["offsets"].detach().requires_grad_(True)
            (g,) = torch.autograd.grad(sil_fit_loss(model, theta, obs, off, reg), [off])
        params, state = tx.apply({"offsets": g}, state, params)
    return params["offsets"].cpu().numpy()


# Mean body shape of the reference linker (`link_utils.py:66-68`), data.
LINKER_MEAN_SHAPE = np.array(
    [-0.00124704, 0.00200815, 0.01044902, 0.01385473, 0.01137672,
     -0.01685408, 0.0201432, -0.00677187, 0.0050879, -0.0051118], np.float32)


def load_leg_vertex_ids() -> Optional[tuple[np.ndarray, np.ndarray]]:
    """(left_leg_ids, right_leg_ids) from `smpl_part_info.json`
    (`link_utils.py:78-79`), or None when the asset is absent."""
    from ipercore_tpu_torch.models.mesh import find_asset

    path = find_asset("smpl_part_info.json")
    if path is None:
        return None
    with open(path) as f:
        info = json.load(f)
    try:
        left = np.asarray(info["02_left_leg"]["vertex"], np.int64)
        right = np.asarray(info["03_right_leg"]["vertex"], np.int64)
    except KeyError:
        return None
    return left, right


def _posed_numpy(model, theta: np.ndarray) -> dict:
    """`get_details` of one theta on the model's device, back as numpy."""
    t = torch.as_tensor(np.asarray(theta, np.float32).reshape(1, -1), device=model.v_template.device)
    d = smpl_mod.get_details(model, t)
    return {"verts": d["verts"][0].cpu().numpy(), "cam": d["cam"][0].cpu().numpy()}


def _inner_leg_ids(model, leg_ids: np.ndarray, rate: float = 0.3,
                   right: bool = True) -> np.ndarray:
    """Inner-facing leg vertices: sorted by x in the rest pose with the
    linker's mean shape (`link_utils.py:86-117`)."""
    theta = np.zeros((1, 3 + model.pose_dim + 10), np.float32)
    theta[0, 0] = 1.0
    theta[0, -10:] = LINKER_MEAN_SHAPE
    verts = _posed_numpy(model, theta)["verts"]
    leg_ids = leg_ids[(leg_ids >= 0) & (leg_ids < len(verts))]
    x = verts[leg_ids, 0]
    n = int(len(leg_ids) * rate)
    order = np.argsort(x)
    return leg_ids[order[:n]] if right else leg_ids[order[::-1][:n]]


def smpl_link(model, theta: np.ndarray, skirt_y: float,
              leg_ids: Optional[tuple[np.ndarray, np.ndarray]] = None) -> np.ndarray:
    """Link inner leg vertices below the skirt hem to the opposite leg
    (`SmplLinker.link`, `link_utils.py:144-197`).

    Each inner-leg vertex whose projected y, `(y + cam_ty) * cam_s`, is at
    most `skirt_y` links to the opposite leg's nearest vertex by y, so the
    skinning moves both legs together under the skirt (`lbs(links_ids=)`).

    Args:
        theta: (85,) or (1, 85) cam + pose + shape; skirt_y: hem in NDC y.

    Returns:
        links_ids: (L, 3) int32 (from_vert, to_vert, flag = 1).
    """
    if leg_ids is None:
        leg_ids = load_leg_vertex_ids()
    if leg_ids is None:
        return np.zeros((0, 3), np.int32)
    left_ids, right_ids = leg_ids
    posed = _posed_numpy(model, theta)
    verts, cam = posed["verts"], posed["cam"]
    V = len(verts)
    left_ids = left_ids[(left_ids >= 0) & (left_ids < V)]
    right_ids = right_ids[(right_ids >= 0) & (right_ids < V)]
    if len(left_ids) == 0 or len(right_ids) == 0:
        return np.zeros((0, 3), np.int32)

    inner_r = _inner_leg_ids(model, right_ids, right=True)
    inner_l = _inner_leg_ids(model, left_ids, right=False)

    def _links(inner, opposite):
        # nearest opposite-leg vertex by y only (`link_utils.py:120-145`)
        dy = (verts[inner, 1][:, None] - verts[opposite, 1][None, :]) ** 2
        nearest = opposite[np.argmin(dy, axis=1)]
        keep = (verts[inner, 1] + cam[2]) * cam[0] <= skirt_y
        return inner[keep], nearest[keep]

    fr_r, to_r = _links(inner_r, left_ids)
    fr_l, to_l = _links(inner_l, right_ids)
    fr = np.concatenate([fr_r, fr_l])
    to = np.concatenate([to_r, to_l])
    return np.stack([fr, to, np.ones_like(fr)], axis=1).astype(np.int32)


def find_cloth_links_schp(parser, image: np.ndarray, theta: np.ndarray, model) -> tuple[bool, np.ndarray]:
    """Skirt / dress cloth links (`clothlinks_deformer.py:24-65`): the SCHP
    skirt+dress mask of `image`, its lowest row as the hem in NDC y, then
    `smpl_link`.

    Args:
        parser: a trained `tools/parsers.SchpParser`; image: (H, W, 3) in
            [-1, 1]; theta: (85,) of that frame.

    Returns:
        (found, links_ids (L, 3) int32).
    """
    found, masks = parser.run(image[None], target="skirt+dress")
    if not found or not len(masks) or masks[0].sum() == 0:
        return False, np.zeros((0, 3), np.int32)
    mask = masks[0]
    rows = np.nonzero(mask.any(axis=1))[0]
    links = smpl_link(model, theta, rows[-1] / mask.shape[0] * 2.0 - 1.0)
    return len(links) > 0, links


def find_cloth_links(verts: np.ndarray, cloth_mask_low_y: float) -> np.ndarray:
    """Link template vertices below the cloth hem (world y) to their nearest
    hem-ring vertex in the xz plane (`clothlinks_deformer.py:176`).

    Returns:
        links_ids: (L, 3) int32 (from_vert, to_vert, flag = 1).
    """
    below = np.nonzero(verts[:, 1] < cloth_mask_low_y)[0]
    ring = np.nonzero(
        (verts[:, 1] >= cloth_mask_low_y) & (verts[:, 1] < cloth_mask_low_y + 0.08))[0]
    if len(ring) == 0 or len(below) == 0:
        return np.zeros((0, 3), np.int32)
    d2 = ((verts[below][:, None, [0, 2]] - verts[ring][None, :, [0, 2]]) ** 2).sum(-1)
    nearest = ring[np.argmin(d2, axis=1)]
    flags = np.ones((len(below),), np.int32)
    return np.stack([below.astype(np.int32), nearest.astype(np.int32), flags], axis=1)
