"""Motion imitation in plain PyTorch: the UV template raster, the source
set-up, the target camera preparation and a batch of frames.

iPERCore's imitator as the port implements it (`setup_source`,
`prepare_target_smpls(cam_strategy="smooth")`, `synthesize_frames`), over
`geometry` and `generator` of this folder. Departures, none of which changes
a result: the frame flows come from the raster's maps (`bc_flow`) where the
program fuses them into its raster kernel; the UV image is warped by
`torch.nn.functional.grid_sample` where the program uses its own kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import geometry as g
from portbench.reference.generator import grid_sample


class Composer:
    """The body, its per-face tables and the UV template's raster."""

    def __init__(self, body: g.Body, mesh: dict, size: int, bg_ks: int = 11,
                 conf_erode_ks: int = 3, out_dilate_ks: int = 51):
        dev = body.faces.device
        t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt), device=dev)
        self.body, self.size = body, size
        self.f2uvs = t(mesh["f2uvs"], np.float32)
        self.map_fn = t(mesh["map_fn"], np.float32)
        self.knn = t(mesh["face_k_nearest"], np.int64)
        self.bg_ks, self.conf_erode_ks, self.out_dilate_ks = bg_ks, conf_erode_ks, out_dilate_ks
        z = torch.ones(self.f2uvs.shape[:-1] + (1,), device=dev)
        self.uv_fim, self.uv_wim = g.rasterize(torch.cat([self.f2uvs, z], dim=-1), size)


def dilate(mask, ks):
    if ks <= 1:
        return mask
    return F.max_pool2d(mask.permute(0, 3, 1, 2), ks, stride=1, padding=ks // 2).permute(0, 2, 3, 1)


def erode(mask, ks):
    return -dilate(-mask, ks)


def _sum3x3(x):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=1, padding=1,
                        divisor_override=1).permute(0, 2, 3, 1)


def boundary_fill(img, known, target, iters):
    """Fill the target ring by diffusing colour from the known pixels, one
    pixel of front a step."""
    cur, kn = img * known, known
    for _ in range(iters):
        fill = _sum3x3(cur * kn) / torch.clamp(_sum3x3(kn), min=1.0)
        newly = (_sum3x3(kn) > 0).to(kn.dtype) * target * (1.0 - kn)
        cur = cur * kn + fill * newly + cur * (1.0 - kn) * (1.0 - newly)
        kn = torch.clamp(kn + newly, 0.0, 1.0)
    return cur


def source_inputs(comp: Composer, src_img: torch.Tensor, theta: torch.Tensor,
                  masks: torch.Tensor | None = None) -> dict:
    """The source side of the composition for views src_img (1, ns, S, S, 3)
    with SMPLs theta (ns, 85) and optional person masks (ns, S, S, 1),
    background = 1: the merged UV image, BGNet's input (1, 1, S, S, 4),
    SIDNet's input (1, ns, S, S, 6) and the views' flow points."""
    ns, S = src_img.shape[1], comp.size
    fv = g.face_verts_of(comp.body, theta)
    f2pts = fv[..., 0:2]
    fim, wim = g.rasterize_batch(fv, S)
    cond = g.encode_fim(fim, comp.map_fn)
    vis = g.expand_by_knn(g.visible_faces(fim, fv.shape[1]), comp.knn)
    vis_f2pts = torch.where(vis[..., None, None], f2pts, torch.full_like(f2pts, g.FLOW_SENTINEL))
    body_sil = (cond.amax(dim=-1, keepdim=True) > 1e-6).to(cond.dtype)
    human_sil = (1.0 - masks) if masks is not None else body_sil
    confident = erode(human_sil, comp.conf_erode_ks)
    outpad = dilate(torch.clamp(human_sil + body_sil, 0.0, 1.0), comp.out_dilate_ks)

    flat = src_img.reshape(ns, S, S, 3)
    uncertain = torch.clamp(outpad * (1.0 - confident), 0.0, 1.0)
    morph = boundary_fill(flat, confident, uncertain,
                          comp.out_dilate_ks // 2 + comp.conf_erode_ks // 2 + 2)

    # the views merged in UV space: the first wins where it sees the face
    uv_fim = comp.uv_fim.expand(ns, S, S)
    uv_wim = comp.uv_wim.expand(ns, S, S, 3)
    warp_uv = grid_sample(morph, g.bc_flow(f2pts, uv_fim, uv_wim)).reshape(1, ns, S, S, 3)
    ones = torch.ones((ns, S, S, 1), device=src_img.device)
    vis_uv = dilate(grid_sample(ones, g.bc_flow(vis_f2pts, uv_fim, uv_wim)), 13).reshape(1, ns, S, S, 1)
    vis_sum = vis_uv[:, 1:].sum(dim=1)
    others = (warp_uv[:, 1:] * vis_uv[:, 1:]).sum(dim=1) / (vis_sum + 1e-5)
    front_invisible = (1.0 - vis_uv[:, 0]) * (vis_sum >= 1.0).to(src_img.dtype)
    uv_img = warp_uv[:, 0] * (1.0 - front_invisible) + others * front_invisible

    if masks is None:
        masks = (cond.amax(dim=-1, keepdim=True) <= 1e-6).to(src_img.dtype)
    bg_mask = erode(masks, comp.bg_ks)
    bg_in = torch.cat([flat * bg_mask, bg_mask], dim=-1).reshape(1, ns, S, S, 4)[:, 0:1]
    src_in = torch.cat([morph, cond], dim=-1).reshape(1, ns, S, S, 6)
    return {"uv_img": uv_img, "bg_in": bg_in, "src_in": src_in, "f2pts": f2pts}


def setup_source(comp: Composer, gen, src_img: torch.Tensor, src_smpl: torch.Tensor) -> dict:
    """src_img (1, ns, S, S, 3), src_smpl (1, ns, 85): the merged UV image,
    the inpainted background, SIDNet's stages, the source flow points and the
    source cameras and shapes."""
    theta = src_smpl.reshape(src_img.shape[1], -1)
    inputs = source_inputs(comp, src_img, theta)
    bg = gen.forward_bg(inputs["bg_in"])[:, 0]
    enc, res = gen.forward_src(inputs["src_in"])
    return {"uv_img": inputs["uv_img"], "bg": bg, "enc": enc, "res": res, "f2pts": inputs["f2pts"],
            "cam": theta[:, 0:3], "shape": theta[:, 75:]}


def _checkpoints(y):
    sign = np.sign(np.diff(y))
    last, filled = 0.0, np.zeros_like(sign)
    for i, s in enumerate(sign):
        if s != 0:
            last = s
        filled[i] = last
    ck = [0] + [i for i in range(1, len(filled)) if filled[i - 1] * filled[i] < 0]
    return ck + [len(y) - 1]


def _jumps(foot, up_th=0.2, down_th=0.1):
    n, out, ground = foot.shape[0], [], foot[0]
    ck = _checkpoints(foot)
    jumping, start = False, None
    for idx in range(1, len(ck)):
        i, i_1 = ck[idx], ck[idx - 1]
        if foot[i] - foot[i_1] < 0 and abs(foot[i] - foot[i_1]) > up_th:
            jumping = True
            start = next((f for f in range(i_1, i) if foot[f] < ground), i_1)
        elif jumping:
            if foot[i] < foot[start] and abs(foot[i] - foot[start]) > down_th:
                continue
            jumping = False
            out.append((start, i))
            start = None
    if jumping:
        out.append((start, n - 1))
    return out


def prepare_target_smpls(comp: Composer, src: dict, tgt: np.ndarray) -> np.ndarray:
    """Foot-contact stabilisation and the "smooth" camera swap: (N, 85) -> (N, 85)."""
    smpls = np.asarray(tgt, np.float32)
    theta = smpls.copy()
    theta[:, 75:] = theta[0:1, 75:]
    dev = comp.body.faces.device
    ys = []
    for i in range(0, len(theta), 64):
        t = torch.as_tensor(theta[i:i + 64], device=dev)
        ys.append(g.verts_of(comp.body, t)[:, :, 1].amax(dim=1).cpu().numpy())
    foot = np.concatenate(ys).astype(np.float32)

    st = np.array(smpls, np.float32)
    cam_y = st[:, 2].copy()
    new_y = cam_y[0] + (foot[0] - foot)
    for s, e in _jumps(foot + cam_y):
        new_y[s:e + 1] = np.minimum(cam_y[s:e + 1], new_y[s:e + 1])
    st[:, 0], st[:, 1], st[:, 2] = 1.0, 0.0, new_y
    st[:, 75:] = st[0:1, 75:]

    src_cam = np.broadcast_to(src["cam"][0:1].cpu().numpy().astype(np.float32), (len(st), 3))
    first = st[0:1, 0:3]
    delta = st[:, 1:3] - first[:, 1:]
    s = src_cam[:, 0:1] * st[:, 0:1] / first[:, 0:1]
    cam = np.concatenate([s, src_cam[:, 1:] + delta], axis=1)
    shape = src["shape"][0:1].cpu().numpy().astype(np.float32)
    return np.concatenate([cam, st[:, 3:75], np.repeat(shape, len(st), axis=0)], axis=1)


def synthesize(comp: Composer, gen, src: dict, smpls: torch.Tensor) -> torch.Tensor:
    """Frames (T, S, S, 3) in [-1, 1] of prepared target SMPLs (T, 85)."""
    return synthesize_faces(comp, gen, src, g.face_verts_of(comp.body, smpls))


def synthesize_faces(comp: Composer, gen, src: dict, fv: torch.Tensor,
                     block: int | None = None) -> torch.Tensor:
    """Frames (T, S, S, 3) of projected per-face vertices (T, F, 3, 3), the
    raster, flows and generator run `block` frames at a time (all at once by
    default): everything after the skinning is frame by frame, so the
    blocks change no result beyond the generator's rounding across batch
    sizes."""
    if block is not None and fv.shape[0] > block:
        return torch.cat([synthesize_faces(comp, gen, src, fv[i:i + block])
                          for i in range(0, fv.shape[0], block)])
    T, S = fv.shape[0], comp.size
    ns = src["f2pts"].shape[0]
    fim, wim = g.rasterize_batch(fv, S)
    cond = g.encode_fim(fim, comp.map_fn)
    uv_flow = g.bc_flow(comp.f2uvs.expand((T,) + tuple(comp.f2uvs.shape)), fim, wim)
    tsf_in = torch.cat([grid_sample(src["uv_img"].expand(T, S, S, 3), uv_flow), cond], dim=-1)
    st = 2 if S >= 512 else 1  # the finest feature warp runs at S / 2
    fim_s = torch.repeat_interleave(fim[:, ::st, ::st], ns, dim=0)
    wim_s = torch.repeat_interleave(wim[:, ::st, ::st], ns, dim=0)
    src_rep = src["f2pts"][None].expand((T,) + tuple(src["f2pts"].shape)).reshape((T * ns,) + tuple(src["f2pts"].shape[1:]))
    Tst = g.bc_flow(src_rep, fim_s, wim_s).reshape(T, ns, S // st, S // st, 2)
    rep = lambda x: x.expand((T,) + tuple(x.shape[1:]))
    img, mask = gen.forward_tsf(tsf_in, [rep(e) for e in src["enc"]], [rep(r) for r in src["res"]], Tst)
    return mask * src["bg"].expand(T, S, S, 3) + (1.0 - mask) * img
