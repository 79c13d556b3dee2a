"""Inference runners (imitator, viewer, swapper) as a functional pipeline.

Twin of `ipercore_tpu/models/imitator.py`:

  * `setup_source()` produces an immutable `SourceCache` (encoded SIDNet
    features, merged UV image, background), once per subject;
  * `synthesize_frames()` maps a batch of target SMPLs to frames;
  * `synthesize_frames_temporal()` feeds each prediction back as a temporal
    source, frame after frame (the JAX `lax.scan` is a loop here);
  * `make_novel_view_smpls` / `add_view_effect` / `add_bullet_time_effect`
    make the viewer's targets, `merge_source_caches` the swapper's source.

Kernel dispatch follows the device of the tensors: on CUDA the fused
raster+flow kernels and the grid-sample kernel run; on the CPU their plain
versions do. `IPERCORE_CSR_RASTER=0` selects the table-binned raster kernel
for the frame geometry, as in the JAX package. The synthesis functions run
without autograd.

Precision. The f32 path is the reference path: it runs with
`torch.backends.cudnn.allow_tf32 = False` and
`torch.backends.cuda.matmul.allow_tf32 = False` (see `reference_precision`),
because TF32 keeps about three decimal digits. `compute_dtype=torch.bfloat16`
is an explicit knob, off by default, for which no parity is claimed.

Spans (`utils.logging.span`): `setup.source` with `setup.body` (LBS),
`setup.render` (K3, morph), `setup.process`, `setup.bgnet` and `setup.srcnet`
inside; `prepare.targets`; and in `synthesize_frames` `synth.geometry`
(`make_frame_inputs`) then `synth.generator` (`generate_frames`).
"""
from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ipercore_tpu_torch.models import flow_composition as fc
from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.ops import rasterizer as rz
from ipercore_tpu_torch.ops import rotations as rot
from ipercore_tpu_torch.ops.rasterizer_cuda import TABLE_TILE_W, raster_flows, raster_flows_table
from ipercore_tpu_torch.ops.sampling_cuda import grid_sample_nhwc
from ipercore_tpu_torch.utils import camera as cam_utils
from ipercore_tpu_torch.utils.logging import span


def use_csr_raster() -> bool:
    """The fused frame geometry takes the exact CSR-binned kernel (K1) unless
    `IPERCORE_CSR_RASTER=0`, which selects the table-binned kernel (K4) with
    its per-tile capacity, as in the JAX package."""
    return os.environ.get("IPERCORE_CSR_RASTER", "1") != "0"


@contextlib.contextmanager
def reference_precision():
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls within the block
    and restore the previous settings after it."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


class SourceCache(NamedTuple):
    """Everything the per-frame loop needs about the source subject.

    src_enc_outs / src_res_outs: tuples of (1, ns, h_i, w_i, c_i) SIDNet stages;
    uv_img: (1, S, S, 3); bg_img: (1, S, S, 3);
    src_f2pts: (ns, F, 3, 2) flow sources; src_cam (ns, 3); src_shape (ns, 10).
    """

    src_enc_outs: tuple
    src_res_outs: tuple
    uv_img: torch.Tensor
    bg_img: torch.Tensor
    src_f2pts: torch.Tensor
    src_cam: torch.Tensor
    src_shape: torch.Tensor


@torch.no_grad()
def setup_source(
    comp: fc.FlowComposer,
    generator,
    src_img: torch.Tensor,
    src_smpl: torch.Tensor,
    masks: Optional[torch.Tensor] = None,
    bg_img: Optional[torch.Tensor] = None,
    offsets: torch.Tensor | float = 0.0,
    links_ids: Optional[torch.Tensor] = None,
    part_mask: Optional[torch.Tensor] = None,
) -> SourceCache:
    """One-time source processing. The generator holds its own weights, so
    there is no separate `params` argument as in the JAX twin.

    Args:
        src_img: (1, ns, S, S, 3) in [-1, 1]; src_smpl: (1, ns, 85);
        masks: optional (1, ns, S, S, 1), background = 1;
        bg_img: optional background (1, S, S, 3); otherwise BGNet inpaints it;
        part_mask: optional (F,) bool to restrict flows.
    """
    with span("setup.source"):
        bs, ns = src_img.shape[0], src_img.shape[1]
        S = comp.image_size

        with span("setup.body"):
            details = smpl_mod.get_details(comp.model, src_smpl.reshape(bs * ns, -1), offsets, links_ids)
        m_flat = masks.reshape(bs * ns, S, S, 1) if masks is not None else None
        with span("setup.render"):
            src_info = fc.render_smpl_info(
                comp, details["verts"], details["cam"], masks=m_flat, use_morph=True, get_uv_info=True)
        if m_flat is not None:
            src_info["masks"] = m_flat

        with span("setup.process"):
            uv_img, input_G_bg, input_G_src = fc.process_source(comp, src_img, src_info)

        with reference_precision():
            with span("setup.bgnet"):
                bg = generator.forward_bg(input_G_bg)[:, 0] if bg_img is None else bg_img
            with span("setup.srcnet"):
                enc_outs, res_outs = generator.forward_src(input_G_src, True)

        if part_mask is not None:
            src_info = fc.add_selected_f2pts(src_info, part_mask)
            f2pts = src_info["selected_f2pts"]
        else:
            f2pts = src_info["only_vis_f2pts"] if comp.only_vis else src_info["f2pts"]

        return SourceCache(
            src_enc_outs=tuple(enc_outs), src_res_outs=tuple(res_outs), uv_img=uv_img,
            bg_img=bg, src_f2pts=f2pts, src_cam=details["cam"], src_shape=details["shape"])


@torch.no_grad()
def infer_foot_y(model: smpl_mod.SMPLModel, smpls: np.ndarray, chunk: int = 64) -> np.ndarray:
    """Per-frame max body-vertex y (screen-down = lowest point) from the SMPL
    forward pass, with the shape locked to frame 0's betas.

    Args:
        smpls: (N, 85) host array.

    Returns:
        (N,) numpy foot-y track.
    """
    theta = np.asarray(smpls, np.float32).copy()
    theta[:, 75:] = theta[0:1, 75:]
    dev = model.v_template.device
    ys = []
    for i in range(0, len(theta), chunk):
        t = torch.as_tensor(theta[i:i + chunk], device=dev)
        ys.append(smpl_mod.get_details(model, t)["verts"][:, :, 1].amax(dim=1).cpu().numpy())
    return np.concatenate(ys)


def prepare_target_smpls(
    model: smpl_mod.SMPLModel,
    cache: SourceCache,
    tgt_smpls: np.ndarray,
    cam_strategy: str = "smooth",
    primary_id: int = 0,
) -> np.ndarray:
    """Sequence-level target preparation before synthesis: the camera is
    swapped so output framing follows the source person's camera (strategy
    "smooth" keeps the reference's motion deltas) and the body shape is
    replaced by the source's betas. Runs once per sequence on the host.

    Args:
        tgt_smpls: (N, 85) reference-video SMPLs.
        cam_strategy: smooth | source | ref_txty | copy.

    Returns:
        (N, 85) numpy SMPLs ready for `synthesize_frames`.
    """
    with span("prepare.targets"):
        smpls = np.asarray(tgt_smpls, np.float32)
        if cam_strategy == "smooth":
            foot_y = infer_foot_y(model, smpls)
            smpls = cam_utils.stabilize_smpls(smpls, foot_y)

        src_cam = np.broadcast_to(
            cache.src_cam[primary_id:primary_id + 1].cpu().numpy().astype(np.float32),
            (len(smpls), 3))
        src_shape = cache.src_shape[primary_id:primary_id + 1].cpu().numpy().astype(np.float32)
        first_cam = smpls[0:1, 0:3]
        new_cam = cam_utils.cam_swap(src_cam, smpls[:, 0:3], first_cam, cam_strategy)
        return np.concatenate(
            [new_cam, smpls[:, 3:75], np.repeat(src_shape, len(smpls), axis=0)], axis=1)


@torch.no_grad()
def make_frame_inputs(
    comp: fc.FlowComposer,
    cache: SourceCache,
    tgt_smpl: torch.Tensor,
    offsets: torch.Tensor | float = 0.0,
    links_ids: Optional[torch.Tensor] = None,
    tst_stride: Optional[int] = None,
    sample_dtype: Optional[torch.dtype] = None,
    full_ref_info: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Per-frame-batch geometry.

    Args:
        tgt_smpl: (T, 85) target SMPL batch.
        tst_stride: subsample factor for the Tst feature-warping flow; the
            finest feature warp runs at S/2, so stride 2 loses nothing
            downstream. Default: 2 when S >= 512, else 1.
        sample_dtype: optional dtype (torch.bfloat16) of the UV image for the
            UV warp; coordinates stay f32.
        full_ref_info: take the unfused branch (`render_smpl_info` +
            `cal_bc_transform`) that also returns wim and f2pts. The table
            route (`IPERCORE_CSR_RASTER=0`) takes that branch too where S is
            not a multiple of 128, as the JAX package does off its Pallas
            route.

    Returns:
        tsf_inputs (T, S, S, 6), Tst (T, ns, S/stride, S/stride, 2), ref_info.
    """
    T = tgt_smpl.shape[0]
    ns = cache.src_f2pts.shape[0]
    S = comp.image_size
    if tst_stride is None:
        tst_stride = 2 if S >= 512 else 1

    details = smpl_mod.get_details(comp.model, tgt_smpl, offsets, links_ids)

    csr = use_csr_raster()
    if not full_ref_info and (csr or S % TABLE_TILE_W == 0):
        # fused path: one pass emits fim, the UV flow and all source flows
        proj = rz.project_verts(details["verts"], details["cam"])
        face_verts = rz.verts_to_faces(proj, comp.model.faces)  # (T, F, 3, 3)
        aux = torch.cat([comp.assets.f2uvs[None], cache.src_f2pts], dim=0)  # (1+ns, F, 3, 2)
        if csr:
            fim, flows = raster_flows(face_verts, aux, S)
        else:
            fim, flows = raster_flows_table(face_verts, aux, S)
        cond = rz.encode_fim(fim, comp.assets.map_fn)
        ref_info = {"fim": fim, "cond": cond, "cam": details["cam"],
                    "verts": details["verts"], "j2d": details["j2d"]}
        Tuv2t = flows[..., 0, :]  # (T, S, S, 2)
        Tst = flows[:, ::tst_stride, ::tst_stride, 1:, :].permute(0, 3, 1, 2, 4)
    else:
        ref_info = fc.render_smpl_info(
            comp, details["verts"], details["cam"], use_morph=False,
            get_uv_info=False, need_vis=False)
        f2uvs = comp.assets.f2uvs.expand((T,) + tuple(comp.assets.f2uvs.shape))
        Tuv2t = rz.cal_bc_transform(f2uvs, ref_info["fim"], ref_info["wim"])
        fim_s = ref_info["fim"][:, ::tst_stride, ::tst_stride]
        wim_s = ref_info["wim"][:, ::tst_stride, ::tst_stride]
        Sf = fim_s.shape[1]
        src_rep = cache.src_f2pts[None].expand((T,) + tuple(cache.src_f2pts.shape)).reshape(
            T * ns, -1, 3, 2)
        Tst = rz.cal_bc_transform(
            src_rep, torch.repeat_interleave(fim_s, ns, dim=0),
            torch.repeat_interleave(wim_s, ns, dim=0)).reshape(T, ns, Sf, Sf, 2)

    # Tuv2t warp of the UV image: the warp the JAX package gives to its Pallas
    # sampler, so here it goes to the grid-sample kernel (plain version on CPU)
    uv_img = cache.uv_img if sample_dtype is None else cache.uv_img.to(sample_dtype)
    tsf_inputs = _warp_uv_beside(uv_img, Tuv2t, ref_info["cond"])  # (T, S, S, 6)
    return tsf_inputs, Tst, ref_info


def _warp_uv_beside(uv_img: torch.Tensor, grid: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """`cat([grid_sample(uv_img, grid), cond], -1)` without the concatenation:
    the sampler writes the first channels of the (T, S, S, 3 + C) result and
    reads `grid` (T, S, S, 2) through its pixel stride, so the UV flow needs no
    copy out of the flows; `cond` fills the other channels. uv_img
    (1, S', S', 3) is shared by the batch."""
    T = grid.shape[0]
    out = torch.empty(tuple(cond.shape[:-1]) + (3 + cond.shape[-1],), dtype=torch.float32,
                      device=cond.device)
    grid_sample_nhwc(uv_img.expand((T,) + tuple(uv_img.shape[1:])), grid, out=out[..., :3])
    out[..., 3:] = cond
    return out


@torch.no_grad()
def synthesize_frames(
    comp: fc.FlowComposer,
    generator,
    cache: SourceCache,
    tgt_smpl: torch.Tensor,
    offsets: torch.Tensor | float = 0.0,
    links_ids: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
    tst_stride: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Synthesize a batch of frames — the hot path.

    Args:
        tgt_smpl: (T, 85).
        compute_dtype: optional lower precision (torch.bfloat16) for the
            generator, applied with autocast; geometry and flows stay f32 and
            outputs are cast back. None is the f32 reference path (TF32 off).
        tst_stride: override the Tst flow subsampling (None = resolution
            default).

    Returns:
        preds (T, S, S, 3) composited frames in [-1, 1];
        masks (T, S, S, 1) predicted attention masks (1 = background).
    """
    with span("synth.geometry"):
        tsf_inputs, Tst, _ = make_frame_inputs(
            comp, cache, tgt_smpl, offsets, links_ids, sample_dtype=compute_dtype,
            tst_stride=tst_stride)
    with span("synth.generator"):
        return generate_frames(generator, cache, tsf_inputs, Tst, compute_dtype)


@torch.no_grad()
def generate_frames(
    generator,
    cache: SourceCache,
    tsf_inputs: torch.Tensor,
    Tst: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The generator and the composite over the background on a batch's
    geometry (`make_frame_inputs`): preds (T, S, S, 3), masks (T, S, S, 1)."""
    T = tsf_inputs.shape[0]
    rep = lambda x: x.expand((T,) + tuple(x.shape[1:]))  # (1, ns, ...) -> (T, ns, ...)
    enc = [rep(e) for e in cache.src_enc_outs]
    res = [rep(r) for r in cache.src_res_outs]

    if compute_dtype is None:
        with reference_precision():
            tsf_img, tsf_mask = generator.forward_tsf(tsf_inputs, enc, res, Tst)
    else:
        with torch.autocast(device_type=tsf_inputs.device.type, dtype=compute_dtype):
            tsf_img, tsf_mask = generator.forward_tsf(tsf_inputs, enc, res, Tst)
    tsf_img = tsf_img.float()
    tsf_mask = tsf_mask.float()

    bg = cache.bg_img.expand((T,) + tuple(cache.bg_img.shape[1:]))
    pred = tsf_mask * bg + (1.0 - tsf_mask) * tsf_img
    return pred, tsf_mask


# ---------------------------------------------------------------------------
# Temporal mode: the previous prediction fed back as an extra source
# ---------------------------------------------------------------------------


@torch.no_grad()
def make_temporal_inputs_fused(
    comp: fc.FlowComposer,
    cache: SourceCache,
    tgt_smpl: torch.Tensor,
    offsets: torch.Tensor | float = 0.0,
    links_ids: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Temporal-mode geometry in one fused raster pass: the per-frame aux
    carries the previous frame's screen coordinates beside the UV and source
    ones, so the frame-to-frame flow Ttt costs no extra raster (K1 with
    per-frame aux (T, 2 + ns, F, 3, 2), then the UV warp).

    Returns:
        tsf_inputs (T, S, S, 6), Tst (T, ns, S/st, S/st, 2), Ttt (T, S, S, 2).
    """
    S = comp.image_size
    T = tgt_smpl.shape[0]
    ns = cache.src_f2pts.shape[0]
    details = smpl_mod.get_details(comp.model, tgt_smpl, offsets, links_ids)
    face_verts = rz.verts_to_faces(rz.project_verts(details["verts"], details["cam"]),
                                   comp.model.faces)  # (T, F, 3, 3)
    f2pts_seq = face_verts[..., :2]
    prev_f2pts = torch.cat([f2pts_seq[:1], f2pts_seq[:-1]], dim=0)
    shared = torch.cat([comp.assets.f2uvs[None], cache.src_f2pts], dim=0)  # (1+ns, F, 3, 2)
    aux = torch.cat([shared[None].expand((T,) + tuple(shared.shape)), prev_f2pts[:, None]],
                    dim=1)  # (T, 2+ns, F, 3, 2)
    fim, flows = raster_flows(face_verts, aux, S)
    cond = rz.encode_fim(fim, comp.assets.map_fn)
    st = 2 if S >= 512 else 1  # the finest feature warp runs at S/2
    Tst = flows[:, ::st, ::st, 1:1 + ns, :].permute(0, 3, 1, 2, 4)
    Ttt = flows[..., 1 + ns, :]
    return _warp_uv_beside(cache.uv_img, flows[..., 0, :], cond), Tst, Ttt


@torch.no_grad()
def synthesize_frames_temporal(
    comp: fc.FlowComposer,
    generator,
    cache: SourceCache,
    tgt_smpl: torch.Tensor,
    offsets: torch.Tensor | float = 0.0,
    links_ids: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Temporal-mode synthesis: frames run one after another, each with the
    previous prediction as an extra source. The feedback is the JAX twin's
    (and training's): the foreground-masked previous image next to the warped
    UV appearance of the previous input. The geometry is always the fused
    pass (`make_temporal_inputs_fused`): the plain K1 takes per-frame aux on
    the CPU too, so the JAX package's non-Pallas branch has no use here.

    Args:
        tgt_smpl: (T, 85).

    Returns:
        preds (T, S, S, 3) in [-1, 1]; masks (T, S, S, 1).
    """
    T = tgt_smpl.shape[0]
    S = comp.image_size
    tsf_inputs, Tst, Ttt = make_temporal_inputs_fused(comp, cache, tgt_smpl, offsets, links_ids)

    prev_img = torch.zeros((S, S, 3), dtype=tsf_inputs.dtype, device=tsf_inputs.device)
    prev_mask = torch.ones((S, S, 1), dtype=tsf_inputs.dtype, device=tsf_inputs.device)
    prev_syn = tsf_inputs[0, ..., 0:3]
    preds, masks = [], []
    with reference_precision():
        for t in range(T):
            temp_in = torch.cat([prev_img * (1.0 - prev_mask), prev_syn], dim=-1)[None, None]
            temp_enc, temp_res = generator.forward_src(temp_in, True)
            img, mask = generator.forward_tsf(
                tsf_inputs[t:t + 1], cache.src_enc_outs, cache.src_res_outs, Tst[t:t + 1],
                temp_enc, temp_res, Ttt[t][None, None])
            preds.append(mask[0] * cache.bg_img[0] + (1.0 - mask[0]) * img[0])
            masks.append(mask[0])
            prev_img, prev_mask, prev_syn = img[0], mask[0], tsf_inputs[t, ..., 0:3]
    return torch.stack(preds), torch.stack(masks)


# ---------------------------------------------------------------------------
# Viewer: target SMPLs from rotations of the global orientation
# ---------------------------------------------------------------------------


def make_novel_view_smpls(src_smpl: torch.Tensor, n_frames: int = 180,
                          use_t_pose: bool = False) -> torch.Tensor:
    """A 360-degree ring about the y axis: (85,) source SMPL -> (n_frames, 85),
    frame i turned by 2*pi*i/n_frames; `use_t_pose` zeroes the body pose
    (global orientation kept)."""
    base = src_smpl.expand(n_frames, 85).clone()
    if use_t_pose:
        base[:, 6:75] = 0.0
    angles = torch.arange(n_frames, dtype=base.dtype, device=base.device) * (2.0 * np.pi / n_frames)
    zeros = torch.zeros_like(angles)
    ring = rot.rodrigues(torch.stack([zeros, angles, zeros], dim=-1))
    base[:, 3:6] = rot.rotmat_to_axis_angle(ring @ rot.rodrigues(base[:, 3:6]))
    return base


def add_view_effect(smpls: torch.Tensor, angle_deg: float) -> torch.Tensor:
    """Turn every frame's global orientation by `angle_deg` about the y axis."""
    a = torch.deg2rad(torch.tensor(angle_deg, dtype=smpls.dtype, device=smpls.device))
    R = rot.rodrigues(torch.stack([torch.zeros_like(a), a, torch.zeros_like(a)]))
    out = smpls.clone()
    out[:, 3:6] = rot.rotmat_to_axis_angle(R[None] @ rot.rodrigues(smpls[:, 3:6]))
    return out


def add_bullet_time_effect(smpls: torch.Tensor, frame_ids: list[int],
                           duration: int = 60) -> torch.Tensor:
    """Freeze the pose at each of `frame_ids` and insert a 360-degree ring of
    `duration` frames after it. The output length depends on the data, so the
    splicing runs on the host."""
    s = smpls.cpu().numpy()
    out, prev = [], 0
    for fid in sorted(frame_ids):
        fid = min(max(fid, 0), len(s) - 1)
        out.append(s[prev:fid + 1])
        out.append(make_novel_view_smpls(torch.as_tensor(s[fid]), n_frames=duration).numpy())
        prev = fid + 1
    out.append(s[prev:])
    return torch.as_tensor(np.concatenate(out, axis=0), device=smpls.device)


# ---------------------------------------------------------------------------
# Swapper: merge several people's caches by part selection
# ---------------------------------------------------------------------------


def merge_source_caches(comp: fc.FlowComposer, caches: list[SourceCache],
                        part_masks: list[torch.Tensor]) -> SourceCache:
    """Merge per-person source caches for appearance transfer: features are
    concatenated along the source axis, each person's flow sources keep only
    its selected faces, and the UV images are merged by visibility.

    Args:
        caches: one SourceCache per person, the primary first;
        part_masks: (F,) bool per person.
    """
    enc = [torch.cat(xs, dim=1) for xs in zip(*[c.src_enc_outs for c in caches])]
    res = [torch.cat(xs, dim=1) for xs in zip(*[c.src_res_outs for c in caches])]
    f2pts = torch.cat([
        rz.select_f2pts(c.src_f2pts, m.expand((c.src_f2pts.shape[0],) + tuple(m.shape)))
        for c, m in zip(caches, part_masks)], dim=0)
    uv_imgs = torch.cat([c.uv_img for c in caches], dim=0)  # (P, S, S, 3)
    vis = (uv_imgs.abs().sum(dim=-1, keepdim=True) > 1e-6).to(uv_imgs.dtype)
    return SourceCache(
        src_enc_outs=tuple(enc), src_res_outs=tuple(res),
        uv_img=fc.merge_uv_img(uv_imgs, vis)[None], bg_img=caches[0].bg_img,
        src_f2pts=f2pts,
        src_cam=torch.cat([c.src_cam for c in caches], dim=0),
        src_shape=torch.cat([c.src_shape for c in caches], dim=0))
