"""Flow composition: SMPL geometry -> generator inputs (UV merge, flows, conds).

Twin of `ipercore_tpu/models/flow_composition.py`: a function library over a
static `FlowComposer` context (body model, mesh assets, pre-rasterized UV
template), for inference and for the training-phase composition (`forward`,
`make_trans_flow`, `make_batch_trans_flow`). Its rasters go through
`rasterize_batch`, so through the `raster_fim` kernel on a CUDA device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.models.mesh import MeshAssets, load_assets
from ipercore_tpu_torch.ops import rasterizer as rz
from ipercore_tpu_torch.ops.morphology import dilate, erode
from ipercore_tpu_torch.ops.sampling import grid_sample


class FlowComposer(NamedTuple):
    """Static context for flow composition.

    model: SMPL body model; assets: mesh/UV tables;
    uv_fim/uv_wim: (S, S) / (S, S, 3) raster of the UV template;
    image_size: S; bg_ks/conf_erode_ks/out_dilate_ks: morphology kernels;
    only_vis: restrict flows to visible faces.
    """

    model: smpl_mod.SMPLModel
    assets: MeshAssets
    uv_fim: torch.Tensor
    uv_wim: torch.Tensor
    image_size: int
    bg_ks: int
    conf_erode_ks: int
    out_dilate_ks: int
    only_vis: bool


def make_composer(
    model: smpl_mod.SMPLModel,
    assets: Optional[MeshAssets] = None,
    image_size: int = 256,
    bg_ks: int = 11,
    conf_erode_ks: int = 3,
    out_dilate_ks: int = 51,
    only_vis: bool = False,
    raster_chunk: int | None = None,
) -> FlowComposer:
    """Build the static composer context on the model's device (rasterizes the
    UV template once)."""
    if assets is None:
        assets = load_assets(model, device=model.v_template.device)
    uv = rz.rasterize_uv_template(assets.f2uvs, image_size, chunk=raster_chunk)
    return FlowComposer(
        model=model, assets=assets, uv_fim=uv.fim, uv_wim=uv.wim,
        image_size=image_size, bg_ks=bg_ks, conf_erode_ks=conf_erode_ks,
        out_dilate_ks=out_dilate_ks, only_vis=only_vis)


def render_smpl_info(
    comp: FlowComposer,
    verts: torch.Tensor,
    cam: torch.Tensor,
    masks: Optional[torch.Tensor] = None,
    use_morph: bool = False,
    get_uv_info: bool = True,
    need_vis: bool = True,
    raster_chunk: int | None = None,
) -> dict:
    """Render per-frame geometry products.

    Args:
        verts: (N, V, 3); cam: (N, 3); masks: optional (N, S, S, 1) with
            background = 1, human = 0.

    Returns dict: f2pts (N, F, 3, 2), fim (N, S, S), wim (N, S, S, 3),
        cond (N, S, S, 3); vis_mask (N, F) bool and only_vis_f2pts when
        visibility is needed; obj_f2pts / only_vis_obj_f2pts when get_uv_info;
        human_sil / confidant_sil / outpad_sil (N, S, S, 1) when use_morph.
    """
    S = comp.image_size
    f2pts, fim, wim = rz.render_fim_wim(verts, cam, comp.model.faces, S, chunk=raster_chunk)
    cond = rz.encode_fim(fim, comp.assets.map_fn)

    info = {"f2pts": f2pts, "fim": fim, "wim": wim, "cond": cond}

    if need_vis or comp.only_vis or use_morph or get_uv_info:
        vis = rz.visible_face_mask(fim, comp.model.faces.shape[0])
        vis = rz.expand_mask_by_knn(vis, comp.assets.face_k_nearest)
        info["vis_mask"] = vis
        info["only_vis_f2pts"] = rz.select_f2pts(f2pts, vis)

    # background colour is black, so any non-zero channel = body
    body_sil = (cond.amax(dim=-1, keepdim=True) > 1e-6).to(cond.dtype)

    if use_morph:
        human_sil = (1.0 - masks) if masks is not None else body_sil
        info["human_sil"] = human_sil
        info["confidant_sil"] = erode(human_sil, comp.conf_erode_ks)
        union = torch.clamp(human_sil + body_sil, 0.0, 1.0)
        info["outpad_sil"] = dilate(union, comp.out_dilate_ks)

    if get_uv_info:
        info["obj_f2pts"] = f2pts
        info["only_vis_obj_f2pts"] = info["only_vis_f2pts"]

    return info


def _sum3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 window sum with zero padding over the H, W axes of NHWC (a pooling
    sum, so no TF32 product can enter it)."""
    out = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=1, padding=1, divisor_override=1)
    return out.permute(0, 2, 3, 1)


def boundary_fill(img: torch.Tensor, known: torch.Tensor, target: torch.Tensor,
                  iters: int = 16) -> torch.Tensor:
    """Fill `target` pixels by iteratively diffusing RGB from `known` pixels:
    each iteration fills unknown target pixels with the 3x3 average of
    already-known neighbours, extending the front by 1 px.

    Args:
        img: (N, S, S, 3); known: (N, S, S, 1) 1 = trusted pixel;
        target: (N, S, S, 1) 1 = pixel to (re)fill.

    Returns:
        (N, S, S, 3): trusted pixels kept, target ring filled, rest zeroed.
    """
    cur = img * known
    kn = known
    for _ in range(iters):
        window_sum = _sum3x3(cur * kn)
        count = _sum3x3(kn)
        fill = window_sum / torch.clamp(count, min=1.0)
        newly = (count > 0).to(kn.dtype) * target * (1.0 - kn)
        cur = cur * kn + fill * newly + cur * (1.0 - kn) * (1.0 - newly)
        kn = torch.clamp(kn + newly, 0.0, 1.0)
    return cur


def morph_fill_iters(comp: FlowComposer) -> int:
    """Iterations `boundary_fill` needs to reach every pixel of the uncertain
    ring: the dilation radius plus the erosion radius plus two."""
    return comp.out_dilate_ks // 2 + comp.conf_erode_ks // 2 + 2


def make_morph_image(comp: FlowComposer, src_img: torch.Tensor, src_info: dict) -> torch.Tensor:
    """Confident-silhouette image with the uncertain ring filled.
    src_img: (N, S, S, 3) in [-1, 1]."""
    confidant = src_info["confidant_sil"]
    outpad = src_info["outpad_sil"]
    uncertain = torch.clamp(outpad * (1.0 - confidant), 0.0, 1.0)
    return boundary_fill(src_img, confidant, uncertain, iters=morph_fill_iters(comp))


def make_uv_img(comp: FlowComposer, src_img: torch.Tensor, src_info: dict) -> torch.Tensor:
    """Merge source views into one UV-space texture image.

    Args:
        src_img: (bs, ns, S, S, 3) morphed source images; src_info rendered
            over (bs * ns).

    Returns:
        (bs, S, S, 3): the first source wins where it is visible; other views
        fill its invisible regions (visibility-count normalized, visibility
        dilated with ks = 13).
    """
    bs, ns, S = src_img.shape[0], src_img.shape[1], comp.image_size
    n = bs * ns
    uv_fim = comp.uv_fim.expand(n, S, S)
    uv_wim = comp.uv_wim.expand(n, S, S, 3)

    Ts2uv = rz.cal_bc_transform(src_info["obj_f2pts"], uv_fim, uv_wim)
    vis_Ts2uv = rz.cal_bc_transform(src_info["only_vis_obj_f2pts"], uv_fim, uv_wim)

    flat_img = src_img.reshape(n, S, S, 3)
    warp_uv = grid_sample(flat_img, Ts2uv).reshape(bs, ns, S, S, 3)
    one_map = torch.ones((n, S, S, 1), dtype=src_img.dtype, device=src_img.device)
    vis_uv = grid_sample(one_map, vis_Ts2uv)
    vis_uv = dilate(vis_uv, 13).reshape(bs, ns, S, S, 1)

    vis_sum = vis_uv[:, 1:].sum(dim=1)
    others = (warp_uv[:, 1:] * vis_uv[:, 1:]).sum(dim=1) / (vis_sum + 1e-5)
    vis_front = vis_uv[:, 0]
    vis_other = (vis_sum >= 1.0).to(src_img.dtype)
    front_invisible = (1.0 - vis_front) * vis_other
    return warp_uv[:, 0] * (1.0 - front_invisible) + others * front_invisible


def make_bg_inputs(comp: FlowComposer, src_img: torch.Tensor, src_info: dict,
                   masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, S, S, 4) masked RGB + eroded background mask. masks: (N, S, S, 1)
    background = 1."""
    if masks is None:
        cond = src_info["cond"]
        masks = (cond.amax(dim=-1, keepdim=True) <= 1e-6).to(src_img.dtype)
    bg_mask = erode(masks, comp.bg_ks)
    return torch.cat([src_img * bg_mask, bg_mask], dim=-1)


def make_src_inputs(src_img: torch.Tensor, src_info: dict) -> torch.Tensor:
    """(N, S, S, 6) morphed RGB + condition."""
    return torch.cat([src_img, src_info["cond"]], dim=-1)


def make_tsf_inputs(comp: FlowComposer, uv_img: torch.Tensor, ref_info: dict) -> torch.Tensor:
    """(bs, nt, S, S, 6) UV-warped synthetic image + target condition.
    uv_img: (bs, S, S, 3); ref_info rendered over (bs * nt) frames."""
    S = comp.image_size
    bsnt = ref_info["fim"].shape[0]
    bs = uv_img.shape[0]
    nt = bsnt // bs
    f2uvs = comp.assets.f2uvs.expand((bsnt,) + tuple(comp.assets.f2uvs.shape))
    Tuv2t = rz.cal_bc_transform(f2uvs, ref_info["fim"], ref_info["wim"])
    uv_rep = torch.repeat_interleave(uv_img, nt, dim=0)
    syn = grid_sample(uv_rep, Tuv2t)
    tsf = torch.cat([syn, ref_info["cond"]], dim=-1)
    return tsf.reshape(bs, nt, S, S, 6)


def process_source(comp: FlowComposer, src_img: torch.Tensor, src_info: dict,
                   primary_ids: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Source-side inputs.

    Args:
        src_img: (bs, ns, S, S, 3).

    Returns:
        uv_img (bs, S, S, 3), input_G_bg (bs, 1, S, S, 4),
        input_G_src (bs, ns, S, S, 6).
    """
    bs, ns, S = src_img.shape[0], src_img.shape[1], comp.image_size
    flat = src_img.reshape(bs * ns, S, S, 3)
    morph_img = make_morph_image(comp, flat, src_info)
    uv_img = make_uv_img(comp, morph_img.reshape(bs, ns, S, S, 3), src_info)
    input_G_src = make_src_inputs(morph_img, src_info).reshape(bs, ns, S, S, 6)
    masks = src_info.get("masks")
    input_G_bg = make_bg_inputs(comp, flat, src_info, masks).reshape(bs, ns, S, S, 4)
    input_G_bg = input_G_bg[:, primary_ids:primary_ids + 1]
    return uv_img, input_G_bg, input_G_src


def _pick_src_f2pts(comp: FlowComposer, src_info: dict, use_selected: bool = False) -> torch.Tensor:
    if use_selected and "selected_f2pts" in src_info:
        return src_info["selected_f2pts"]
    return src_info["only_vis_f2pts"] if comp.only_vis else src_info["f2pts"]


def make_trans_flow(comp: FlowComposer, src_info: dict, ref_info: dict, bs: int, ns: int,
                    temp_info: Optional[dict] = None, use_selected: bool = False,
                    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Inference-time flows: Tst (bs, ns, S, S, 2) and, with `temp_info`, Ttt
    (bs, nt, S, S, 2). ref_info covers bs frames."""
    S = comp.image_size
    src_f2pts = _pick_src_f2pts(comp, src_info, use_selected)  # (bs*ns, F, 3, 2)
    ref_fim = torch.repeat_interleave(ref_info["fim"], ns, dim=0)
    ref_wim = torch.repeat_interleave(ref_info["wim"], ns, dim=0)
    Tst = rz.cal_bc_transform(src_f2pts, ref_fim, ref_wim).reshape(bs, ns, S, S, 2)
    Ttt = None
    if temp_info is not None:
        nt = temp_info["f2pts"].shape[0] // bs
        t_fim = torch.repeat_interleave(ref_info["fim"], nt, dim=0)
        t_wim = torch.repeat_interleave(ref_info["wim"], nt, dim=0)
        Ttt = rz.cal_bc_transform(temp_info["f2pts"], t_fim, t_wim).reshape(bs, nt, S, S, 2)
    return Tst, Ttt


def make_batch_trans_flow(comp: FlowComposer, src_info: dict, ref_info: dict, bs: int, ns: int,
                          nt: int, temporal: bool = False, use_selected: bool = False,
                          ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Training-time flows: Tst (bs, nt, ns, S, S, 2) and, when temporal with
    nt > 1, Ttt (bs, nt - 1, S, S, 2) from each reference frame to the next."""
    S = comp.image_size
    F_ = comp.model.faces.shape[0]
    src_f2pts = _pick_src_f2pts(comp, src_info, use_selected).reshape(bs, ns, F_, 3, 2)
    src_rep = src_f2pts[:, None].expand(bs, nt, ns, F_, 3, 2).reshape(-1, F_, 3, 2)
    ref_fim = ref_info["fim"].reshape(bs, nt, S, S)
    ref_wim = ref_info["wim"].reshape(bs, nt, S, S, 3)
    fim_rep = ref_fim[:, :, None].expand(bs, nt, ns, S, S).reshape(-1, S, S)
    wim_rep = ref_wim[:, :, None].expand(bs, nt, ns, S, S, 3).reshape(-1, S, S, 3)
    Tst = rz.cal_bc_transform(src_rep, fim_rep, wim_rep).reshape(bs, nt, ns, S, S, 2)

    Ttt = None
    if temporal and nt > 1:
        ref_f2pts = ref_info["only_vis_f2pts"] if comp.only_vis else ref_info["f2pts"]
        prev = ref_f2pts.reshape(bs, nt, F_, 3, 2)[:, :-1].reshape(-1, F_, 3, 2)
        nxt_fim = ref_fim[:, 1:].reshape(-1, S, S)
        nxt_wim = ref_wim[:, 1:].reshape(-1, S, S, 3)
        Ttt = rz.cal_bc_transform(prev, nxt_fim, nxt_wim).reshape(bs, nt - 1, S, S, 2)
    return Tst, Ttt


def forward(comp: FlowComposer, src_img: torch.Tensor, ref_img: torch.Tensor,
            src_smpl: torch.Tensor, ref_smpl: torch.Tensor,
            src_mask: Optional[torch.Tensor] = None, ref_mask: Optional[torch.Tensor] = None,
            links_ids: Optional[torch.Tensor] = None, offsets: torch.Tensor | float = 0.0,
            temporal: bool = False) -> dict:
    """The training-phase composition.

    Args:
        src_img: (bs, ns, S, S, 3); ref_img: (bs, nt, S, S, 3);
        src_smpl: (bs, ns, 85); ref_smpl: (bs, nt, 85);
        src_mask / ref_mask: (bs, n, S, S, 1), background = 1.

    Returns dict with input_G_bg / input_G_src / input_G_tsf, Tst, Ttt,
    uv_img, src_info, ref_info.
    """
    bs, ns = src_img.shape[0], src_img.shape[1]
    nt = ref_img.shape[1]
    S = comp.image_size

    src_details = smpl_mod.get_details(comp.model, src_smpl.reshape(bs * ns, -1), offsets, links_ids)
    ref_details = smpl_mod.get_details(comp.model, ref_smpl.reshape(bs * nt, -1), offsets, links_ids)

    src_masks_flat = src_mask.reshape(bs * ns, S, S, 1) if src_mask is not None else None
    src_info = render_smpl_info(comp, src_details["verts"], src_details["cam"], masks=src_masks_flat,
                                use_morph=True, get_uv_info=True)
    src_info.update({k: src_details[k] for k in ("cam", "verts", "j2d")})
    if src_masks_flat is not None:
        src_info["masks"] = src_masks_flat

    ref_info = render_smpl_info(comp, ref_details["verts"], ref_details["cam"], use_morph=False,
                                get_uv_info=False)
    ref_info.update({k: ref_details[k] for k in ("cam", "verts", "j2d")})
    if ref_mask is not None:
        ref_info["masks"] = ref_mask.reshape(bs * nt, S, S, 1)

    uv_img, input_G_bg, input_G_src = process_source(comp, src_img, src_info)
    input_G_tsf = make_tsf_inputs(comp, uv_img, ref_info)
    Tst, Ttt = make_batch_trans_flow(comp, src_info, ref_info, bs, ns, nt, temporal=temporal)
    return {"input_G_bg": input_G_bg, "input_G_src": input_G_src, "input_G_tsf": input_G_tsf,
            "Tst": Tst, "Ttt": Ttt, "uv_img": uv_img, "src_info": src_info, "ref_info": ref_info}


def add_selected_f2pts(src_info: dict, part_mask: torch.Tensor) -> dict:
    """Restrict a source's flows to a face subset. part_mask: (F,) or (N, F) bool."""
    f2pts = src_info["f2pts"]
    if part_mask.dim() == 1:
        part_mask = part_mask.expand(f2pts.shape[0], part_mask.shape[0])
    src_info["selected_f2pts"] = rz.select_f2pts(f2pts, part_mask)
    return src_info


def merge_uv_img(uv_imgs: torch.Tensor, vis_maps: torch.Tensor) -> torch.Tensor:
    """Visibility-normalized UV merge across persons.
    uv_imgs (P, S, S, 3); vis_maps (P, S, S, 1)."""
    num = (uv_imgs * vis_maps).sum(dim=0)
    den = vis_maps.sum(dim=0)
    return num / torch.clamp(den, min=1e-5)
