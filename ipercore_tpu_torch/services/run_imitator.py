"""Motion-imitation service: chunked frame synthesis and the imitation stage.

Twin of `ipercore_tpu/services/run_imitator.py`: `build_runtime` makes the
body model, composer and generator from an options dict, `load_source_cache`
reads a preprocessed source from disk, `imitate_sequence` synthesizes frames
chunk by chunk (or frame by frame in temporal mode), and `imitate` runs the
imitation stage for every (source, reference) pair and writes PNG frames and
a video.

What is not here: the three-stage `run_imitator` (preprocess, personalize,
imitate) needs the perception stack, which is not ported; `main` runs the
imitation stage alone on already processed inputs, after
`services/personalization.personalize` when personalized weights are wanted.

Weights: `<output_dir>/models/<model_id>/personalized.npz` when it exists,
else `seeded_flat_params(G, seed=0)` for the generator `opt.gen_name` (any
LWB generator; AttLWB-Front needs the background given). (The JAX package initialises
Flax from `PRNGKey(0)` instead, which PyTorch cannot reproduce.)
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ipercore_tpu_torch.models import imitator as imit
from ipercore_tpu_torch.services.meta_info import (
    MetaProcess,
    parse_ref_input,
    parse_src_input,
)
from ipercore_tpu_torch.services.process_info import ProcessInfo
from ipercore_tpu_torch.utils import video as vid
from ipercore_tpu_torch.utils.smoothing import temporal_smooth_smpls

Device = Union[str, torch.device]


def build_runtime(opt, device: Device = "cuda"):
    """Body model, composer and generator from an options dict.

    The body model is `resolve_body_model(opt)`; with `opt.smoke_model` the
    UV atlas and part labels are synthetic. Generator weights come from
    `personalized.npz` when present, else from `seeded_flat_params`.

    Returns:
        (model, comp, gen); the generator holds its weights, on `device`.
    """
    from ipercore_tpu_torch.models import flow_composition as fc
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.models.networks import build_generator
    from ipercore_tpu_torch.services.personalization import personalized_path
    from ipercore_tpu_torch.utils.checkpoint import (
        load_flat_npz,
        load_generator_params,
        seeded_flat_params,
    )

    model = smpl_mod.resolve_body_model(opt, device=device)
    assets = load_assets(model, device=device, synthetic=bool(opt.get("smoke_model", False)))
    comp = fc.make_composer(
        model, assets,
        image_size=int(opt.image_size),
        bg_ks=int(opt.get("bg_ks", 11)),
        conf_erode_ks=int(opt.get("conf_erode_ks", 3)),
        out_dilate_ks=int(opt.get("out_dilate_ks", 51)),
        only_vis=bool(opt.get("only_vis", False)),
    )
    gen = build_generator(opt.get("gen_name", "AttLWB-SPADE"), opt.Generator,
                          temporal=bool(opt.get("temporal", False)),
                          feat_warp_stride=int(opt.get("feat_warp_stride", 1)), device=device)
    personalized = personalized_path(opt)
    flat = (load_flat_npz(personalized) if os.path.exists(personalized)
            else seeded_flat_params(gen, seed=0))
    load_generator_params(gen, flat)
    return model, comp, gen


def imitate_sequence(
    comp, gen, cache, tgt_smpls: np.ndarray, chunk: int = 16, temporal: bool = False,
    offsets=0.0, links_ids=None, compute_dtype: Optional[torch.dtype] = None,
    device: Device = "cuda",
) -> np.ndarray:
    """Run frame synthesis in chunks of `chunk` frames: the sequence is padded
    to a chunk multiple with its last frame, synthesized chunk by chunk on
    `device`, and the pad is stripped. With `temporal` the whole sequence
    goes through `synthesize_frames_temporal` (each frame needs the one
    before it; `chunk` and `compute_dtype` do not apply).

    Args:
        tgt_smpls: (N, 85) prepared target SMPLs (`prepare_target_smpls`).
        compute_dtype: None is full f32 (the reference path); pass
            torch.bfloat16 for the lower-precision generator.

    Returns:
        (N, S, S, 3) float32 frames in [-1, 1] on the host.
    """
    tgt_smpls = np.asarray(tgt_smpls, np.float32)
    n = len(tgt_smpls)
    if temporal:
        preds, _ = imit.synthesize_frames_temporal(
            comp, gen, cache, torch.as_tensor(tgt_smpls, device=device), offsets, links_ids)
        return preds.cpu().numpy()
    pad = (-n) % chunk
    padded = (np.concatenate([tgt_smpls, np.repeat(tgt_smpls[-1:], pad, axis=0)], axis=0)
              if pad else tgt_smpls)
    outs = []
    for i in range(0, len(padded), chunk):
        batch = torch.as_tensor(padded[i:i + chunk], device=device)
        preds, _ = imit.synthesize_frames(comp, gen, cache, batch, offsets, links_ids,
                                          compute_dtype=compute_dtype)
        outs.append(preds.cpu().numpy())
    return np.concatenate(outs, axis=0)[:n]


def load_source_cache(opt, comp, gen, src_meta, proc_dir: Optional[str] = None):
    """Read a source's ProcessInfo, its frames and masks, and build its
    SourceCache on the composer's device. The background is the source's
    `bg_path`, else the preprocessed `background.png`, else BGNet's inpainting.

    Returns:
        (cache, src info dict, offsets (V, 3) tensor, links_ids or None).
    """
    dev = comp.assets.f2uvs.device
    proc_dir = proc_dir or MetaProcess(src_meta.name, opt.output_dir).processed_dir
    info = ProcessInfo.deserialize(proc_dir)
    src = info.read_src_info(num_source=int(opt.num_source))
    S = int(opt.image_size)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    imgs = [vid.load_image(os.path.join(proc_dir, "images", name), size=S)
            for name in src["img_names"]]
    src_img = as_t(np.stack(imgs))[None]  # (1, ns, S, S, 3)

    masks = None
    mask_arr = info.get_array("masks")
    if mask_arr is not None:
        masks = as_t(mask_arr[src["src_ids"]])[None]
        if masks.dim() == 4:
            masks = masks[..., None]

    bg_img = None
    if src_meta.bg_path and os.path.exists(src_meta.bg_path):
        bg_img = as_t(vid.load_image(src_meta.bg_path, size=S))[None]
    else:
        proc_bg = os.path.join(proc_dir, "background.png")
        if os.path.exists(proc_bg):
            bg_img = as_t(vid.load_image(proc_bg, size=S))[None]

    V = comp.model.v_template.shape[0]
    offsets = src["offsets"]
    if offsets is None or offsets.shape[0] != V:
        offsets = np.zeros((V, 3), np.float32)
    offsets = as_t(offsets)
    links = src["links_ids"]
    links_ids = torch.as_tensor(links, device=dev) if links is not None else None

    cache = imit.setup_source(comp, gen, src_img, as_t(src["smpls"])[None], masks=masks,
                              bg_img=bg_img, offsets=offsets, links_ids=links_ids)
    return cache, src, offsets, links_ids


def write_frames(frames: np.ndarray, out_dir: str, prefix: str = "pred") -> list[str]:
    """Save frames in [-1, 1] as `<prefix>_00000000.png`, ... in `out_dir`."""
    paths = []
    for i, f in enumerate(frames):
        p = os.path.join(out_dir, f"{prefix}_{i:08d}.png")
        vid.save_image(p, f)
        paths.append(p)
    return paths


def imitate(opt, device: Device = "cuda") -> list[str]:
    """The imitation stage: for every (source, reference) pair, smooth the
    reference SMPLs, apply its effects, swap in the source's camera and shape,
    synthesize, and write frames, the fused src | ref | out panels and videos.

    Returns:
        per pair the video path, or the frame directory when no encoder ran.
    """
    model, comp, gen = build_runtime(opt, device)
    S = int(opt.image_size)
    outputs = []
    for src_meta in parse_src_input(opt.src_path):
        cache, src, offsets, links_ids = load_source_cache(opt, comp, gen, src_meta)
        src_proc = MetaProcess(src_meta.name, opt.output_dir).processed_dir
        src_imgs = [vid.load_image(os.path.join(src_proc, "images", n), size=S)
                    for n in src["img_names"]]
        for ref_meta in parse_ref_input(opt.ref_path):
            ref_meta.resolve_media(opt.output_dir)
            proc_dir = MetaProcess(ref_meta.name, opt.output_dir).processed_dir
            pinfo = ProcessInfo.deserialize(proc_dir)
            smpls = np.asarray(pinfo.read_ref_info()["smpls"], np.float32)
            smpls = temporal_smooth_smpls(smpls, ref_meta.pose_fc, ref_meta.cam_fc)
            if "View" in ref_meta.effect:
                smpls = imit.add_view_effect(torch.as_tensor(smpls), ref_meta.effect["View"]).numpy()
            for frame, dur in ref_meta.effect.get("BT", []):
                smpls = imit.add_bullet_time_effect(torch.as_tensor(smpls), [frame], dur).numpy()
            smpls = imit.prepare_target_smpls(
                comp.model, cache, smpls, cam_strategy=str(opt.get("cam_strategy", "smooth")))

            frames = imitate_sequence(comp, gen, cache, smpls,
                                      temporal=bool(opt.get("temporal", False)),
                                      offsets=offsets, links_ids=links_ids, device=device)
            out_dir = MetaProcess(
                f"{src_meta.name}-{ref_meta.name}", opt.output_dir).make_dirs().synthesis_dir
            paths = write_frames(frames, out_dir)

            ref_names = pinfo.meta.get("valid_img_names", [])
            fused_paths = []
            if ref_names:
                src_panel = np.concatenate(src_imgs, axis=1)
                fused = []
                for i, f in enumerate(frames):
                    rn = ref_names[min(i, len(ref_names) - 1)]
                    ref_img = vid.load_image(os.path.join(proc_dir, "images", rn), size=S)
                    fused.append(vid.fuse_side_by_side([[src_panel, ref_img, f]]))
                fused_paths = write_frames(fused, out_dir, prefix="fused")

            # as in the JAX package: without ffmpeg or cv2 no video is made,
            # and the frame directory is the output
            mp4 = os.path.join(out_dir, "imitation.mp4")
            try:
                vid.make_video(paths, mp4, fps=ref_meta.fps, audio_path=ref_meta.audio)
                if fused_paths:
                    vid.make_video(fused_paths, os.path.join(out_dir, "imitation_fused.mp4"),
                                   fps=ref_meta.fps, audio_path=ref_meta.audio)
                outputs.append(mp4)
            except Exception:
                outputs.append(out_dir)
    return outputs


def main(argv=None):  # pragma: no cover - CLI shim
    """`python -m ipercore_tpu_torch.services.run_imitator --src_path ...
    --ref_path ... [--device cpu]` on already processed inputs."""
    from ipercore_tpu_torch.services.options import parse_args

    opt = parse_args(argv)
    return imitate(opt, device=opt.get("device", "cuda"))


if __name__ == "__main__":  # pragma: no cover
    main()
