"""Appearance-transfer (swap) service.

Twin of `swap` in `ipercore_tpu/services/run_swapper.py`: every source person
after the first claims the body parts its `parts?=` names, the first person
keeps the faces nobody claimed, their caches are merged
(`merge_source_caches`) and the merged source imitates each reference.
`run_swapper` (what `main` runs) takes raw inputs through preprocess,
personalize and the swap.
"""
from __future__ import annotations

import os

import numpy as np

from ipercore_tpu_torch.models import imitator as imit
from ipercore_tpu_torch.models.mesh import part_face_mask
from ipercore_tpu_torch.services.meta_info import MetaProcess, parse_ref_input, parse_src_input
from ipercore_tpu_torch.services.process_info import ProcessInfo
from ipercore_tpu_torch.services.run_imitator import (
    Device,
    build_runtime,
    imitate_sequence,
    load_source_cache,
    write_frames,
)
from ipercore_tpu_torch.utils import video as vid
from ipercore_tpu_torch.utils.smoothing import temporal_smooth_smpls


def swap(opt, device: Device = "cuda") -> list[str]:
    """Merge the sources by parts and imitate every reference with the merged
    cache. Returns per reference the video path, or the frame directory when
    no encoder ran."""
    model, comp, gen = build_runtime(opt, device)
    src_metas = parse_src_input(opt.src_path)
    caches, masks, claimed = [], [], None
    for i, meta in enumerate(src_metas):
        cache, _, _, _ = load_source_cache(opt, comp, gen, meta)
        caches.append(cache)
        if i == 0:
            masks.append(None)  # the leftovers, known once the others have claimed
        else:
            m = part_face_mask(comp.assets, meta.parts)
            masks.append(m)
            claimed = m if claimed is None else (claimed | m)
    masks[0] = ~claimed if claimed is not None else part_face_mask(comp.assets, ["all"])
    merged = imit.merge_source_caches(comp, caches, masks)

    outputs = []
    names = "+".join(m.name for m in src_metas)
    for ref_meta in parse_ref_input(opt.ref_path):
        proc_dir = MetaProcess(ref_meta.name, opt.output_dir).processed_dir
        ref_info = ProcessInfo.deserialize(proc_dir).read_ref_info()
        smpls = temporal_smooth_smpls(
            np.asarray(ref_info["smpls"], np.float32), ref_meta.pose_fc, ref_meta.cam_fc)
        smpls = imit.prepare_target_smpls(
            comp.model, merged, smpls, cam_strategy=str(opt.get("cam_strategy", "smooth")))
        frames = imitate_sequence(comp, gen, merged, smpls, device=device)
        out_dir = MetaProcess(f"{names}-{ref_meta.name}-swap", opt.output_dir).make_dirs().synthesis_dir
        paths = write_frames(frames, out_dir)
        try:
            mp4 = os.path.join(out_dir, "swap.mp4")
            vid.make_video(paths, mp4, fps=ref_meta.fps, audio_path=ref_meta.audio)
            outputs.append(mp4)
        except Exception:
            outputs.append(out_dir)
    return outputs


def run_swapper(opt, device: Device = "cuda") -> list[str]:
    """The three stages: preprocess, personalize, swap."""
    from ipercore_tpu_torch.services.personalization import personalize
    from ipercore_tpu_torch.services.preprocess import preprocess

    preprocess(opt, device=device)
    personalize(opt, device=device)
    return swap(opt, device=device)


def main(argv=None):  # pragma: no cover - CLI shim
    """`python -m ipercore_tpu_torch.services.run_swapper --src_path 'a|b,parts?=...'
    --ref_path ... [--device cpu]`."""
    from ipercore_tpu_torch.services.options import parse_args

    opt = parse_args(argv)
    return run_swapper(opt, device=opt.get("device", "cuda"))


if __name__ == "__main__":  # pragma: no cover
    main()
