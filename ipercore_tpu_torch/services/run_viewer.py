"""Novel-view service: a 360-degree turn of each source person.

Twin of `novel_view` in `ipercore_tpu/services/run_viewer.py`: per source, a
ring of `view_frames` (default 180) SMPLs turned about the y axis (the source
pose, or a T-pose with `T_pose`), camera-stabilised and swapped like any
target, through the same synthesis as the imitator. `run_viewer` (what `main`
runs) takes raw inputs through preprocess, personalize and the view.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ipercore_tpu_torch.models import imitator as imit
from ipercore_tpu_torch.services.meta_info import MetaProcess, parse_src_input
from ipercore_tpu_torch.services.run_imitator import (
    Device,
    build_runtime,
    imitate_sequence,
    load_source_cache,
    write_frames,
)
from ipercore_tpu_torch.utils import video as vid


def novel_view(opt, device: Device = "cuda") -> list[str]:
    """Per source, synthesize the rotation ring and write its frames and
    video. Returns per source the video path, or the frame directory when no
    encoder ran."""
    model, comp, gen = build_runtime(opt, device)
    outputs = []
    for src_meta in parse_src_input(opt.src_path):
        cache, src, offsets, links_ids = load_source_cache(opt, comp, gen, src_meta)
        base = torch.as_tensor(np.asarray(src["smpls"][0], np.float32))
        smpls = imit.make_novel_view_smpls(base, n_frames=int(opt.get("view_frames", 180)),
                                           use_t_pose=bool(opt.get("T_pose", False)))
        smpls = imit.prepare_target_smpls(
            comp.model, cache, smpls.numpy(), cam_strategy=str(opt.get("cam_strategy", "smooth")))
        frames = imitate_sequence(comp, gen, cache, smpls, offsets=offsets,
                                  links_ids=links_ids, device=device)
        out_dir = MetaProcess(f"{src_meta.name}-novel_view", opt.output_dir).make_dirs().synthesis_dir
        paths = write_frames(frames, out_dir)
        try:
            mp4 = os.path.join(out_dir, "novel_view.mp4")
            vid.make_video(paths, mp4, fps=25)
            outputs.append(mp4)
        except Exception:
            outputs.append(out_dir)
    return outputs


def run_viewer(opt, device: Device = "cuda") -> list[str]:
    """The three stages: preprocess, personalize, novel view."""
    from ipercore_tpu_torch.services.personalization import personalize
    from ipercore_tpu_torch.services.preprocess import preprocess

    preprocess(opt, device=device)
    personalize(opt, device=device)
    return novel_view(opt, device=device)


def main(argv=None):  # pragma: no cover - CLI shim
    """`python -m ipercore_tpu_torch.services.run_viewer --src_path ...
    [--view_frames N] [--T_pose] [--device cpu]`."""
    from ipercore_tpu_torch.services.options import parse_args

    opt = parse_args(argv)
    return run_viewer(opt, device=opt.get("device", "cuda"))


if __name__ == "__main__":  # pragma: no cover
    main()
