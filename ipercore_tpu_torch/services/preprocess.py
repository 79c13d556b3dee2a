"""Preprocessing service: raw video / images -> a processed ProcessInfo
directory per input.

The port's copy of `ipercore_tpu/services/preprocess.py` (the reference's
`human_estimate`, `digital_deform`, `post_update_opt` and `preprocess`):
  * `human_estimate`: the stage pipeline (`tools/preprocessor.Preprocessor`)
    over every source and reference. The host preparation of all inputs
    (frame extraction, PNG decode) runs in a thread pool; the device stages
    run one input after another.
  * `digital_deform`: per source, SCHP skirt / dress cloth links when trained
    SCHP weights exist and find a hem, else the silhouette offset fit.
  * `post_update_opt`: drops inputs that did not finish, clamps
    `num_source` and writes `personalization.txt`.

Without weight files every stage still runs, on seeded networks and the
geometry fallbacks (the SMPL silhouette for the matte, diffusion for the
background). `opt.preproc_smoke` runs the pipeline's small configuration.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ipercore_tpu_torch.services.meta_info import MetaProcess, parse_ref_input, parse_src_input
from ipercore_tpu_torch.services.process_info import ProcessInfo
from ipercore_tpu_torch.utils import video as vid


def _flag(v) -> bool:
    """An option's truth: a bool, or a CLI string such as "true" / "0"."""
    if isinstance(v, str):
        return v.lower() in ("1", "true", "yes")
    return bool(v)


def _collect_frames(path: str, out_dir: str) -> list[str]:
    """A video -> numbered PNG frames in `out_dir`; an image folder or file
    -> its frames copied into `out_dir` as `frame_<i>.png`."""
    os.makedirs(out_dir, exist_ok=True)
    if os.path.isdir(path):
        frames = vid.list_frames(path)
    elif vid.is_video_file(path):
        return vid.video2frames(path, out_dir)
    elif os.path.isfile(path):
        frames = [path]
    else:
        frames = []
    out = []
    for i, f in enumerate(frames):
        dst = os.path.join(out_dir, f"frame_{i:08d}.png")
        if not os.path.exists(dst):
            vid.save_image(dst, vid.load_image(f))
        out.append(dst)
    return out


def _prepare_one(opt, meta) -> tuple[ProcessInfo, Optional[list[str]]]:
    """Host preparation of one input: its directories, manifest and frames.
    Host IO only, safe to run for several inputs at once; `frames` is None
    when the input is already processed."""
    mp = MetaProcess(meta.name, opt.output_dir).make_dirs()
    info = ProcessInfo.deserialize(mp.processed_dir)
    info.name = meta.name
    info.meta["name"] = meta.name
    if info.check_has_been_processed():
        return info, None
    return info, _collect_frames(meta.path, os.path.join(mp.processed_dir, "raw"))


def _preprocessor(opt, device):
    from ipercore_tpu_torch.tools.preprocessor import Preprocessor

    return Preprocessor(image_size=int(opt.image_size), smoke=_flag(opt.get("preproc_smoke", False)),
                        device=device)


def preprocess_one(opt, meta, is_src: bool, pre=None, device="cuda") -> ProcessInfo:
    """Every stage for one input (`pre`: a Preprocessor, built when None)."""
    info, frames = _prepare_one(opt, meta)
    if frames is None:
        return info
    if frames:
        pre = pre or _preprocessor(opt, device)
        pre.execute(info, frames, os.path.join(MetaProcess(meta.name, opt.output_dir).processed_dir, "images"),
                    is_src=is_src)
    info.serialize()
    return info


def human_estimate(opt, device="cuda") -> None:
    """The stage pipeline over every source and reference input: their host
    preparation in a pool of `opt.preproc_workers` threads (default 4), the
    device stages one input after another on one Preprocessor, built at the
    first input that needs it."""
    from concurrent.futures import ThreadPoolExecutor

    metas = [(m, True) for m in parse_src_input(opt.src_path) if m.path]
    metas += [(m, False) for m in parse_ref_input(opt.ref_path) if m.path]
    if not metas:
        return
    workers = max(1, int(opt.get("preproc_workers", 4)))
    pre = None
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs = [ex.submit(_prepare_one, opt, m) for m, _ in metas]
        for (meta, is_src), fut in zip(metas, futs):
            info, frames = fut.result()
            if frames is None:
                continue
            if frames:
                pre = pre or _preprocessor(opt, device)
                pre.execute(info, frames,
                            os.path.join(MetaProcess(meta.name, opt.output_dir).processed_dir, "images"),
                            is_src=is_src)
            info.serialize()


def digital_deform(opt, device="cuda") -> dict:
    """Cloth links or silhouette offsets for every processed source.

    With trained SCHP weights (`opt.schp_weights`, default `assets/schp.npz`)
    the skirt / dress hem of the first frame gives cloth links
    (`links_ids`); where none are found, or without the weights, the
    500-step silhouette offset fit gives `offsets`. Returns {source name:
    "links" or "offsets"} for the sources it deformed.
    """
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.tools.deformers import find_cloth_links_schp, run_sil2smpl_offsets
    from ipercore_tpu_torch.tools.parsers import build_parser

    parser = build_parser(opt.get("schp_weights") or None, device=device)
    done = {}
    for meta in parse_src_input(opt.src_path):
        if not meta.path:
            continue
        mp = MetaProcess(meta.name, opt.output_dir)
        info = ProcessInfo.deserialize(mp.processed_dir)
        if info.has_run("deform") or not info.has_run("pose3d"):
            continue
        found = False
        if parser is not None:
            img_dir = os.path.join(mp.processed_dir, "images")
            frames = vid.list_frames(img_dir) if os.path.isdir(img_dir) else []
            smpls = info.get_array("smpls")
            if frames and smpls is not None and len(smpls):
                model = smpl_mod.resolve_body_model(opt, device=device)
                found, links = find_cloth_links_schp(parser, vid.load_image(frames[0]), smpls[0], model)
                if found:
                    info.set_array("links_ids", links.astype(np.int64))
        if not found:
            info.set_array("offsets", run_sil2smpl_offsets(opt, info, device=device))
        info.mark_run("deform")
        info.serialize()
        done[meta.name] = "links" if found else "offsets"
    return done


def post_update_opt(opt) -> None:
    """Keep only the inputs whose every stage ran.

    A source is valid when it is processed and has SMPLs; `opt.src_path`
    keeps the valid sources (when there is one), `opt.num_source` becomes
    min(num_source, the largest frame count of a valid source),
    `<checkpoints>/personalization.txt` lists their primitives directories,
    and `opt.ref_path` keeps the processed references (when there is one).
    """
    from ipercore_tpu_torch.services.meta_info import checkpoints_dir

    valid, cur_num_source = [], 1
    for meta in parse_src_input(opt.src_path):
        info = ProcessInfo.deserialize(MetaProcess(meta.name, opt.output_dir).processed_dir)
        smpls = info.get_array("smpls")
        if info.check_has_been_processed() and smpls is not None and len(smpls):
            valid.append(meta)
            cur_num_source = max(cur_num_source, len(smpls))
    if valid:
        opt.src_path = "|".join(m.to_str() for m in valid)
    opt.num_source = min(int(opt.num_source), cur_num_source)

    ckpt_dir = checkpoints_dir(opt.output_dir, opt.model_id)
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "personalization.txt"), "w") as f:
        for meta in valid:
            f.write(MetaProcess(meta.name, opt.output_dir).primitives_dir + "\n")

    ref_valid = [m for m in parse_ref_input(opt.ref_path)
                 if ProcessInfo.deserialize(MetaProcess(m.name, opt.output_dir).processed_dir)
                 .check_has_been_processed()]
    if ref_valid:
        opt.ref_path = "|".join(m.to_str() for m in ref_valid)


def preprocess(opt, device="cuda") -> None:
    """estimate -> deform -> update the options."""
    human_estimate(opt, device=device)
    digital_deform(opt, device=device)
    post_update_opt(opt)
