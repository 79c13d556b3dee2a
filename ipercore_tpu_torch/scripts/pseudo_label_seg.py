"""Background-subtraction pseudo-masks for the person segmenter.

Twin of `scripts/pseudo_label_seg.py`. The sample clip's camera is static,
so for each frame before the held-out band (read from
`eval_real_photos.FRAME_DIR`, resized to `--work`²): the clip's median
background, the per-pixel colour distance to it over `--thr`, a close
(`dilate` then `erode`, 5) and an open (3), the largest connected component
with its holes filled. A frame is dropped when its mask covers under 2 % or
over half the frame, is not compact (`detection.mask_is_compact`), or, where
the pose pseudo-labels (`akun_pseudo.npz` beside `--out`) give the frame's
joints, leaves more than a tenth of them outside the mask dilated by 3.
Writes the images (f16), masks, frame ids and stats to `--out`, the pool
`train_person_seg --pseudo` reads.

    python -m ipercore_tpu_torch.scripts.pseudo_label_seg [--work 256] [--report] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ipercore_tpu_torch.ops.morphology import dilate, erode
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.scripts.pseudo_label_pose import load_frames

OUT = os.path.join(cm.REPO_DIR, ".cache", "pseudo_pose", "akun_seg.npz")
VAL_BAND_START = 160


def foreground(imgs: np.ndarray, thr: float, device) -> np.ndarray:
    """(N, W, W, 1) cleaned foreground: the distance to the median background
    over `thr`, closed by 5 and opened by 3 (on the device)."""
    bg = np.median(imgs, axis=0)
    dist = np.linalg.norm(imgs - bg[None], axis=-1)
    fg = torch.as_tensor((dist > thr).astype(np.float32)[..., None], device=device)
    fg = erode(dilate(fg, 5), 5)
    return dilate(erode(fg, 3), 3).cpu().numpy()


def pose_joints(pose_npz: str, work: int) -> dict:
    """frame -> the pose pseudo-labels' valid joints in work pixels (the
    clip's 1920x1080 frame scaled to work², as the JAX driver scales them)."""
    joints = {}
    if os.path.exists(pose_npz):
        with np.load(pose_npz, allow_pickle=True) as pd:
            for f, kps, val, org in zip(pd["frames"], pd["kps_ndc"], pd["valid"], pd["origins"]):
                px = (kps + 1.0) * 0.5 * org[2] + org[:2]
                joints[int(f)] = px[val > 0] * np.asarray([work / 1920.0, work / 1080.0])
    return joints


def keep_mask(m: np.ndarray, joints, work: int):
    """The largest component of `m`, holes filled, or None when the frame is
    dropped (`:108-133`)."""
    from scipy import ndimage as ndi

    from ipercore_tpu_torch.tools.detection import mask_is_compact

    lab, n = ndi.label(m)
    if n == 0:
        return None
    sizes = ndi.sum(m, lab, index=np.arange(1, n + 1))
    m = ndi.binary_fill_holes(lab == (1 + int(np.argmax(sizes))))
    if not (0.02 < m.mean() < 0.5) or not mask_is_compact(m):
        return None
    if joints is not None and len(joints):
        xi = np.clip(joints.astype(int), 0, work - 1)
        if ndi.binary_dilation(m, iterations=3)[xi[:, 1], xi[:, 0]].mean() < 0.9:
            return None
    return m


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", type=int, default=256)
    ap.add_argument("--thr", type=float, default=0.15, help="colour-distance threshold in [-1, 1] units")
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = cm.resolve_device(args.device)
    W = args.work
    frames_idx = list(range(VAL_BAND_START))
    imgs = load_frames(frames_idx, W)
    fg = foreground(imgs, args.thr, device)
    joints = pose_joints(os.path.join(os.path.dirname(args.out), "akun_pseudo.npz"), W)
    keep, masks = [], []
    for i in range(len(imgs)):
        m = keep_mask(fg[i, ..., 0] > 0.5, joints.get(int(frames_idx[i])), W)
        if m is not None:
            keep.append(i)
            masks.append(m)
    stats = {"n_frames": len(imgs), "kept": len(keep),
             "mean_mask_frac": round(float(np.mean([m.mean() for m in masks])), 4) if masks else 0.0,
             "work": W, "thr": args.thr}
    print(json.dumps(stats), flush=True)
    if args.report or not keep:
        return stats
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, imgs=imgs[keep].astype(np.float16), masks=np.stack(masks).astype(np.uint8),
                        frames=np.asarray(frames_idx)[keep], meta=json.dumps(stats))
    print(f"wrote {args.out}", flush=True)
    return stats


if __name__ == "__main__":
    main()
