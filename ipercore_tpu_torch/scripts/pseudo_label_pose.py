"""Self-training pseudo-labels for the 2D pose chain on the real sample clip.

Twin of `scripts/pseudo_label_pose.py`. The clip's frames before the held-out
band (`VAL_BAND_START`) are read from `eval_real_photos.FRAME_DIR` (extracted
from `$IPERCORE_REFERENCE_SAMPLES/references/akun_1.mp4` when the clip is
there). Person boxes come from the trained segmenter's stage-1.1 path
(`SegmentationDetector`, gaps filled from the nearest good frame, a window-9
temporal median); each frame's square crop goes through the trained Body-25
with the flip at the teacher's `trained_size` (`run_tracked`). A joint keeps
its label when its heatmap peak clears `--score_thr`, it lies within
`--dev_thr` of the person's height of its window-7 temporal median, and it is
not a toe or heel; the median becomes the label. Frames with fewer than
`--min_joints` such joints are dropped. Writes the crops (f16), the labels
in crop NDC, the joint masks, frame ids, boxes and origins to `--out`, the
pool `train_openpose --pseudo` reads.

    python -m ipercore_tpu_torch.scripts.pseudo_label_pose [--report] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.scripts import eval_real_photos as real

OUT_DIR = os.path.join(cm.REPO_DIR, ".cache", "pseudo_pose")
VAL_BAND_START = 160  # frames >= this are the held-out band: never labelled
N_FRAMES = 219
CROP = 320  # stored crop resolution (the trainers resize to their input size)


def load_frames(frames_idx, size: int | None = None) -> np.ndarray:
    """The listed clip frames from `FRAME_DIR`, (N, H, W, 3) in [-1, 1], each
    resized linearly to size² when `size` is given."""
    from PIL import Image

    real.ensure_frames(frames_idx)
    out = []
    for i in frames_idx:
        arr = np.asarray(Image.open(os.path.join(real.FRAME_DIR, f"akun_{i:04d}.png")).convert("RGB"),
                         np.float32) / 127.5 - 1.0
        out.append(arr if size is None else resize_linear(arr[None], (1, size, size, 3))[0])
    return np.stack(out)


def detect_boxes(frames: np.ndarray, device) -> np.ndarray:
    """The stage-1.1 segmenter boxes of each frame, (N, 4) xyxy pixels: a
    frame where the segmenter finds nobody takes the nearest good frame's
    box, then a window-9 temporal median (`detect_boxes`, `:58-91`)."""
    from ipercore_tpu_torch.tools.detection import (SegmentationDetector, _merge_aligned_components,
                                                    person_components)

    det = SegmentationDetector(device=device)
    if not det.available:
        raise SystemExit("no trained person_seg weights; run train_person_seg first")
    N, H, W = frames.shape[:3]
    probs = det.run_probs(frames)
    work = det.work
    min_area = max(int(det.min_area_frac * work * work), 8)
    boxes = np.full((N, 4), np.nan, np.float32)
    s = np.asarray([W / work, H / work] * 2, np.float32)
    for i in range(N):
        cb, cs = person_components(probs[i], min_area=min_area)
        if len(cb):
            boxes[i] = _merge_aligned_components(cb, cs) * s
    good = np.where(np.isfinite(boxes[:, 0]))[0]
    if len(good) == 0:
        raise SystemExit("segmenter found no person in any frame")
    for i in range(N):
        if not np.isfinite(boxes[i, 0]):
            boxes[i] = boxes[good[np.argmin(np.abs(good - i))]]
    sm = np.empty_like(boxes)
    for i in range(N):
        sm[i] = np.median(boxes[max(0, i - 4):min(N, i + 5)], axis=0)
    return sm


def square_crops(imgs: np.ndarray, boxes: np.ndarray):
    """(crops (N, CROP, CROP, 3), origins (N, 3) = (x0, y0, side)): each box's
    square crop with a margin, resized linearly (`jax.image.resize`'s)."""
    N = len(imgs)
    crops = np.empty((N, CROP, CROP, 3), np.float32)
    origins = np.empty((N, 3), np.float32)
    for i in range(N):
        pad, (x0, y0, side) = real._square_crop(imgs[i], boxes[i])
        crops[i] = resize_linear(pad[None], (1, CROP, CROP, 3))[0]
        origins[i] = (x0, y0, side)
    return crops, origins


def temporal_labels(kps, scores, valid, origins, person_h, score_thr: float, dev_thr: float):
    """(ok (N, 25) joint masks, labels (N, 25, 2) in crop NDC, dev (N, 25)
    pixels): each joint's window-7 temporal median in frame pixels, gated on
    its score, its deviation from the median and validity; toes and heels
    never (`:146-164`)."""
    N = len(kps)
    px = (kps + 1.0) * 0.5 * origins[:, None, 2:3] + origins[:, None, :2]
    med = np.empty_like(px)
    for i in range(N):
        med[i] = np.nanmedian(px[max(0, i - 3):min(N, i + 4)], axis=0)
    dev = np.linalg.norm(px - med, axis=-1)
    ok = ((np.asarray(scores) > score_thr) & (dev < dev_thr * person_h[:, None])
          & np.isfinite(med).all(axis=-1) & np.asarray(valid).astype(bool))
    ok[:, 19:25] = False  # toes / heels: the net never had supervision there
    lab = (med - origins[:, None, :2]) / origins[:, None, 2:3] * 2.0 - 1.0
    return ok, np.where(ok[..., None], lab, 0.0).astype(np.float32), dev


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--score_thr", type=float, default=0.25, help="min heatmap peak score for a joint label")
    ap.add_argument("--dev_thr", type=float, default=0.05,
                    help="max |raw - temporal median| as a fraction of person height for a joint label")
    ap.add_argument("--min_joints", type=int, default=8, help="drop frames with fewer valid joints than this")
    ap.add_argument("--out", type=str, default=os.path.join(OUT_DIR, "akun_pseudo.npz"))
    ap.add_argument("--report", action="store_true", help="stats only, no write")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = cm.resolve_device(args.device)
    from ipercore_tpu_torch.tools.pose2d import build_pose2d_estimator

    frames_idx = [i for i in range(N_FRAMES) if i < VAL_BAND_START]
    imgs = load_frames(frames_idx)
    N, H, W = imgs.shape[:3]
    print(f"loaded {N} frames {W}x{H}", flush=True)
    boxes = detect_boxes(imgs, device)
    crops, origins = square_crops(imgs, boxes)

    pose2d = build_pose2d_estimator(device=device)
    if not pose2d.trained:
        raise SystemExit("no trained openpose weights")
    # the teacher runs at the resolution it was calibrated at (its checkpoint's metadata)
    t_size = pose2d.trained_size or CROP
    teach_in = crops if t_size == CROP else resize_linear(crops, (N, t_size, t_size, 3))
    kps, scores, valid = pose2d.run_tracked(teach_in, smooth=False)
    ok, lab_ndc, dev = temporal_labels(kps, scores, valid, origins, boxes[:, 3] - boxes[:, 1],
                                       args.score_thr, args.dev_thr)
    n_per_frame = ok.sum(axis=1)
    keep = n_per_frame >= args.min_joints
    stats = {"n_frames": int(N), "n_kept": int(keep.sum()),
             "joints_per_kept_frame": round(float(n_per_frame[keep].mean()), 2) if keep.any() else 0.0,
             "score_thr": args.score_thr, "dev_thr": args.dev_thr,
             "mean_dev_px": round(float(np.nanmean(dev)), 2), "val_band_start": VAL_BAND_START}
    print(json.dumps(stats), flush=True)
    if args.report or not keep.any():
        return stats
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, crops=crops[keep].astype(np.float16), kps_ndc=lab_ndc[keep],
                        valid=ok[keep].astype(np.float32), frames=np.asarray(frames_idx)[keep],
                        boxes=boxes[keep], origins=origins[keep], meta=json.dumps(stats))
    print(f"wrote {args.out}", flush=True)
    return stats


if __name__ == "__main__":
    main()
