"""The real-photo probes the training drivers select checkpoints with.

Twin of the helpers of `scripts/eval_real_photos.py` that the trainers call
(`load_gt`, `select_gt`, `pose_probe_crops`, `rasterize_poly`); that
driver's own evaluation is not ported yet. `assets/real_gt.json` lists the
annotated images: frames of the reference's sample clip (extracted with cv2
into `.cache/real_frames/` on first use), one still, and matplotlib's sample
images. The reference's samples are found under `$IPERCORE_REFERENCE_SAMPLES`
(its `assets/samples` directory); without them, or without the extracted
frames, a probe has no images and the trainers say "real probe unavailable".
"""
from __future__ import annotations

import json
import os

import numpy as np

from ipercore_tpu_torch.scripts._common import REPO_DIR

SAMPLES_DIR = os.environ.get("IPERCORE_REFERENCE_SAMPLES", "")
STILL = os.path.join(SAMPLES_DIR, "sources", "donald_trump_2", "00000.PNG") if SAMPLES_DIR else ""
CLIP = os.path.join(SAMPLES_DIR, "references", "akun_1.mp4") if SAMPLES_DIR else ""
FRAME_DIR = os.path.join(REPO_DIR, ".cache", "real_frames")
GT_PATH = os.path.join(REPO_DIR, "assets", "real_gt.json")


def load_gt(roles=("select", "val")) -> dict:
    """name -> (image path, (x0, y0, x1, y1) fractions, role); extracts the
    clip's frames on demand."""
    with open(GT_PATH) as f:
        reg = json.load(f)["images"]
    ensure_frames([e["frame"] for e in reg.values() if "frame" in e and e["role"] in roles])
    out = {}
    for name, e in reg.items():
        if e["role"] not in roles:
            continue
        if e.get("still"):
            path = STILL
        elif e.get("mpl_sample"):
            import matplotlib

            path = os.path.join(matplotlib.get_data_path(), "sample_data", e["mpl_sample"])
        else:
            path = os.path.join(FRAME_DIR, f"akun_{e['frame']:04d}.png")
        out[name] = (path, tuple(e["box"]), e["role"])
    return out


def ensure_frames(frames) -> None:
    """Extract the listed frames of the clip into `FRAME_DIR` (cv2), when the
    clip exists and they are missing."""
    missing = {f for f in frames if not os.path.exists(os.path.join(FRAME_DIR, f"akun_{f:04d}.png"))}
    if not missing or not CLIP or not os.path.exists(CLIP):
        return
    import cv2

    os.makedirs(FRAME_DIR, exist_ok=True)
    cap = cv2.VideoCapture(CLIP)
    i = 0
    while missing:
        ok, fr = cap.read()
        if not ok:
            break
        if i in missing:
            cv2.imwrite(os.path.join(FRAME_DIR, f"akun_{i:04d}.png"), fr)
            missing.discard(i)
        i += 1
    cap.release()


def select_gt() -> dict:
    """The select subset only (checkpoint selection never sees the val
    images): name -> (path, box fractions)."""
    return {n: (p, b) for n, (p, b, _r) in load_gt(roles=("select",)).items()}


def _square_crop(arr: np.ndarray, box_px, margin: float = 0.15):
    """The box's square crop with a margin, zero-padded: (crop, (x0, y0, side))."""
    H, W = arr.shape[:2]
    x0, y0, x1, y1 = box_px
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    side = max(x1 - x0, y1 - y0) * (1 + margin)
    x0, y0 = cx - side / 2, cy - side / 2
    xi, yi = int(max(x0, 0)), int(max(y0, 0))
    xj, yj = int(min(x0 + side, W)), int(min(y0 + side, H))
    crop = arr[yi:yj, xi:xj]
    s = max(crop.shape[0], crop.shape[1])
    pad = np.zeros((s, s, 3), arr.dtype)
    pad[:crop.shape[0], :crop.shape[1]] = crop
    return pad, (xi, yi, s)


def pose_probe_crops(roles=("select",)) -> list:
    """Pose ground truth in crop coordinates for the images with Body-25
    annotations: dicts of crop (S, S, 3) in [-1, 1], ids (J,) Body-25 joint
    ids, gt_ndc (J, 2), thr_ndc (PCK@0.1 of the person's height, in NDC),
    origin, gt_px and person_h_px. Images not on disk are left out."""
    from PIL import Image

    with open(GT_PATH) as f:
        reg = json.load(f)["images"]
    out = []
    for name, (path, frac, role) in load_gt(roles=roles).items():
        entry = reg[name]
        if "kps25" not in entry or not os.path.exists(path):
            continue
        arr = np.asarray(Image.open(path).convert("RGB")).astype(np.float32) / 127.5 - 1.0
        H, W = arr.shape[:2]
        box = np.asarray([frac[0] * W, frac[1] * H, frac[2] * W, frac[3] * H])
        crop, (cx0, cy0, side) = _square_crop(arr, box)
        ids = np.asarray(sorted(int(k) for k in entry["kps25"]), np.int64)
        gt_px = np.asarray([entry["kps25"][str(i)] for i in ids], np.float32) * np.asarray([W, H], np.float32)
        gt_ndc = (gt_px - np.asarray([cx0, cy0], np.float32)) / side * 2.0 - 1.0
        out.append({"name": name, "role": role, "crop": crop, "ids": ids, "gt_ndc": gt_ndc,
                    "thr_ndc": float(0.1 * (box[3] - box[1]) / side * 2.0),
                    "origin": (cx0, cy0, side), "gt_px": gt_px, "person_h_px": float(box[3] - box[1])})
    return out


def rasterize_poly(poly_frac, size: int, origin=None) -> np.ndarray:
    """A traced polygon (x, y fractions of the full image) -> (size, size)
    float mask, in the square crop `origin` = (x0, y0, side, W, H) or, when
    None, in the full image's frame."""
    from PIL import Image, ImageDraw

    im = Image.new("L", (size, size), 0)
    pts = []
    for fx, fy in poly_frac:
        if origin is None:
            pts.append((fx * size, fy * size))
        else:
            x0, y0, side, W, H = origin
            pts.append(((fx * W - x0) / side * size, (fy * H - y0) / side * size))
    ImageDraw.Draw(im).polygon(pts, fill=255)
    return np.asarray(im, np.float32) / 255.0


def probes_or_none(loader):
    """`loader()`'s probe list; on any failure, or when it is empty, prints
    "real probe unavailable" and returns []."""
    try:
        probes = loader()
    except Exception as e:  # missing frames, cv2, PIL or matplotlib: no probe, as in the JAX drivers
        print(f"real probe unavailable: {e}", flush=True)
        return []
    if not probes:
        print("real probe unavailable: no probe image on disk", flush=True)
    return probes
