"""Evaluate perception weights on the annotated real sample media.

Twin of `scripts/eval_real_photos.py`: the probes the training drivers select
checkpoints with (`load_gt`, `select_gt`, `pose_probe_crops`,
`rasterize_poly`) and the evaluation itself. `assets/real_gt.json` lists the
annotated images, split into `select` (checkpoint selection) and `val` (held
out): frames of the reference's sample clip (extracted with cv2 into
`.cache/real_frames/` on first use), one still, and matplotlib's sample
images. The reference's samples are found under `$IPERCORE_REFERENCE_SAMPLES`
(its `assets/samples` directory); without them, or without the extracted
frames, a probe has no images and the trainers say "real probe unavailable".

For a segmenter weights file `main` reports, per image on disk, the mask's
coverage of the annotated box, the false positives outside it and the box
IoU of the production stage-1.1 path (`person_components` +
`_merge_aligned_components` + `zoom_refine`), and the mean box IoU of each
subset; `--pose` adds Body-25 and Mobilenet PCK@0.1, SPIN's reprojection and
the SPIN + SMPLify chain (`eval_pose`), `--mask` the mask IoU against the
traced silhouettes (`eval_masks`).

    python -m ipercore_tpu_torch.scripts.eval_real_photos [--weights assets/person_seg.npz] [--pose] [--mask] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ipercore_tpu_torch.scripts._common import REPO_DIR, resolve_device

MOBILENET_INPUT = 256  # the JAX runner's default `input_size`, at which `eval_pose` runs it

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


def _load(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB")).astype(np.float32) / 127.5 - 1.0


def _resized(crop: np.ndarray, size: int) -> np.ndarray:
    from ipercore_tpu_torch.data.datasets import resize_linear

    return resize_linear(crop[None], (1, size, size, 3))


def eval_pose(roles=("select", "val"), crop_size: int = None, device="cuda") -> dict:
    """Body-25 and Mobilenet PCK@0.1, SPIN's reprojection and the chain
    (SPIN, then multi-hypothesis SMPLify against Body-25's keypoints,
    `refined_pck01`) on the images with Body-25 annotations; each net only
    when it is trained (`eval_pose`, `:154-271`)."""
    import torch

    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.tools.pose2d import body25_to_cocoplus, build_pose2d_estimator
    from ipercore_tpu_torch.tools.pose2d_mobilenet import MobilenetOpenPoseRunner
    from ipercore_tpu_torch.tools.pose3d import GMM_DEFAULT_WEIGHTS, SPINRunner, load_gmm_prior, smplify_refine_multi
    from ipercore_tpu_torch.tools.synth_data import body25_from_cocoplus

    pose2d = build_pose2d_estimator(device=device)
    mobilenet = MobilenetOpenPoseRunner(device=device)
    spin = SPINRunner(device=device)
    model = smpl_mod.template_model(device=device)
    prior = load_gmm_prior(GMM_DEFAULT_WEIGHTS, device=device)
    p2d_size = crop_size or pose2d.trained_size or 224
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    out = {}
    for p in pose_probe_crops(roles=roles):
        crop, ids, gt_px = p["crop"], p["ids"], p["gt_px"]
        cx0, cy0, side = p["origin"]
        h = p["person_h_px"]
        thr = 0.1 * h
        rec = {"role": p["role"], "n_joints": int(len(ids))}
        kps2d = None

        def to_px(kps_ndc):
            return (kps_ndc + 1.0) * 0.5 * side + np.asarray([cx0, cy0])

        def scores_of(px, gt, prefix):
            err = np.linalg.norm(px - gt, axis=-1)
            rec[f"{prefix}_pck01"] = round(float((err < thr).mean()), 4)
            rec[f"{prefix}_err_frac"] = round(float(err.mean() / h), 4)

        if pose2d.trained:
            # the production stage-1.3 path, with the degenerate-decode recovery
            kps, scores, vmask2 = pose2d.run_tracked_robust(_resized(crop, p2d_size), smooth=False)
            kps2d = (kps, scores * vmask2)
            scores_of(to_px(kps[0][ids]), gt_px, "pose2d")
        if mobilenet.trained:
            # COCO-18 fills 17 of the 25 slots (and mid-hip): only the joints it gives
            kps, scores, valid = mobilenet.run(_resized(crop, MOBILENET_INPUT))
            vmask = np.asarray(valid)[0][ids]
            if vmask.any():
                scores_of(to_px(kps[0][ids][vmask]), gt_px[vmask], "mobilenet")
                rec["mobilenet_n_valid"] = int(vmask.sum())
        if spin.trained:
            theta = spin.run(_resized(crop, 224))

            def joints(th):
                b25, valid = body25_from_cocoplus(smpl_mod.get_details(model, t(th))["j2d"])
                vm = np.asarray(valid)[ids] > 0
                return to_px(b25[0].detach().cpu().numpy()[ids][vm]), vm

            px, vm = joints(theta)
            scores_of(px, gt_px[vm], "spin")
            if kps2d is not None:  # the chain: SMPLify from SPIN against the detected keypoints
                kps19, conf19 = body25_to_cocoplus(*kps2d)
                theta_ref = smplify_refine_multi(model, t(theta), t(kps19), t(conf19), prior=prior)
                px, vm = joints(theta_ref.detach())
                scores_of(px, gt_px[vm], "refined")
        out[p["name"]] = rec
    return out


def eval_masks(mattor=None, work: int = 256, device="cuda") -> dict:
    """The production `HumanMattor` on each annotated image's box crop at
    work², against the traced silhouette: mask IoU, alpha MAD, coverage of
    the polygon and false positives outside it (`eval_masks`, `:274-314`)."""
    from ipercore_tpu_torch.tools.mattors import HumanMattor

    mattor = mattor or HumanMattor(device=device)
    with open(GT_PATH) as f:
        reg = json.load(f)["images"]
    out = {}
    for name, (path, frac, role) in load_gt().items():
        e = reg[name]
        if "mask_poly" not in e or not os.path.exists(path):
            continue
        arr = _load(path)
        H, W = arr.shape[:2]
        box = np.asarray([frac[0] * W, frac[1] * H, frac[2] * W, frac[3] * H])
        crop, (x0, y0, side) = _square_crop(arr, box)
        alpha, mask = mattor.run(_resized(crop, work))
        gt = rasterize_poly(e["mask_poly"], work, (x0, y0, side, W, H))
        m, g = mask[0, ..., 0] > 0.5, gt > 0.5
        out[name] = {"role": role, "mask_iou": round(float((m & g).sum() / max((m | g).sum(), 1)), 4),
                     "alpha_mad": round(float(np.abs(alpha[0, ..., 0] - gt).mean()), 4),
                     "coverage_in_poly": round(float(m[g].mean()), 4) if g.any() else 0.0,
                     "fp_out_poly": round(float(m[~g].mean()), 4)}
    return out


def box_record(det, arr: np.ndarray, gt_frac, role: str) -> dict:
    """One image's in-box coverage, out-of-box false positives, and the box
    and box IoU of the stage-1.1 segmenter path (`:346-379`)."""
    from ipercore_tpu_torch.tools.detection import _iou, _merge_aligned_components, person_components

    H, W = arr.shape[:2]
    gt = np.asarray([gt_frac[0] * W, gt_frac[1] * H, gt_frac[2] * W, gt_frac[3] * H])
    prob = det.run_probs(arr[None])[0]
    work = det.work
    gx = (gt * np.asarray([work / W, work / H] * 2)).astype(int)
    inside = prob[gx[1]:gx[3], gx[0]:gx[2]] > 0.5
    fp = ((prob > 0.5).sum() - inside.sum()) / max(work * work - inside.size, 1)
    rec = {"role": role, "in_box_coverage": round(float(inside.mean()), 4), "out_box_fp": round(float(fp), 4)}
    cb, cs = person_components(prob, min_area=max(int(det.min_area_frac * work * work), 8))
    if len(cb):
        coarse = _merge_aligned_components(cb, cs) * np.asarray([W / work, H / work] * 2, np.float32)
        refined, ok = det.zoom_refine(arr[None], coarse[None])
        box = refined[0] if ok[0] else coarse
        rec["box"] = [round(float(v), 1) for v in box]
        rec["box_iou"] = round(_iou(box, gt), 4)
    else:
        rec["box"], rec["box_iou"] = None, 0.0
    return rec


def main(argv=None) -> dict:
    from ipercore_tpu_torch.tools.detection import SegmentationDetector
    from ipercore_tpu_torch.tools.mattors import HumanMattor
    from ipercore_tpu_torch.utils.checkpoint import WEIGHTS_DIR

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", type=str, default=os.path.join(WEIGHTS_DIR, "person_seg.npz"))
    ap.add_argument("--pose", action="store_true",
                    help="also report OpenPose PCK@0.1 + SPIN reprojection on the kps25-annotated images")
    ap.add_argument("--mask", action="store_true",
                    help="also report mask IoU / alpha MAD vs the hand-traced silhouette polygons")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    det = SegmentationDetector(mattor=HumanMattor(weights_path=args.weights, device=device), device=device)
    if not det.available:
        out = {"error": f"no trained weights at {args.weights}"}
        print(json.dumps(out))
        return out
    out = {"weights": args.weights}
    ious = {"select": [], "val": []}
    for name, (path, gt_frac, role) in load_gt().items():
        if not os.path.exists(path):
            out[name] = "input absent"
            continue
        rec = box_record(det, _load(path), gt_frac, role)
        ious[role].append(rec["box_iou"])
        out[name] = rec
    for role in ("select", "val"):
        if ious[role]:
            out[f"{role}_quality"] = round(float(np.mean(ious[role])), 4)
    out["quality"] = out.get("val_quality", 0.0)  # the held-out number
    if args.pose:
        out["pose"] = eval_pose(device=device)
    if args.mask:
        out["mask"] = eval_masks(device=device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
