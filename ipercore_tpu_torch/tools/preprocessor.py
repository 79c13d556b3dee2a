"""The 7-stage preprocessing pipeline over one input's frames.

The port's copy of `ipercore_tpu/tools/preprocessor.py` (the reference's
`base_preprocessor.py` and `preprocessors.py`):

  1.1 person boxes (`tools/detection`), their running union
  1.2 the square crop and resize
  1.3 3D pose: SPIN, then multi-hypothesis SMPLify against the 2D keypoints
      when the 2D net is trained
  1.4 matting (`tools/mattors.HumanMattor`), the SMPL silhouette as fallback
  1.5 find-front: the frames that show most of the front body and face
  1.6 background inpainting (mean background over the visible pixels, then
      `tools/inpaintors`)
  1.7 the visual overlay (`utils/visualizer.write_visual_video`)

Each stage marks itself in the ProcessInfo manifest and serialises it, so a
run that stops resumes at the stage it reached. The networks run on the
Preprocessor's device; the SMPL silhouettes, the find-front rasters and the
overlay go through `raster_fim` (K3 on the card).
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ipercore_tpu_torch.ops.sampling import resize_image
from ipercore_tpu_torch.services.process_info import ProcessInfo
from ipercore_tpu_torch.utils import video as vid


def update_active_boxes(cur_box: np.ndarray, active_box: Optional[np.ndarray]) -> np.ndarray:
    """Running union of person boxes."""
    if active_box is None:
        return cur_box.copy()
    return np.asarray([
        min(cur_box[0], active_box[0]), min(cur_box[1], active_box[1]),
        max(cur_box[2], active_box[2]), max(cur_box[3], active_box[3]),
    ], np.float32)


def fmt_active_boxes(box: np.ndarray, img_hw: tuple[int, int], factor: float = 1.25) -> np.ndarray:
    """Enlarge a box by `factor` to a square and clamp it to the image."""
    h, w = img_hw
    cx, cy = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
    bw, bh = (box[2] - box[0]) * factor, (box[3] - box[1]) * factor
    side = max(bw, bh)
    x0, y0 = cx - side / 2, cy - side / 2
    x1, y1 = cx + side / 2, cy + side / 2
    return np.asarray([max(0, x0), max(0, y0), min(w, x1), min(h, y1)], np.float32)


def process_crop_img(img: np.ndarray, box: np.ndarray, out_size: int,
                     device="cuda") -> tuple[np.ndarray, dict]:
    """Square crop + zero pad + linear resize (antialiased when it shrinks,
    as `jax.image.resize`) to `out_size`², the resize on `device`.

    Returns the crop (numpy, the image's dtype) and the geometry that maps
    coordinates back: `start_pt`, `scale`, `crop_box`.
    """
    H, W = img.shape[:2]
    x0, y0, x1, y1 = [int(round(float(v))) for v in box]
    x0, y0 = max(0, x0), max(0, y0)
    x1, y1 = min(W, x1), min(H, y1)
    crop = img[y0:y1, x0:x1]
    ch, cw = crop.shape[:2]
    side = max(ch, cw, 1)
    pad_y, pad_x = (side - ch) // 2, (side - cw) // 2
    sq = np.zeros((side, side, img.shape[2]), img.dtype)
    sq[pad_y:pad_y + ch, pad_x:pad_x + cw] = crop
    out = resize_image(torch.as_tensor(sq, device=device), out_size, out_size)
    geom = {
        "start_pt": (x0 - pad_x, y0 - pad_y),
        "scale": out_size / side,
        "crop_box": (x0, y0, x1, y1),
    }
    return out.cpu().numpy(), geom


def background_visibility(masks: np.ndarray, sil: np.ndarray, image_size: int,
                          device="cuda") -> np.ndarray:
    """Per-frame weights of trustworthy background pixels.

    masks: (N, S, S, 1) background = 1 (stage 1.4's convention); sil:
    (N, S, S, 1) person = 1 (the SMPL silhouette). Returns (N, S, S, 1) in
    {0, 1}: 1 outside the union of both person sources dilated by
    max(9, S // 32 | 1) pixels (a person pixel the matte misses would
    otherwise be baked into the background), in chunks of 16 on `device`.
    """
    from ipercore_tpu_torch.ops.morphology import dilate

    person = np.maximum(1.0 - masks, sil)
    ks = max(9, (image_size // 32) | 1)
    person = np.concatenate(
        [dilate(torch.as_tensor(person[i:i + 16], dtype=torch.float32, device=device), ks).cpu().numpy()
         for i in range(0, len(person), 16)])
    return 1.0 - person


class Preprocessor:
    """The stage pipeline. `smoke=True` shrinks every model (a tiny body
    mesh, no SMPLify, small nets) so that the whole pipeline runs in seconds;
    the stages and the manifest are the same. The networks are built on first
    use (`pose2d`, `spin`, `mattor`, `inpaintor`); a caller may set `_pose2d`,
    `_spin`, `_mattor` or `_inpaintor` first to hand in its own. An injected
    mattor also serves detection's segmenter; otherwise detection builds its
    own `HumanMattor` from the same weight files, as the JAX package does."""

    def __init__(self, image_size: int = 512, use_smplify: bool = True,
                 find_front_size: int = 256, body_model=None, smoke: bool = False, device="cuda"):
        self.device = torch.device(device)
        self.image_size = image_size
        self.smoke = smoke
        self.use_smplify = use_smplify and not smoke
        self.find_front_size = 128 if smoke else find_front_size
        self.save_visual = not smoke
        self._body_model = body_model
        self._pose2d = None
        self._spin = None
        self._mattor = None
        self._inpaintor = None
        # one record per `execute`: the input's name, the wall seconds of
        # each stage that ran, detection's method, the matte's gate and band
        # per frame, and what the overlay wrote
        self.reports: list[dict] = []

    @property
    def body_model(self):
        if self._body_model is None:
            from ipercore_tpu_torch.models import smpl as smpl_mod

            self._body_model = (smpl_mod.synthetic_model(nu=20, nv=18, device=self.device)
                                if self.smoke else smpl_mod.template_model(device=self.device))
        return self._body_model

    @property
    def pose2d(self):
        if self._pose2d is None:
            from ipercore_tpu_torch.tools.pose2d import OpenPoseRunner

            self._pose2d = OpenPoseRunner(device=self.device)
        return self._pose2d

    @property
    def spin(self):
        if self._spin is None:
            from ipercore_tpu_torch.tools.pose3d import SPINRunner

            self._spin = SPINRunner(device=self.device)
        return self._spin

    @property
    def mattor(self):
        if self._mattor is None:
            from ipercore_tpu_torch.tools.mattors import build_mattor

            self._mattor = build_mattor(device=self.device)
        return self._mattor

    @property
    def inpaintor(self):
        if self._inpaintor is None:
            from ipercore_tpu_torch.tools.inpaintors import build_background_inpaintors

            self._inpaintor = build_background_inpaintors(control_size=64 if self.smoke else 256,
                                                          device=self.device)
        return self._inpaintor

    def execute(self, info: ProcessInfo, frame_paths: list[str], out_img_dir: str,
                is_src: bool = False) -> ProcessInfo:
        """Run stages 1.1-1.7 on `frame_paths`, writing the crops to
        `out_img_dir` and the arrays into `info`."""
        os.makedirs(out_img_dir, exist_ok=True)
        S = self.image_size
        report = {"name": info.name, "stage_s": {}}
        self.reports.append(report)
        t0 = time.perf_counter()

        def lap(stage):
            nonlocal t0
            report["stage_s"][stage] = time.perf_counter() - t0
            t0 = time.perf_counter()

        # --- 1.1 + 1.2: detect + crop --------------------------------------
        if not info.has_run("cropper"):
            from ipercore_tpu_torch.tools.detection import (SegmentationDetector, detect_person_boxes,
                                                            track_person_boxes)

            frames = np.stack([vid.load_image(p) for p in frame_paths])
            H, W = frames.shape[1:3]
            # the median-background tracker in smoke runs; else every source
            # of detection, the winner's provenance recorded
            if self.smoke:
                tracked = track_person_boxes(frames)
                method = "median_bg" if tracked is not None else "none"
            else:
                tracked, method = detect_person_boxes(
                    frames, seg_detector=SegmentationDetector(mattor=self._mattor, device=self.device),
                    pose2d=self.pose2d, device=self.device)
            report["detect_method"] = method
            lap("detect")
            if tracked is not None:
                active_box = None
                for b in tracked:
                    active_box = update_active_boxes(b, active_box)
                box = fmt_active_boxes(active_box, (H, W), factor=1.25)
            else:
                box = fmt_active_boxes(np.asarray([0, 0, W, H], np.float32), (H, W), factor=1.0)
            names, geoms = [], []
            for i, img in enumerate(frames):
                crop, geom = process_crop_img(img, box, S, device=self.device)
                name = f"{i:08d}.png"
                vid.save_image(os.path.join(out_img_dir, name), crop)
                names.append(name)
                geoms.append([*geom["start_pt"], geom["scale"]])
            info.meta["valid_img_names"] = names
            info.set_array("crop_geom", np.asarray(geoms, np.float32))
            if tracked is not None:
                info.set_array("person_boxes", tracked.astype(np.float32))
            info.mark_run("detector", n_frames=len(names), detected=bool(tracked is not None), method=method)
            info.mark_run("cropper", box=[float(v) for v in box])
            info.serialize()
            lap("crop")

        names = info.meta["valid_img_names"]
        imgs = np.stack([vid.load_image(os.path.join(out_img_dir, n), size=S) for n in names])
        lap("load_crops")

        # --- 1.3 pose3d ------------------------------------------------------
        if not info.has_run("pose3d"):
            if self.smoke:
                # camera-centred default thetas: the stage's structure without the nets
                theta = np.zeros((len(imgs), 85), np.float32)
                theta[:, 0] = 1.1
            else:
                theta = self._pose3d(imgs)
            info.set_array("smpls", theta.astype(np.float32))
            info.mark_run("pose3d")
            info.serialize()
            lap("pose3d")
        theta = info.get_array("smpls")

        # --- 1.4 matting -------------------------------------------------------
        if not info.has_run("parser"):
            sil = self._smpl_silhouette(theta)
            alpha, _ = self.mattor.run(imgs, fallback_mask=sil)
            # stored with background = 1, as the reference's masks (1 - alpha)
            info.set_array("masks", (1.0 - alpha).astype(np.float32))
            info.mark_run("parser")
            info.serialize()
            report["matte"] = self.mattor.last_run
            lap("mattes")

        # --- 1.5 find front ----------------------------------------------------
        if not info.has_run("find_front"):
            ft_ids, bk_ids = self._find_front(theta)
            info.set_array("ft_ids", ft_ids)
            info.set_array("bk_ids", bk_ids)
            info.mark_run("find_front")
            info.serialize()
            lap("find_front")

        # --- 1.6 background inpaint (sources only) ------------------------------
        if not info.has_run("inpaintor"):
            if is_src:
                masks = info.get_array("masks")  # (N, S, S, 1) background = 1
                vis = background_visibility(masks, self._smpl_silhouette(theta), S, device=self.device)
                # the mean background over the frames where each pixel is visible
                acc = (imgs * vis).sum(0) / np.maximum(vis.sum(0), 1e-5)
                hole = (vis.sum(0) < 0.5).astype(np.float32)
                bg = self.inpaintor.run_inpainting(acc, hole)
                vid.save_image(os.path.join(os.path.dirname(out_img_dir), "background.png"), bg)
            info.mark_run("inpaintor")
            info.serialize()
            lap("inpaint")

        # --- 1.7 the visual overlay --------------------------------------------
        if self.save_visual:
            from ipercore_tpu_torch.utils.visualizer import write_visual_video

            report["visual"] = write_visual_video(
                imgs, theta, os.path.join(os.path.dirname(out_img_dir), "visual.mp4"),
                model=self.body_model, device=self.device)
            lap("visual")
        return info

    def _pose3d(self, imgs: np.ndarray) -> np.ndarray:
        """SPIN at 224^2; with a trained 2D net, SMPLify against its tracked
        keypoints (at the net's trained size), keeping SPIN's pose for frames
        where SMPLify diverged and the SPIN pose explains the keypoints
        better. Returns numpy theta (N, 85)."""
        from ipercore_tpu_torch.tools.pose2d import body25_to_cocoplus
        from ipercore_tpu_torch.tools.pose3d import (GMM_DEFAULT_WEIGHTS, HMR_IMG_SIZE, load_gmm_prior,
                                                     reprojection_error, smplify_refine_multi)
        from ipercore_tpu_torch.utils.smoothing import pose2d_temporal_filter, pose_temporal_smooth

        x = torch.as_tensor(imgs, device=self.device)
        spin_in = resize_image(x, HMR_IMG_SIZE, HMR_IMG_SIZE)
        theta = self.spin.run(spin_in)
        # random keypoints of an untrained 2D net would corrupt the SPIN fit
        if not (self.use_smplify and self.pose2d.trained):
            return theta
        p2s = self.pose2d.trained_size or HMR_IMG_SIZE
        pose_in = spin_in if p2s == HMR_IMG_SIZE else resize_image(x, p2s, p2s)
        t0 = time.perf_counter()
        kps, scores, valid = self.pose2d.run_tracked_robust(pose_in.cpu().numpy())
        self.reports[-1]["stage_s"]["pose2d_in_pose3d"] = time.perf_counter() - t0
        if len(kps) > 5:
            # the left / right swap fix against the median track
            stacked = pose2d_temporal_filter(np.concatenate([kps, (scores * valid)[..., None]], axis=-1),
                                             window_size=5)
            kps19, conf19 = body25_to_cocoplus(stacked[..., :2], stacked[..., 2])
        else:
            kps19, conf19 = body25_to_cocoplus(kps, scores * valid)
        model = self.body_model
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        kps_t, conf_t = as_t(kps19), as_t(conf19)
        init_theta = theta
        prior = load_gmm_prior(GMM_DEFAULT_WEIGHTS, device=self.device)
        theta = smplify_refine_multi(model, as_t(theta), kps_t, conf_t, prior=prior).cpu().numpy()
        # outliers fall back to the SPIN init, where it explains the keypoints better
        fb = pose_temporal_smooth(init_theta[:, 3:-10], theta[:, 3:-10])
        diverged = np.abs(fb - theta[:, 3:-10]).sum(1) > 1e-6
        if diverged.any():
            e_init = reprojection_error(model, as_t(init_theta), kps_t, conf_t).cpu().numpy()
            e_opt = reprojection_error(model, as_t(theta), kps_t, conf_t).cpu().numpy()
            take = diverged & (e_init < e_opt)
            theta[take, 3:-10] = init_theta[take, 3:-10]
        return theta

    def _smpl_silhouette(self, theta: np.ndarray, batch_size: int = 16) -> np.ndarray:
        """The rendered SMPL body silhouette (person = 1), the matting
        fallback: rastered through `raster_fim` at min(S, 256)^2 in chunks of
        `batch_size` frames, resized linearly to S^2 and thresholded at 0.5.
        Returns numpy (N, S, S, 1)."""
        from ipercore_tpu_torch.models import smpl as smpl_mod
        from ipercore_tpu_torch.ops import rasterizer as rz

        model = self.body_model
        S = self.image_size
        rS = min(S, 256)
        out = []
        for i in range(0, len(theta), batch_size):
            d = smpl_mod.get_details(model, torch.as_tensor(theta[i:i + batch_size], device=self.device))
            _, fim, _ = rz.render_fim_wim(d["verts"], d["cam"], model.faces, rS)
            sil = (fim >= 0).float()[..., None]
            if rS != S:
                sil = (resize_image(sil, S, S) > 0.5).float()
            out.append(sil.cpu().numpy())
        return np.concatenate(out)

    def _find_front(self, theta: np.ndarray):
        """Count the visible front-body and facial faces of each frame
        (rastered in chunks of 32); the first half of the frames by that
        count, in `np.argsort(-count)` order, are the front ids, the rest
        (reversed) the back ids."""
        from ipercore_tpu_torch.models import smpl as smpl_mod
        from ipercore_tpu_torch.models.mesh import load_assets
        from ipercore_tpu_torch.ops import rasterizer as rz

        model = self.body_model
        assets = load_assets(model, device=self.device, synthetic=self.smoke)
        size = self.find_front_size if self.find_front_size % 128 == 0 else 256
        F = model.faces.shape[0]
        counts = []
        for i in range(0, len(theta), 32):
            d = smpl_mod.get_details(model, torch.as_tensor(theta[i:i + 32], device=self.device))
            _, fim, _ = rz.render_fim_wim(d["verts"], d["cam"], model.faces, size)
            vis = rz.visible_face_mask(fim, F)
            counts.append(((vis & assets.facial_face_mask[None]).sum(1)
                           + (vis & assets.front_face_mask[None]).sum(1)).cpu().numpy())
        order = np.argsort(-np.concatenate(counts))
        n = len(order)
        ft_ids = order[: max(n // 2, 1)].astype(np.int32)
        bk_ids = order[max(n // 2, 1):][::-1].astype(np.int32)
        if len(bk_ids) == 0:
            bk_ids = ft_ids
        return ft_ids, bk_ids
