"""Visual inspection: SMPL overlay frames and videos for preprocessing, and
labelled image panels for training.

The port's copy of `ipercore_tpu/utils/visualizer.py`: the rendered part map
alpha-blended over the cropped frames (the `visual.mp4` that preprocessing
stage 1.7 writes; its raster is `raster_fim`, K3 on the card), and the
file-based stand-in for the reference's TensorBoard image rows.
"""
from __future__ import annotations

import os
import subprocess
from typing import Optional

import numpy as np
import torch


def smpl_overlay_frames(imgs: np.ndarray, theta: np.ndarray, model=None, assets=None,
                        alpha: float = 0.5, device="cuda") -> np.ndarray:
    """Blend the rendered SMPL part map over frames.

    Args:
        imgs: (N, S, S, 3) in [-1, 1]; theta: (N, 85). `model` defaults to
            the synthetic body, `assets` to `load_assets(model)`.

    Returns:
        (N, S, S, 3) float32 overlay frames in [-1, 1] (numpy).
    """
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.ops import rasterizer as rz

    if model is None:
        model = smpl_mod.synthetic_model(device=device)
    if assets is None:
        assets = load_assets(model, device=model.v_template.device)
    dev = model.v_template.device
    S = imgs.shape[1]
    # chunks of 8 frames at 512^2, which bound the raster's buffers
    step = max(1, 8 * (512 // max(S, 1)) ** 2)
    out = []
    for i in range(0, len(theta), step):
        d = smpl_mod.get_details(model, torch.as_tensor(np.asarray(theta[i:i + step], np.float32), device=dev))
        _, fim, _ = rz.render_fim_wim(d["verts"], d["cam"], model.faces, S)
        cond = rz.encode_fim(fim, assets.map_fn).cpu().numpy()  # (n, S, S, 3) in [0, 1]
        body = (fim >= 0)[..., None].cpu().numpy()
        chunk = imgs[i:i + step]
        out.append(chunk * (1 - alpha * body) + (cond * 2.0 - 1.0) * (alpha * body))
    return np.concatenate(out).astype(np.float32)


def write_visual_video(imgs: np.ndarray, theta: np.ndarray, out_path: str, fps: float = 25.0,
                       model=None, assets=None, device="cuda") -> Optional[str]:
    """Write the overlay as frames in `<out_path without .mp4>_frames/` and
    encode them to `out_path`. Returns the video path, or the frame folder
    when no encoder is available."""
    from ipercore_tpu_torch.utils import video as vid

    frames = smpl_overlay_frames(imgs, theta, model, assets, device=device)
    out_dir = os.path.splitext(out_path)[0] + "_frames"
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, f in enumerate(frames):
        p = os.path.join(out_dir, f"frame_{i:08d}.png")
        vid.save_image(p, f)
        paths.append(p)
    try:
        return vid.make_video(paths, out_path, fps=fps)
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return out_dir  # no working encoder: the frames are the result, as in the JAX package


def save_train_panel(path: str, rows: dict) -> str:
    """Write an image grid PNG: one row per named array, one column per batch
    sample.

    Args:
        rows: name -> (N, H, W, C) float array in [-1, 1] (C in {1, 3}).

    Returns: the written path.
    """
    from ipercore_tpu_torch.utils import video as vid

    tiles = []
    for name in rows:
        imgs = np.asarray(rows[name], np.float32)
        if imgs.ndim == 3:
            imgs = imgs[..., None]
        if imgs.shape[-1] == 1:
            imgs = np.repeat(imgs, 3, axis=-1)
        tiles.append(np.concatenate(list(imgs), axis=1))  # (H, N*W, 3)
    panel = np.concatenate(tiles, axis=0)  # (R*H, N*W, 3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    vid.save_image(path, np.clip(panel, -1.0, 1.0))
    return path
