"""Visual inspection of training: labelled image panels.

The port's own copy of `save_train_panel` from `ipercore_tpu/utils/visualizer.py`
(the file-based stand-in for the reference's TensorBoard image rows); the
SMPL-overlay half of that module is not ported yet.
"""
from __future__ import annotations

import os

import numpy as np


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
