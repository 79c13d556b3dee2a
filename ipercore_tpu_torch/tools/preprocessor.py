"""The preprocessing pipeline's geometry of stages 1.1-1.2.

The port's copy of the crop geometry of `ipercore_tpu/tools/preprocessor.py`
(the reference's `process_utils.py`): the running union of person boxes, its
enlarged square, and the square crop of a frame. The rest of the pipeline (the
`Preprocessor` stages 1.3-1.6 and `services/preprocess.py`) belongs to a later
slice of the port (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ipercore_tpu_torch.ops.sampling import resize_image


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
