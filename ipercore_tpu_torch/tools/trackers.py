"""Human trackers: pick the person to process in each frame.

The port's copy of `ipercore_tpu/tools/trackers.py` (host numpy; the
reference's `human_trackers/max_box_tracker.py`): the single-person
assumption — per frame, take the largest-area detection box; track
continuity by IoU with the running box.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def box_area(boxes: np.ndarray) -> np.ndarray:
    """(N, 4) xyxy boxes -> (N,) areas."""
    return np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(boxes[:, 3] - boxes[:, 1], 0)


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between one box (4,) and boxes (N, 4)."""
    x0 = np.maximum(a[0], b[:, 0])
    y0 = np.maximum(a[1], b[:, 1])
    x1 = np.minimum(a[2], b[:, 2])
    y1 = np.minimum(a[3], b[:, 3])
    inter = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
    union = box_area(a[None])[0] + box_area(b) - inter
    return inter / np.maximum(union, 1e-8)


def get_largest_instance(boxes: np.ndarray) -> Optional[int]:
    """Index of the largest-area box — `max_box_tracker.py:9`."""
    if boxes is None or len(boxes) == 0:
        return None
    return int(np.argmax(box_area(boxes)))


class MaxBoxTracker:
    """Largest-box tracker with IoU continuity — `MaxBoxTracker` (:46-97)."""

    def __init__(self, iou_continuity: float = 0.3):
        self.iou_continuity = iou_continuity
        self.prev_box: Optional[np.ndarray] = None

    def __call__(self, boxes: np.ndarray) -> Optional[np.ndarray]:
        if boxes is None or len(boxes) == 0:
            return self.prev_box
        boxes = np.asarray(boxes, np.float32)
        if self.prev_box is not None:
            ious = box_iou(self.prev_box, boxes)
            if ious.max() >= self.iou_continuity:
                idx = int(np.argmax(ious * np.sqrt(box_area(boxes))))
            else:
                idx = get_largest_instance(boxes)
        else:
            idx = get_largest_instance(boxes)
        self.prev_box = boxes[idx]
        return self.prev_box

    def reset(self):
        self.prev_box = None


def build_tracker(name: str = "max_box", **kw) -> MaxBoxTracker:
    if name != "max_box":
        raise KeyError(f"unknown tracker {name!r}")
    return MaxBoxTracker(**kw)
