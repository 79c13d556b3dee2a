"""Person detection for preprocessing stage 1.1.

The port's copy of `ipercore_tpu/tools/detection.py`. Sources of person
boxes, each gated by its own sanity check: a temporal-median background model
+ per-frame foreground difference + morphological cleanup + connected
components (videos, static camera); the trained `PersonSegUNet`
(`tools/mattors.py`, stills and moving cameras) with person-likeness
component scoring and zoom refinement; confident 2D-pose keypoint boxes
(`tools/pose2d.py`); and an iterated colour model for stills. Candidate boxes
feed `MaxBoxTracker`.

The networks and the resize of full frames for the pose net run on the
device; the coarse grids, the component labeling (the port's native
union-find, `utils/native.cc_boxes`, and `scipy.ndimage` where the JAX package
uses it) and the colour model stay on the host, where the JAX package keeps
them. `_cc_boxes_plain` is the Python BFS the native labeling is held against.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.tools.trackers import MaxBoxTracker

WORK = 160  # working resolution for the foreground grid


def _resize(imgs: np.ndarray, size: int) -> np.ndarray:
    """Host-side downsample to (N, size, size, C): integer box-pooling, then
    `resize_linear` (the copy of `jax.image.resize(..., "linear")`) of the
    already small remainder. Detection reads coarse grids only, so the heavy
    bytes of full frames stay on the host."""
    n, h, w, c = imgs.shape
    kh, kw = max(h // size, 1), max(w // size, 1)
    if kh > 1 or kw > 1:
        hh, ww = (h // kh) * kh, (w // kw) * kw
        imgs = imgs[:, :hh, :ww]
        imgs = imgs.reshape(n, hh // kh, kh, ww // kw, kw, c).mean(axis=(2, 4))
    if imgs.shape[1] == size and imgs.shape[2] == size:
        return np.asarray(imgs, np.float32)
    return resize_linear(imgs.astype(np.float32), (n, size, size, c))


def median_background(frames: np.ndarray, max_samples: int = 24) -> np.ndarray:
    """Per-pixel temporal median over (a subsample of) the frames — the static
    -camera background model. frames: (N, H, W, 3) in [-1, 1]."""
    n = len(frames)
    ids = np.linspace(0, n - 1, min(n, max_samples)).astype(np.int64)
    return np.median(frames[ids], axis=0)


def foreground_masks(frames: np.ndarray, bg: np.ndarray,
                     thresh: Optional[float] = None) -> np.ndarray:
    """(N, H, W) bool foreground = |frame - background| above a robust threshold."""
    diff = np.abs(frames - bg[None]).sum(axis=-1)  # (N, H, W)
    if thresh is None:
        # robust: background pixels dominate, so a high quantile of the
        # per-pixel median diff separates the person
        flat = diff.reshape(len(frames), -1)
        med = np.median(flat, axis=1, keepdims=True)
        mad = np.median(np.abs(flat - med), axis=1, keepdims=True) + 1e-6
        mask = flat > (med + 6.0 * mad)
        return mask.reshape(diff.shape)
    return diff > thresh


def _clean(mask: np.ndarray, it: int = 1) -> np.ndarray:
    """Morphological open+close on a bool grid (3x3), pure numpy."""
    def erode(m):
        p = np.pad(m, 1)
        out = p[1:-1, 1:-1].copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                out &= p[1 + dy:p.shape[0] - 1 + dy, 1 + dx:p.shape[1] - 1 + dx]
        return out

    def dilate(m):
        p = np.pad(m, 1)
        out = p[1:-1, 1:-1].copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                out |= p[1 + dy:p.shape[0] - 1 + dy, 1 + dx:p.shape[1] - 1 + dx]
        return out

    for _ in range(it):
        mask = dilate(erode(mask))   # open: drop speckles
        mask = erode(dilate(mask))   # close: fill pinholes
    return mask


def connected_component_boxes(mask: np.ndarray, min_area: int = 16) -> np.ndarray:
    """(H, W) bool -> (K, 4) xyxy boxes of connected components (8-conn),
    the largest first (at most 256), by the native union-find
    (`csrc/cclabel.cpp`)."""
    from ipercore_tpu_torch.utils import native

    if mask.size == 0:
        return np.zeros((0, 4), np.float32)
    nat = native.cc_boxes(mask)
    keep = nat[nat[:, 4] >= min_area]
    return keep[:, :4].astype(np.float32).reshape(-1, 4)


def _cc_boxes_plain(mask: np.ndarray, min_area: int = 16) -> np.ndarray:
    """The Python BFS of `connected_component_boxes`: the same boxes, in
    raster order of each component's first pixel and without a cap."""
    h, w = mask.shape
    seen = np.zeros_like(mask, bool)
    boxes = []
    ys, xs = np.nonzero(mask)
    for y0, x0 in zip(ys, xs):
        if seen[y0, x0]:
            continue
        stack = [(y0, x0)]
        seen[y0, x0] = True
        ymin = ymax = y0
        xmin = xmax = x0
        area = 0
        while stack:
            y, x = stack.pop()
            area += 1
            ymin, ymax = min(ymin, y), max(ymax, y)
            xmin, xmax = min(xmin, x), max(xmax, x)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ny, nx = y + dy, x + dx
                    if 0 <= ny < h and 0 <= nx < w and mask[ny, nx] and not seen[ny, nx]:
                        seen[ny, nx] = True
                        stack.append((ny, nx))
        if area >= min_area:
            boxes.append([xmin, ymin, xmax + 1, ymax + 1])
    return np.asarray(boxes, np.float32).reshape(-1, 4)


class PersonDetector:
    """Stage-1.1 detector: per-frame candidate person boxes in ORIGINAL image
    coordinates, from a median-background foreground model."""

    def __init__(self, min_area_frac: float = 0.003):
        self.min_area_frac = min_area_frac

    def run(self, frames: np.ndarray) -> list[np.ndarray]:
        """frames: (N, H, W, 3) in [-1, 1]. Returns a list of (K_i, 4) xyxy
        float boxes per frame (possibly empty)."""
        n, H, W = frames.shape[0], frames.shape[1], frames.shape[2]
        small = _resize(frames, WORK)
        bg = median_background(small)
        fg = foreground_masks(small, bg)
        min_area = max(int(self.min_area_frac * WORK * WORK), 4)
        sx, sy = W / WORK, H / WORK
        out = []
        for i in range(n):
            m = _clean(fg[i])
            boxes = connected_component_boxes(m, min_area=min_area)
            if len(boxes):
                boxes = boxes * np.asarray([sx, sy, sx, sy], np.float32)
            out.append(boxes)
        return out


def person_components(prob: np.ndarray, min_area: int = 32,
                      aspect_mu: float = 2.2, aspect_sigma: float = 0.6,
                      aspect_scale: float = 1.0
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Score connected components of a segmentation probability map by
    person-likeness. The score is

        mean in-mask probability × bounding-box fill × aspect prior × √area

    where the aspect prior is log-normal around h/w ≈ 2.2 (standing people;
    sitting ≈ 1 still scores ~0.4, pavements/hedges at 0.2-0.3 score ~0).
    This replaces all-or-nothing `mask_is_compact` gating of the UNION mask:
    a correct person component survives false-positive texture blobs
    elsewhere in the frame.

    Each component is scored against its OWN label mask (not the union mask
    within its bbox), so adjacent large blobs cannot inflate a component's
    fill/confidence. `aspect_scale` maps the working-grid aspect back to the
    source-image aspect when the grid was non-uniformly resized (a crop of
    aspect ch/cw squashed to a square has aspect_scale = ch/cw).

    Args: prob (H, W) float in [0, 1].
    Returns (boxes (K, 4) xyxy float, scores (K,)), sorted by score desc.
    """
    from scipy import ndimage

    m = _clean(prob > 0.5)
    labels, n_comp = ndimage.label(m, structure=np.ones((3, 3), np.int32))
    if n_comp == 0:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
    slices = ndimage.find_objects(labels)
    boxes, scores = [], []
    for ci, sl in enumerate(slices):
        if sl is None:
            continue
        ysl, xsl = sl
        comp = labels[ysl, xsl] == (ci + 1)
        area = int(comp.sum())
        if area < min_area:
            continue
        y0, y1 = ysl.start, ysl.stop
        x0, x1 = xsl.start, xsl.stop
        fill = area / comp.size
        conf = float(prob[ysl, xsl][comp].mean())
        ar = (y1 - y0) / max(x1 - x0, 1) * aspect_scale
        ar_s = float(np.exp(-0.5 * ((np.log(max(ar, 1e-3))
                                     - np.log(aspect_mu)) / aspect_sigma) ** 2))
        boxes.append([x0, y0, x1, y1])
        scores.append(conf * fill * ar_s * float(np.sqrt(area)))
    if not boxes:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    order = np.argsort(-scores)
    return boxes[order], scores[order]


def _merge_aligned_components(boxes: np.ndarray, scores: np.ndarray,
                              rel_score: float = 0.12,
                              min_x_overlap: float = 0.5) -> np.ndarray:
    """Union the best component with lower-scoring components that are
    vertically stacked with it (x-intervals overlap ≥ `min_x_overlap` of the
    smaller). A person often splits into torso + legs when a waistline or a
    bright path crosses the silhouette; the parts share a column range while
    texture blobs elsewhere do not. Returns one xyxy box."""
    best = boxes[0].copy()
    for b, s in zip(boxes[1:], scores[1:]):
        if s < rel_score * scores[0]:
            continue
        ov = min(best[2], b[2]) - max(best[0], b[0])
        if ov < min_x_overlap * min(best[2] - best[0], b[2] - b[0]):
            continue
        best = np.asarray([min(best[0], b[0]), min(best[1], b[1]),
                           max(best[2], b[2]), max(best[3], b[3])])
    return best


class SegmentationDetector:
    """Person boxes from the trained PersonSegUNet (`tools/mattors.py`) —
    works on SINGLE STILL IMAGES and moving cameras, where the
    median-background model cannot. This is the repo's counterpart of the
    reference's detection-by-instance-segmentation design
    (`point_render_parser.py:29-130` drives boxes from PointRend masks).

    Box extraction is two-pass: person-likeness component scoring on the
    full frame (`person_components`), then ZOOM REFINEMENT — the best
    candidate is re-segmented on its own margin-expanded crop, where the
    person occupies the scale the net was trained at (`make_theta`
    scale_range 0.55-1.6 ⇒ 30-90% of the frame) and background texture
    false-positives shrink with their area share.
    """

    def __init__(self, mattor=None, work: int = 256, min_area_frac: float = 0.005, device="cuda"):
        self._mattor = mattor
        self.work = work
        self.min_area_frac = min_area_frac
        self.device = device

    @property
    def mattor(self):
        if self._mattor is None:
            from ipercore_tpu_torch.tools.mattors import HumanMattor

            self._mattor = HumanMattor(device=self.device)
        return self._mattor

    @property
    def available(self) -> bool:
        """True when trained segmentation weights are loaded."""
        return bool(self.mattor.trained)

    def run_probs(self, frames: np.ndarray, chunk: int = 16) -> np.ndarray:
        """frames: (N, H, W, 3) in [-1, 1] -> (N, work, work) float probs,
        the segmenter on the device in chunks of `chunk` frames."""
        return self.run_probs_pre(_resize(frames, self.work), chunk=chunk)

    def run_masks(self, frames: np.ndarray, chunk: int = 16) -> np.ndarray:
        """frames: (N, H, W, 3) in [-1, 1] -> (N, work, work) bool masks."""
        prob = self.run_probs(frames, chunk=chunk)
        return np.stack([_clean(prob[i] > 0.5) for i in range(len(prob))])

    def zoom_refine(self, frames: np.ndarray, boxes: np.ndarray,
                    iters: int = 2) -> tuple[np.ndarray, np.ndarray]:
        """Refine per-frame boxes by re-segmenting margin-expanded crops.

        frames (N, H, W, 3), boxes (N, 4) xyxy original coords.
        Returns (refined (N, 4), ok (N,) bool). ok[i] is False when the
        zoomed segmentation produced nothing person-like (caller keeps the
        coarse box). Crops are batched through the segmenter as in
        `run_probs`."""
        H, W = frames.shape[1], frames.shape[2]
        boxes = boxes.astype(np.float64).copy()
        ok = np.ones((len(frames),), bool)
        min_area = max(int(self.min_area_frac * self.work * self.work), 8)
        for _ in range(iters):
            crops = []
            geoms = []
            for i, (x0, y0, x1, y1) in enumerate(boxes):
                w, h = x1 - x0, y1 - y0
                ex0, ey0 = max(0.0, x0 - 0.6 * w), max(0.0, y0 - 0.4 * h)
                ex1, ey1 = min(float(W), x1 + 0.6 * w), min(float(H), y1 + 0.8 * h)
                crops.append(frames[i, int(ey0):max(int(ey1), int(ey0) + 2),
                                    int(ex0):max(int(ex1), int(ex0) + 2)])
                geoms.append((ex0, ey0, crops[-1].shape[1], crops[-1].shape[0]))
            # crops differ in size; resize each to work² on host then batch
            small = np.stack([_resize(c[None], self.work)[0] for c in crops])
            probs = self.run_probs_pre(small)
            for i in range(len(frames)):
                # the crop (ch × cw) was squashed to a square working grid;
                # evaluate the aspect prior in source coords, not grid coords
                asc = geoms[i][3] / max(geoms[i][2], 1e-6)
                cb, cs = person_components(probs[i], min_area=min_area,
                                           aspect_scale=asc)
                if not len(cb):
                    ok[i] = False
                    continue
                merged = _merge_aligned_components(cb, cs)
                ex0, ey0, cw, ch = geoms[i]
                boxes[i] = [ex0 + merged[0] * cw / self.work,
                            ey0 + merged[1] * ch / self.work,
                            ex0 + merged[2] * cw / self.work,
                            ey0 + merged[3] * ch / self.work]
        return boxes.astype(np.float32), ok

    def run_probs_pre(self, small: np.ndarray, chunk: int = 16) -> np.ndarray:
        """`run_probs` for already-(N, work, work, 3) arrays. The tail chunk
        runs at its own size (the JAX package pads it to one compiled shape)."""
        m = self.mattor
        probs = [torch.sigmoid(m.segment(small[i:i + chunk])) for i in range(0, len(small), chunk)]
        return torch.cat(probs)[..., 0].cpu().numpy()

    def run(self, frames: np.ndarray) -> list[np.ndarray]:
        """frames: (N, H, W, 3) in [-1, 1]. Returns per-frame (K, 4) xyxy
        boxes in original coordinates (empty array when nothing fires)."""
        H, W = frames.shape[1], frames.shape[2]
        masks = self.run_masks(frames)
        min_area = max(int(self.min_area_frac * self.work * self.work), 8)
        sx, sy = W / self.work, H / self.work
        out = []
        for i in range(len(frames)):
            boxes = connected_component_boxes(masks[i], min_area=min_area)
            if len(boxes):
                boxes = boxes * np.asarray([sx, sy, sx, sy], np.float32)
            out.append(boxes)
        return out


def color_model_person_mask(img: np.ndarray, iters: int = 3,
                            bins: int = 12, center_frac: float = 0.5,
                            border_frac: float = 0.08) -> np.ndarray:
    """Person mask for a SINGLE STILL image from iterated foreground/background
    color models (GrabCut-style, histogram likelihoods instead of GMMs):
    borders seed the background model, the center box seeds the foreground,
    and 2-3 likelihood-ratio reassignment rounds tighten both. Domain-
    independent — no learned weights, so it works on photographs regardless
    of the perception nets' training domain.

    Args: img (H, W, 3) in [-1, 1] (any H=W work resolution).
    Returns: (H, W) bool mask.
    """
    h, w = img.shape[:2]
    q = np.clip(((img + 1.0) * 0.5 * bins).astype(np.int32), 0, bins - 1)
    qidx = (q[..., 0] * bins + q[..., 1]) * bins + q[..., 2]  # (h, w)
    nq = bins ** 3

    by, bx = int(h * border_frac) + 1, int(w * border_frac) + 1
    border = np.zeros((h, w), bool)
    border[:by] = border[-by:] = True
    border[:, :bx] = border[:, -bx:] = True
    cy0, cy1 = int(h * (1 - center_frac) / 2), int(h * (1 + center_frac) / 2)
    cx0, cx1 = int(w * (1 - center_frac) / 2), int(w * (1 + center_frac) / 2)
    center = np.zeros((h, w), bool)
    center[cy0:cy1, cx0:cx1] = True

    fg_mask, bg_mask = center, border
    eps = 1.0
    mask = center.copy()
    for _ in range(iters):
        fg_hist = np.bincount(qidx[fg_mask], minlength=nq).astype(np.float64)
        bg_hist = np.bincount(qidx[bg_mask], minlength=nq).astype(np.float64)
        fg_p = (fg_hist + eps) / (fg_hist.sum() + eps * nq)
        bg_p = (bg_hist + eps) / (bg_hist.sum() + eps * nq)
        llr = np.log(fg_p[qidx]) - np.log(bg_p[qidx])
        mask = _clean(llr > 0.0)
        # anchor: borders stay background, keep only components that touch
        # the center seed region
        mask &= ~border
        comp_boxes = connected_component_boxes(mask, min_area=16)
        # bound per-iteration work: only the 32 largest components matter
        if len(comp_boxes) > 32:
            areas = (comp_boxes[:, 2] - comp_boxes[:, 0]) * (
                comp_boxes[:, 3] - comp_boxes[:, 1])
            comp_boxes = comp_boxes[np.argsort(-areas)[:32]]
        keep = np.zeros_like(mask)
        for x0, y0, x1, y1 in comp_boxes.astype(int):
            if x1 > cx0 and x0 < cx1 and y1 > cy0 and y0 < cy1:
                keep[y0:y1, x0:x1] |= mask[y0:y1, x0:x1]
        mask = keep
        if not mask.any():
            return center
        fg_mask = mask
        bg_mask = border | (~_clean(mask, it=2) & ~center)
    return mask


def mask_is_compact(mask: np.ndarray,
                    min_area_frac: float = 0.04,
                    max_area_frac: float = 0.85,
                    min_fill: float = 0.45) -> bool:
    """Sanity gate for a person mask: plausible area fraction, the largest
    component fills a solid share of its own bounding box (person
    silhouettes fill ~0.45-0.65; sprawling noise blobs ~0.3), and the box
    localizes SOMETHING (a both-axes-full-frame box carries no information —
    the caller's full-frame fallback equals it). A segmenter firing on
    'everything' or on scattered noise fails this."""
    h, w = mask.shape
    area = mask.sum()
    if not (min_area_frac * h * w <= area <= max_area_frac * h * w):
        return False
    boxes = connected_component_boxes(mask, min_area=16)
    if not len(boxes):
        return False
    areas = [(b[2] - b[0]) * (b[3] - b[1]) for b in boxes]
    big = boxes[int(np.argmax(areas))]
    x0, y0, x1, y1 = big.astype(int)
    if (x1 - x0) >= 0.95 * w and (y1 - y0) >= 0.95 * h:
        return False
    comp = mask[y0:y1, x0:x1]
    if comp.mean() < min_fill:
        return False
    # the largest component must own most of the foreground
    return comp.sum() >= 0.6 * area


def still_person_boxes(frames: np.ndarray, work: int = 192) -> list[np.ndarray]:
    """Per-frame person boxes for stills via the iterated color model.
    frames: (N, H, W, 3) in [-1, 1] -> list of (K, 4) xyxy original coords."""
    n, H, W = frames.shape[0], frames.shape[1], frames.shape[2]
    small = _resize(frames, work)
    sx, sy = W / work, H / work
    out = []
    for i in range(n):
        mask = color_model_person_mask(small[i])
        boxes = connected_component_boxes(mask, min_area=32)
        if len(boxes):
            boxes = boxes * np.asarray([sx, sy, sx, sy], np.float32)
        out.append(boxes)
    return out


def pose_person_boxes(frames: np.ndarray, pose2d=None,
                      min_joints: int = 8, conf: float = 0.2,
                      min_extent: float = 0.15, device="cuda") -> list[np.ndarray]:
    """Per-frame person boxes from 2D pose keypoints.

    The OpenPose net is the one perception module with demonstrated transfer
    to photographs (validated on the bundled real sample, docs/PARITY.md), so
    its confident-keypoint bounding box is a *trained* localization source
    for stills where the median-background model has no signal — the role
    PointRend boxes play in `point_render_parser.py:29-130`.

    Gates: >= `min_joints` joints above `conf`, and the joint box must span
    >= `min_extent` of the frame in at least one axis (rejects hallucinated
    point clusters). The top edge is raised by 15% of box height when a head
    joint (nose/eyes/ears) is confident — the crown sits above it — and by
    35% when the highest confident joint is only a shoulder/neck.

    frames: (N, H, W, 3) in [-1, 1]. Returns per-frame (K, 4) xyxy original
    coords (K in {0, 1}). The frames are resized to 368² on the runner's
    device (`device` when the runner has none), and handed to its
    `run_tracked` as a tensor there.
    """
    from ipercore_tpu_torch.ops.sampling import resize_image

    if pose2d is None:
        from ipercore_tpu_torch.tools.pose2d import build_pose2d_estimator

        pose2d = build_pose2d_estimator(device=device)
    if not getattr(pose2d, "trained", False):
        return [np.zeros((0, 4), np.float32) for _ in frames]
    n, H, W = frames.shape[0], frames.shape[1], frames.shape[2]
    x = resize_image(torch.as_tensor(frames, dtype=torch.float32,
                                     device=getattr(pose2d, "device", device)), 368, 368)
    kps, scores, _valid = pose2d.run_tracked(x, smooth=False)
    out = []
    for i in range(n):
        sel = scores[i] > conf
        if sel.sum() < min_joints:
            out.append(np.zeros((0, 4), np.float32))
            continue
        k = kps[i][sel]  # NDC [-1, 1] over the full frame
        px = (k[:, 0] + 1.0) * 0.5 * W
        py = (k[:, 1] + 1.0) * 0.5 * H
        x0, x1 = float(px.min()), float(px.max())
        y0, y1 = float(py.min()), float(py.max())
        if (x1 - x0) < min_extent * W and (y1 - y0) < min_extent * H:
            out.append(np.zeros((0, 4), np.float32))
            continue
        head_seen = bool(scores[i][[0, 15, 16, 17, 18]].max() > conf)
        y0 -= (0.15 if head_seen else 0.35) * (y1 - y0)
        box = np.asarray([[max(x0, 0), max(y0, 0),
                           min(x1, W), min(y1, H)]], np.float32)
        out.append(box)
    return out


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return float(inter / max(ua, 1e-6))


def _track_per_frame(per_frame: list[np.ndarray],
                     min_hits: int) -> Optional[np.ndarray]:
    """MaxBoxTracker over per-frame candidate boxes -> (N, 4) or None."""
    n_hit = sum(1 for b in per_frame if len(b))
    if n_hit < min_hits:
        return None
    tracker = MaxBoxTracker()
    picked = [tracker(boxes) for boxes in per_frame]
    first = next((i for i, b in enumerate(picked) if b is not None), None)
    if first is None:
        return None
    for i in range(len(picked)):
        if picked[i] is None:
            picked[i] = picked[first if i < first else i - 1]
    return np.stack(picked).astype(np.float32)


def detect_person_boxes(
    frames: np.ndarray,
    seg_detector: Optional[SegmentationDetector] = None,
    max_frames: int = 48,
    pose2d=None,
    device="cuda",
) -> tuple[Optional[np.ndarray], str]:
    """Stage-1.1 person localization with explicit provenance.

    Candidate sources, each gated by its own sanity check:
      * median-background tracker (videos, static camera);
      * trained PersonSegUNet masks, accepted only when COMPACT
        (`mask_is_compact` rejects all-fired / scattered outputs — the
        failure mode of out-of-domain weights on photographs);
      * confident 2D-pose keypoint boxes (`pose_person_boxes`) — the
        perception module with demonstrated photo transfer;
      * iterated color-model (GrabCut-lite) — domain-independent, works on
        single stills; used as fallback and as the cross-check signal.

    Role of `base_preprocessor._execute_detector:167` + PointRend boxes
    (`point_render_parser.py:29-130`). The networks run on `device` unless
    the given detector and runner name their own.

    Returns:
        (boxes (N, 4) or None, method): method names the winning source,
        "none" when every source declined (caller uses the full frame).
    """
    # The crop consumes the UNION of per-frame boxes (`fmt_active_boxes`
    # over `update_active_boxes`), so detection on an even temporal
    # subsample is equivalent for long clips and bounds the per-frame host
    # work; per-frame boxes are nearest-filled back to full length.
    n_all = len(frames)
    if n_all > max_frames:
        ids = np.linspace(0, n_all - 1, max_frames).astype(np.int64)
        sub_boxes, method = detect_person_boxes(
            frames[ids], seg_detector=seg_detector, max_frames=n_all,
            pose2d=pose2d, device=device)
        if sub_boxes is None:
            return None, method
        nearest = np.abs(ids[None, :] - np.arange(n_all)[:, None]).argmin(1)
        return sub_boxes[nearest], method

    seg = seg_detector or SegmentationDetector(device=device)
    min_hits = max(1, len(frames) // 2)
    H, W = frames.shape[1], frames.shape[2]

    # pose seeds cost an OpenPose forward per frame — compute them only when
    # a consumer actually needs them (seg seeding, or the pose fallback)
    _pose_cache = {}

    def get_pose_seeds():
        if "v" not in _pose_cache:
            _pose_cache["v"] = pose_person_boxes(frames, pose2d=pose2d, device=device)
        return _pose_cache["v"]

    seg_boxes = None
    if seg.available:
        pose_seeds = get_pose_seeds()
        # person-likeness component scoring per frame, seeded by the pose
        # skeleton box when one exists (two independent trained signals),
        # then zoom refinement at the segmenter's training scale.
        probs = seg.run_probs(frames)
        min_area = max(int(seg.min_area_frac * seg.work * seg.work), 8)
        s = np.asarray([W / seg.work, H / seg.work] * 2, np.float32)
        coarse = np.zeros((len(frames), 4), np.float32)
        got = np.zeros((len(frames),), bool)
        for i in range(len(frames)):
            cb, cs = person_components(probs[i], min_area=min_area)
            if not len(cb):
                continue
            if len(pose_seeds[i]):
                # keep only components overlapping the pose box; the pose
                # net localizes the person, the segmenter bounds clothing
                seed = pose_seeds[i][0] / s
                inside = [k for k in range(len(cb))
                          if _iou(cb[k], seed) > 0.0
                          or (cb[k][0] < seed[2] and cb[k][2] > seed[0]
                              and cb[k][1] < seed[3] and cb[k][3] > seed[1])]
                if inside:
                    cb, cs = cb[inside], cs[inside]
            # confidence gate: a weak best component (score ~ mean-prob ×
            # fill × aspect × √area; a clear person at work=256 scores
            # 15-35, texture blobs 0-5) must not preempt the pose2d /
            # color-model fallbacks
            if cs[0] < 6.0:
                continue
            coarse[i] = _merge_aligned_components(cb, cs) * s
            got[i] = True
        if got.sum() >= min_hits:
            # nearest-fill the misses, then refine at zoom
            idx = np.where(got)[0]
            for i in np.where(~got)[0]:
                coarse[i] = coarse[idx[np.abs(idx - i).argmin()]]
            refined, ok = seg.zoom_refine(frames, coarse)
            boxes = np.where(ok[:, None], refined, coarse)
            # sanity: refined boxes must localize (not ~full frame) and be
            # PLAUSIBLY PERSON-SIZED — zoom refinement on a weak mask can
            # collapse to a sliver, which is worse than the pose2d/color
            # fallbacks it would preempt
            wfrac = (boxes[:, 2] - boxes[:, 0]) / W
            hfrac = (boxes[:, 3] - boxes[:, 1]) / H
            good = (wfrac < 0.95) | (hfrac < 0.95)
            good &= (wfrac > 0.02) & (hfrac > 0.08)
            if good.sum() >= min_hits:
                gidx = np.where(good)[0]
                nearest = gidx[np.abs(
                    gidx[None, :] - np.arange(len(boxes))[:, None]).argmin(1)]
                seg_boxes = boxes[nearest]

    if seg_boxes is not None:
        # the zoom-verified segmentation is primary; the median-background
        # cross-check only renamed the provenance label and cost a full
        # detector pass, so it is skipped here
        return seg_boxes, "person_seg"
    tracked = track_person_boxes(frames)
    if tracked is not None:
        return tracked, "median_bg"

    pose_boxes = _track_per_frame(get_pose_seeds(), min_hits)
    cm_boxes = _track_per_frame(still_person_boxes(frames), min_hits)
    if pose_boxes is not None and cm_boxes is not None:
        # the skeleton box localizes the person; the color model sees full
        # clothing extent but also background clutter. Keep color-model
        # bounds only where they agree with the (margin-expanded) pose box.
        u_p = np.asarray([pose_boxes[:, 0].min(), pose_boxes[:, 1].min(),
                          pose_boxes[:, 2].max(), pose_boxes[:, 3].max()])
        u_c = np.asarray([cm_boxes[:, 0].min(), cm_boxes[:, 1].min(),
                          cm_boxes[:, 2].max(), cm_boxes[:, 3].max()])
        w, h = u_p[2] - u_p[0], u_p[3] - u_p[1]
        grown = u_p + np.asarray([-0.25 * w, -0.15 * h, 0.25 * w, 0.1 * h])
        clipped = np.asarray([max(u_c[0], grown[0]), max(u_c[1], grown[1]),
                              min(u_c[2], grown[2]), min(u_c[3], grown[3])])
        merged = np.asarray([min(u_p[0], clipped[0]), min(u_p[1], clipped[1]),
                             max(u_p[2], clipped[2]), max(u_p[3], clipped[3])],
                            np.float32)
        return np.repeat(merged[None], len(frames), 0), "pose2d+color_model"
    if pose_boxes is not None:
        return pose_boxes, "pose2d"
    if cm_boxes is not None:
        return cm_boxes, "color_model"
    return None, "none"


def track_person_boxes(frames: np.ndarray,
                       detector: Optional[PersonDetector] = None,
                       min_valid_frac: float = 0.5) -> Optional[np.ndarray]:
    """Detect + track the person across frames — stage 1.1
    (`base_preprocessor._execute_detector:167` + MaxBoxTracker).

    Returns (N, 4) tracked per-frame boxes, or None when detection is too
    unreliable (few frames / moving camera) and the caller should fall back
    to the full frame.
    """
    n = len(frames)
    if n < 3:
        return None  # no temporal signal
    det = detector or PersonDetector()
    per_frame = det.run(frames)
    n_hit = sum(1 for b in per_frame if len(b))
    if n_hit < min_valid_frac * n:
        return None
    tracker = MaxBoxTracker()
    tracked = []
    for boxes in per_frame:
        box = tracker(boxes)
        tracked.append(box if box is not None else np.asarray([0, 0, frames.shape[2], frames.shape[1]], np.float32))
    # frames before the first detection inherit the first tracked box
    first = next((i for i, b in enumerate(per_frame) if len(b)), 0)
    for i in range(first):
        tracked[i] = tracked[first]
    arr = np.stack(tracked)
    # sanity: the union box should not be ~the whole frame AND not be tiny
    H, W = frames.shape[1], frames.shape[2]
    u = [arr[:, 0].min(), arr[:, 1].min(), arr[:, 2].max(), arr[:, 3].max()]
    area_frac = (u[2] - u[0]) * (u[3] - u[1]) / (H * W)
    if area_frac < 0.01:
        return None
    return arr
