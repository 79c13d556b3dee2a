"""Multi-person OpenPose decoding: heatmap NMS + greedy PAF grouping.

The port's copy of `ipercore_tpu/tools/pose2d_decode.py`, host numpy as
there (the reference's `openpose/post_process.py` extract_keypoints:94,
group_keypoints:127, and the Body-25 limb topology of `utils/pose_utils.py`).
The argmax decode is the fast path for the tracked single person
(`pose2d.decode_single_person`); this module is the correct path when several
people are in frame.

Peaks come from a vectorised 4-neighbour local-max test + greedy radius
suppression; limb scores integrate the part affinity field along the
candidate segment; people are assembled by greedy best-connection-first union
of limb matches. Coordinates are pixel (x, y) in heatmap space throughout;
callers rescale.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# Body-25 limb (joint_a, joint_b) pairs and their (x, y) PAF channel ids —
# the standard OpenPose BODY_25 wiring (constants; `pose_utils.py:201-216`).
BODY25_LIMBS = [
    (1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6),
    (6, 7), (8, 9), (9, 10), (10, 11), (8, 12), (12, 13),
    (13, 14), (1, 0), (0, 15), (15, 17), (0, 16), (16, 18),
    (2, 17), (5, 18), (14, 19), (19, 20), (14, 21), (11, 22),
    (22, 23), (11, 24),
]
BODY25_PAF_IDS = [
    (0, 1), (14, 15), (22, 23), (16, 17), (18, 19), (24, 25),
    (26, 27), (6, 7), (2, 3), (4, 5), (8, 9), (10, 11),
    (12, 13), (30, 31), (32, 33), (36, 37), (34, 35), (38, 39),
    (20, 21), (28, 29), (40, 41), (42, 43), (44, 45), (46, 47),
    (48, 49), (50, 51),
]
N_JOINTS = 25

# COCO-18 wiring (the Mobilenet variant's head, Osokin's
# lightweight-human-pose-estimation tables; `mobilenet.py` consumers):
# joints: 0 nose, 1 neck, 2-4 R arm, 5-7 L arm, 8-10 R leg, 11-13 L leg,
# 14/15 R/L eye, 16/17 R/L ear. 19 limbs over 38 PAF channels.
COCO18_LIMBS = [
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
    (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
    (0, 15), (15, 17), (2, 16), (5, 17),
]
COCO18_PAF_IDS = [
    (12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1),
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31),
    (34, 35), (32, 33), (36, 37), (18, 19), (26, 27),
]
N_COCO18_JOINTS = 18


def extract_peaks(hm: np.ndarray, threshold: float = 0.1,
                  min_dist: float = 6.0, max_peaks: int = 16) -> np.ndarray:
    """Local maxima of one joint heatmap with radius suppression.

    Args:
        hm: (h, w) float heatmap.

    Returns:
        (K, 3) array of (x, y, score), score-sorted descending.
    """
    h, w = hm.shape
    m = np.pad(hm, 1, constant_values=-np.inf)
    c = m[1:-1, 1:-1]
    is_peak = (
        (c > m[1:-1, 2:]) & (c >= m[1:-1, :-2])
        & (c > m[2:, 1:-1]) & (c >= m[:-2, 1:-1])
        & (c > threshold)
    )
    ys, xs = np.nonzero(is_peak)
    if len(ys) == 0:
        return np.zeros((0, 3), np.float32)
    scores = hm[ys, xs]
    order = np.argsort(-scores)
    kept: list[int] = []
    for i in order:
        ok = True
        for j in kept:
            if (xs[i] - xs[j]) ** 2 + (ys[i] - ys[j]) ** 2 < min_dist ** 2:
                ok = False
                break
        if ok:
            kept.append(i)
            if len(kept) >= max_peaks:
                break
    return np.stack(
        [xs[kept].astype(np.float32), ys[kept].astype(np.float32), scores[kept]],
        axis=1)


def paf_limb_score(paf_x: np.ndarray, paf_y: np.ndarray,
                   pa: np.ndarray, pb: np.ndarray,
                   n_samples: int = 10, min_paf_score: float = 0.05,
                   min_success: float = 0.8) -> float:
    """Integrate the PAF along segment a->b; -1 if the limb is unsupported.

    Mirrors `group_keypoints`'s line integral (`post_process.py:180-225`):
    at least `min_success` of the samples must align with the field.
    """
    vec = pb - pa
    norm = float(np.linalg.norm(vec))
    if norm < 1e-6:
        return -1.0
    u = vec / norm
    ts = np.linspace(0.0, 1.0, n_samples)
    xs = np.clip(np.round(pa[0] + ts * vec[0]).astype(np.int64), 0, paf_x.shape[1] - 1)
    ys = np.clip(np.round(pa[1] + ts * vec[1]).astype(np.int64), 0, paf_x.shape[0] - 1)
    dots = u[0] * paf_x[ys, xs] + u[1] * paf_y[ys, xs]
    passed = dots > min_paf_score
    if passed.mean() < min_success or not passed.any():
        return -1.0
    score = float(dots[passed].mean())
    # long-limb penalty (ref: `min(height_n / vec_norm - 1, 0)`)
    score += min(paf_x.shape[0] / 2.0 / norm - 1.0, 0.0)
    return score if score > 0 else -1.0


def group_people(peaks_by_joint: list[np.ndarray], pafs: np.ndarray,
                 limbs=BODY25_LIMBS, paf_ids=BODY25_PAF_IDS,
                 n_joints: int = N_JOINTS) -> list[dict]:
    """Assemble per-person skeletons by greedy PAF matching.

    Args:
        peaks_by_joint: per joint, (K_j, 3) (x, y, score) peak arrays.
        pafs: (h, w, 2 * n_limbs-ish) part affinity fields.

    Returns:
        list of persons: {"kps": (J, 2) f32 (NaN = missing), "scores": (J,),
        "n": joints found, "score": total}.
    """
    # person entries: joint -> (peak row index into peaks_by_joint[j])
    entries: list[dict] = []

    for limb_id, ((ja, jb), (cx, cy)) in enumerate(zip(limbs, paf_ids)):
        pa = peaks_by_joint[ja]
        pb = peaks_by_joint[jb]
        if len(pa) == 0 or len(pb) == 0:
            continue
        paf_x, paf_y = pafs[..., cx], pafs[..., cy]
        cands = []
        for i in range(len(pa)):
            for j in range(len(pb)):
                s = paf_limb_score(paf_x, paf_y, pa[i, :2], pb[j, :2])
                if s > 0:
                    cands.append((s, i, j))
        cands.sort(reverse=True)
        used_a: set[int] = set()
        used_b: set[int] = set()
        for s, i, j in cands:
            if i in used_a or j in used_b:
                continue
            used_a.add(i)
            used_b.add(j)
            # attach to an existing person or start a new one
            host = None
            for e in entries:
                if e["joints"].get(ja) == i or e["joints"].get(jb) == j:
                    host = e
                    break
            if host is None:
                host = {"joints": {}, "score": 0.0}
                entries.append(host)
            if ja not in host["joints"]:
                host["joints"][ja] = i
                host["score"] += float(pa[i, 2])
            if jb not in host["joints"]:
                host["joints"][jb] = j
                host["score"] += float(pb[j, 2])
            host["score"] += s

    people = []
    for e in entries:
        if len(e["joints"]) < 3:  # too few joints to be a person
            continue
        kps = np.full((n_joints, 2), np.nan, np.float32)
        scores = np.zeros((n_joints,), np.float32)
        for j, pid in e["joints"].items():
            kps[j] = peaks_by_joint[j][pid, :2]
            scores[j] = peaks_by_joint[j][pid, 2]
        people.append({"kps": kps, "scores": scores,
                       "n": len(e["joints"]), "score": e["score"]})
    people.sort(key=lambda p: -p["score"])
    return people


def decode_multi_person(heatmaps: np.ndarray, pafs: np.ndarray,
                        threshold: float = 0.1, limbs=BODY25_LIMBS,
                        paf_ids=BODY25_PAF_IDS,
                        n_joints: int = N_JOINTS) -> list[dict]:
    """Full decode of one image: NMS per joint + PAF grouping.

    Args:
        heatmaps: (h, w, J+1) (last channel background); pafs: (h, w, 2L).
        limbs/paf_ids/n_joints: topology tables — Body-25 by default,
        pass the COCO18_* tables for the Mobilenet head.
    """
    peaks = [extract_peaks(heatmaps[..., j], threshold) for j in range(n_joints)]
    return group_people(peaks, pafs, limbs=limbs, paf_ids=paf_ids,
                        n_joints=n_joints)


def pick_largest_person(people: list[dict]) -> Optional[dict]:
    """The tracked-person heuristic — `MaxBoxTracker` semantics on kps bboxes."""
    best, best_area = None, -1.0
    for p in people:
        kps = p["kps"]
        v = ~np.isnan(kps[:, 0])
        if v.sum() < 3:
            continue
        area = float((kps[v, 0].max() - kps[v, 0].min())
                     * (kps[v, 1].max() - kps[v, 1].min()))
        if area > best_area:
            best, best_area = p, area
    return best


class OneEuroFilter:
    """Adaptive-cutoff temporal filter over keypoint arrays —
    `utils/one_euro_filter.py:26-47`, vectorized over all coordinates.
    Call per frame with (J, 2) (or any-shape) arrays; NaNs pass through
    without polluting the filter state."""

    def __init__(self, freq: float = 15.0, mincutoff: float = 1.0,
                 beta: float = 0.05, dcutoff: float = 1.0):
        self.freq = freq
        self.mincutoff = mincutoff
        self.beta = beta
        self.dcutoff = dcutoff
        self._x_prev: Optional[np.ndarray] = None
        self._x_hat: Optional[np.ndarray] = None
        self._dx_hat: Optional[np.ndarray] = None

    @staticmethod
    def _alpha(rate: float, cutoff) -> np.ndarray:
        tau = 1.0 / (2.0 * np.pi * cutoff)
        te = 1.0 / rate
        return 1.0 / (1.0 + tau / te)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if self._x_prev is None:
            self._x_prev = x.copy()
            self._x_hat = x.copy()
            self._dx_hat = np.zeros_like(x)
            return x.astype(np.float32)
        ok = np.isfinite(x) & np.isfinite(self._x_prev)
        dx = np.where(ok, (x - self._x_prev) * self.freq, 0.0)
        a_d = self._alpha(self.freq, self.dcutoff)
        self._dx_hat = np.where(ok, a_d * dx + (1 - a_d) * self._dx_hat, self._dx_hat)
        cutoff = self.mincutoff + self.beta * np.abs(self._dx_hat)
        a = self._alpha(self.freq, cutoff)
        x_new = np.where(ok, a * x + (1 - a) * self._x_hat, x)
        self._x_hat = np.where(ok, x_new, self._x_hat)
        self._x_prev = np.where(np.isfinite(x), x, self._x_prev)
        return x_new.astype(np.float32)
