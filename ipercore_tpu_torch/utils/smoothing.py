"""Temporal smoothing of SMPL sequences and of 2D keypoint tracks.

The port's own copy of `ipercore_tpu/utils/smoothing.py`: a zero-phase
low-pass (2nd-order Butterworth, forward and backward, through scipy) over the
camera track and over the rot6d pose representation; the 2D-pose filters of
preprocessing (invalid-joint interpolation, a temporal median, the left/right
swap repair) and the SMPLify outlier replacement. Host-side: each runs once
per sequence; the rotation conversions run in torch on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def _butter_lowpass_sos(fc: float, fs: float):
    """2nd-order Butterworth low-pass."""
    from scipy.signal import butter

    wn = min(max(fc / (fs / 2.0), 1e-4), 0.99)
    return butter(2, wn, btype="low", output="sos")


def lowpass_filtfilt(x: np.ndarray, fc: float, fs: float = 2208.0) -> np.ndarray:
    """Zero-phase low-pass along axis 0 (the reference's fs = 2208 with the
    pose_fc / cam_fc cutoffs). Sequences shorter than 7 frames are returned
    as they are. Where scipy cannot filter (it is missing, or the sequence is
    not longer than the filter's 9-frame padding) a forward-backward
    exponential average stands in, as in the JAX package."""
    n = x.shape[0]
    if n < 7:
        return x
    try:
        from scipy.signal import sosfiltfilt

        sos = _butter_lowpass_sos(fc, fs)
        return sosfiltfilt(sos, x, axis=0).astype(x.dtype)
    except Exception:  # the JAX package's fallback, for 7-9 frames too
        alpha = min(fc / fs * 2 * np.pi, 1.0)
        out = x.copy()
        for sweep in (range(1, n), range(n - 2, -1, -1)):
            for i in sweep:
                out[i] = alpha * out[i] + (1 - alpha) * out[i - 1 if i > 0 else 0]
        return out


def temporal_smooth_smpls(smpls: np.ndarray, pose_fc: float = 300.0,
                          cam_fc: float = 100.0) -> np.ndarray:
    """Smooth an (N, 85) SMPL sequence: the camera low-passed at cam_fc; the
    pose converted to rot6d, low-passed at pose_fc and converted back (Gram-
    Schmidt re-orthonormalises it); the betas averaged. Fewer than 7 frames
    are returned as they are."""
    from ipercore_tpu_torch.ops.rotations import axis_angle_to_rot6d, rot6d_to_axis_angle

    smpls = np.asarray(smpls, np.float32)
    n = smpls.shape[0]
    if n < 7:
        return smpls
    cam = lowpass_filtfilt(smpls[:, 0:3], cam_fc)
    r6 = axis_angle_to_rot6d(torch.from_numpy(smpls[:, 3:75].reshape(n, 24, 3).copy())).numpy()
    r6 = lowpass_filtfilt(r6.reshape(n, -1), pose_fc).reshape(n, 24, 6)
    pose = rot6d_to_axis_angle(torch.from_numpy(np.ascontiguousarray(r6))).numpy().reshape(n, 72)
    shape = np.broadcast_to(smpls[:, 75:].mean(axis=0, keepdims=True), (n, 10))
    return np.concatenate([cam, pose, shape], axis=1).astype(np.float32)


def interpolate_invalid_kps(kps: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Linearly interpolate invalid joints over time.

    Args:
        kps: (N, K, D); valid: (N, K) bool.
    """
    kps = np.array(kps, np.float32)
    N, K = valid.shape
    t = np.arange(N)
    for k in range(K):
        good = valid[:, k]
        if good.all() or not good.any():
            continue
        for d in range(kps.shape[2]):
            kps[~good, k, d] = np.interp(t[~good], t[good], kps[good, k, d])
    return kps


def median_filter_time(x: np.ndarray, window: int) -> np.ndarray:
    """Median filter along axis 0 (the reference's `mean_filter`, which
    despite its name is scipy's median filter)."""
    from scipy.ndimage import median_filter

    size = (window,) + (1,) * (x.ndim - 1)
    return median_filter(x, size=size, mode="nearest")


def pose2d_temporal_filter(keypoints: np.ndarray, window_size: int = 5, mode: str = "median",
                           fc: float = 300.0) -> np.ndarray:
    """Fix left/right joint swaps by nearest-neighbour re-permutation against
    a temporally filtered track: a 2D estimator often places joints right but
    flips their left/right identities for a few frames; each frame's joints
    snap to their nearest smoothed slot.

    Args:
        keypoints: (T, J, 2 or 3) with an optional per-joint score;
        mode: "median" or "low-pass".

    Returns:
        (T, J, C) re-permuted keypoints.
    """
    kps = np.asarray(keypoints, np.float32)
    T, J, C = kps.shape
    if mode == "median":
        filtered = median_filter_time(kps, window_size)
    elif mode == "low-pass":
        filtered = lowpass_filtfilt(kps.reshape(T, -1), fc=fc).reshape(T, J, C)
    else:
        raise ValueError(f"mode must be median|low-pass, got {mode}")
    # (T, J, J) distances of each frame's joints to the smoothed slots
    dist = np.sum((kps[:, :, None, 0:2] - filtered[:, None, :, 0:2]) ** 2, axis=-1)
    nn_ids = np.argmin(dist, axis=2)
    # the reference's semantics: output slot j takes the joint its nearest
    # smoothed slot picks
    return np.take_along_axis(kps, nn_ids[:, :, None], axis=1)


def pose_temporal_smooth(init_pose: np.ndarray, opt_pose: np.ndarray,
                         threshold: float = 10.0) -> np.ndarray:
    """Replace outlier optimised poses with their initialisations: frames
    where the rot6d L1 distance between the initial pose and the SMPLify
    result exceeds `threshold` are taken as diverged.

    Args:
        init_pose, opt_pose: (T, 72) axis-angle body poses.

    Returns:
        (T, 72) with diverged frames replaced.
    """
    from ipercore_tpu_torch.ops.rotations import axis_angle_to_rot6d

    init_pose = np.asarray(init_pose, np.float32)
    opt_pose = np.asarray(opt_pose, np.float32)
    T = opt_pose.shape[0]
    init6d = axis_angle_to_rot6d(torch.from_numpy(init_pose.reshape(-1, 3).copy())).numpy().reshape(T, -1)
    opt6d = axis_angle_to_rot6d(torch.from_numpy(opt_pose.reshape(-1, 3).copy())).numpy().reshape(T, -1)
    diff = np.abs(init6d - opt6d).sum(axis=1)
    out = opt_pose.copy()
    out[diff > threshold] = init_pose[diff > threshold]
    return out
