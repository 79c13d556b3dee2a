"""Temporal smoothing of SMPL sequences (pose in rot6d + camera).

The port's own copy of the part of `ipercore_tpu/utils/smoothing.py` that the
services use: a zero-phase low-pass (2nd-order Butterworth, forward and
backward, through scipy) over the camera track and over the rot6d pose
representation. Host-side: it runs once per sequence before synthesis; the
rotation conversions run in torch on the CPU.
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
