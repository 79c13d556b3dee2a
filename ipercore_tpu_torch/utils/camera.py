"""Weak-perspective camera strategies (twin of `ipercore_tpu/utils/camera.py`:
`cam_swap`, `get_checkpoints`, `get_jump_mask`, `stabilize_smpls`, which are
numpy in, numpy out and run once per sequence on the host; and the crop
camera conversions `cam_init2orig` / `cam_norm`, tensor in, tensor out)."""
from __future__ import annotations

import numpy as np
import torch


def cam_swap(src_cam, ref_cam, first_cam=None, strategy: str = "smooth") -> np.ndarray:
    """Swap source/reference cameras.

    Args:
        src_cam/ref_cam: (N, 3) = (s, tx, ty); first_cam: (1 or N, 3) for the
        "smooth" strategy (first reference frame's camera).
        strategy: smooth | ref_txty | source | copy.
    """
    src_cam = np.asarray(src_cam, np.float32)
    ref_cam = np.asarray(ref_cam, np.float32)
    if strategy == "smooth":
        first_cam = np.asarray(first_cam, np.float32)
        delta_xy = ref_cam[:, 1:] - first_cam[:, 1:]
        s = src_cam[:, 0:1] * ref_cam[:, 0:1] / first_cam[:, 0:1]
        return np.concatenate([s, src_cam[:, 1:] + delta_xy], axis=1)
    if strategy == "ref_txty":
        return np.concatenate([src_cam[:, 0:1], ref_cam[:, 1:]], axis=1)
    if strategy == "source":
        return src_cam
    return ref_cam  # "copy"


def get_checkpoints(y: np.ndarray) -> list[int]:
    """Local-extremum indices of a track; zero-derivative runs are
    forward-filled so an extremum flanked by equal samples is still found."""
    sign = np.sign(np.diff(y))
    last = 0.0
    filled = np.zeros_like(sign)
    for i, s in enumerate(sign):
        if s != 0:
            last = s
        filled[i] = last
    ckpts = [0]
    for i in range(1, len(filled)):
        if filled[i - 1] * filled[i] < 0:
            ckpts.append(i)
    ckpts.append(len(y) - 1)
    return ckpts


def get_jump_mask(final_foot_y: np.ndarray, up_th: float = 0.2, down_th: float = 0.1):
    """Detect jump intervals from the foot-y track: (list of (start, end), mask)."""
    n = final_foot_y.shape[0]
    jump_info = []
    ground_y = final_foot_y[0]
    ckpts = get_checkpoints(final_foot_y)
    jumping = False
    start = None
    for idx in range(1, len(ckpts)):
        i, i_1 = ckpts[idx], ckpts[idx - 1]
        y_i, y_i_1 = final_foot_y[i], final_foot_y[i_1]
        if y_i - y_i_1 < 0 and abs(y_i - y_i_1) > up_th:
            jumping = True
            start = None
            for f in range(i_1, i):
                if final_foot_y[f] < ground_y:
                    start = f
                    break
            if start is None:
                start = i_1
        elif jumping:
            if y_i < final_foot_y[start] and abs(y_i - final_foot_y[start]) > down_th:
                continue
            jumping = False
            jump_info.append((start, i))
            start = None
    if jumping:
        jump_info.append((start, n - 1))
    mask = np.zeros((n,))
    for s, e in jump_info:
        mask[s:e + 1] = 1
    return jump_info, mask


def stabilize_smpls(smpls: np.ndarray, foot_y: np.ndarray) -> np.ndarray:
    """Stabilize a target SMPL sequence by foot contact: the camera is reset
    to (s = 1, tx = 0), ty is pinned so the lowest body point stays on the
    first frame's ground line, jump intervals keep the original (clamped) ty,
    and the shape is locked to the first frame's betas.

    Args:
        smpls: (N, 85); foot_y: (N,) per-frame max body-vertex y
            (`models.imitator.infer_foot_y`).
    """
    smpls = np.array(smpls, np.float32)
    foot_y = np.asarray(foot_y, np.float32)
    cam_y = smpls[:, 2].copy()
    ground_y = cam_y[0]

    jump_info, _ = get_jump_mask(foot_y + cam_y)

    new_cam_y = ground_y + (foot_y[0] - foot_y)
    for s, e in jump_info:
        new_cam_y[s:e + 1] = np.minimum(cam_y[s:e + 1], new_cam_y[s:e + 1])

    smpls[:, 0] = 1.0
    smpls[:, 1] = 0.0
    smpls[:, 2] = new_cam_y
    smpls[:, 75:] = smpls[0:1, 75:]
    return smpls


def cam_init2orig(cam, scale, start_pt, N: int = 224) -> torch.Tensor:
    """HMR crop camera -> original-image camera (`cam_init2orig:216`).

    Args: cam (bs, 3); scale (bs, 1) resize_h / orig_h; start_pt (bs, 2).
    Tensors or arrays; the result is a tensor on `cam`'s device."""
    cam = torch.as_tensor(cam)
    scale = torch.as_tensor(scale, device=cam.device)
    start_pt = torch.as_tensor(start_pt, device=cam.device)
    cam_crop = torch.cat([N * cam[:, 0:1] * 0.5, cam[:, 1:] + (2.0 / cam[:, 0:1]) * 0.5], dim=1)
    return torch.cat([cam_crop[:, 0:1] / scale,
                      cam_crop[:, 1:] + (start_pt - N) / cam_crop[:, 0:1]], dim=1)


def cam_norm(cam, N) -> torch.Tensor:
    """Original-image camera -> normalized [-1, 1] camera (`cam_norm:244`)."""
    cam = torch.as_tensor(cam)
    return torch.cat([cam[:, 0:1] * (2.0 / N), cam[:, 1:] - N / (2 * cam[:, 0:1])], dim=1)
