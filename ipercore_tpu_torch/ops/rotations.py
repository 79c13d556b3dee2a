"""Rotation representation conversions: axis-angle, rotation matrix, rot6d,
quaternion (twin of `ipercore_tpu/ops/rotations.py`). All functions work on
the trailing axes and broadcast over the leading ones."""
from __future__ import annotations

import torch


def rodrigues(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) to rotation matrices (..., 3, 3).

    Same formula as the JAX twin: the norm is `sqrt(|x|^2 + 1e-16)` and angles
    below 1e-6 fall back to the first-order `I + hat(aa)`.
    """
    aa = axis_angle
    sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    angle = torch.sqrt(sq + 1e-16)  # (..., 1)
    axis = aa / angle
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )
    a = angle[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    R = eye + torch.sin(a) * K + (1.0 - torch.cos(a)) * (K @ K)
    R_small = eye + K * a
    return torch.where(a < 1e-6, R_small, R)


def rotmat_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): columns 0 and 1 of R, concatenated."""
    return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt; norms are floored at 1e-8."""
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=1e-8)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp(min=1e-8)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3), with the JAX twin's three branches: the generic
    angle from the antisymmetric part, the axis from the diagonal within 1e-3
    of pi, and r / 2 below an angle of 1e-6."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_a = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    angle = torch.arccos(cos_a)
    angle_safe = torch.arccos(torch.clamp(cos_a, -1.0 + 1e-7, 1.0 - 1e-7))
    r = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)  # 2 sin(angle) * axis
    axis_generic = r / torch.clamp(2.0 * torch.sin(angle_safe)[..., None], min=1e-8)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    val = torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0)
    tiny = val < 1e-12
    axis_pi = torch.where(tiny, torch.zeros_like(val), torch.sqrt(torch.where(tiny, torch.ones_like(val), val)))
    axis_pi = axis_pi * torch.where(r >= 0, 1.0, -1.0)
    near_pi = (torch.pi - angle) < 1e-3
    axis = torch.where(near_pi[..., None], axis_pi, axis_generic)
    return torch.where((angle < 1e-6)[..., None], r * 0.5, axis * angle_safe[..., None])


def axis_angle_to_rot6d(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 6) rot6d."""
    return rotmat_to_rot6d(rodrigues(aa))


def rot6d_to_axis_angle(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) rot6d -> (..., 3) axis-angle."""
    return rotmat_to_axis_angle(rot6d_to_rotmat(x))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (w, x, y, z) (..., 4), normalised first -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-8)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)
