"""Binary / grayscale morphology and edge ops on NHWC masks (twin of
`ipercore_tpu/ops/morphology.py`: `dilate`, `erode`, `morph`, `soft_edge`,
`gaussian_blur`, `sobel_edges`).

A ks x ks window reduction with ks // 2 padding on each side, as the JAX
`reduce_window` call pads it; `max_pool2d` pads with -inf, the identity of max.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate(mask: torch.Tensor, ks: int) -> torch.Tensor:
    """Dilation with a ks x ks square element. mask: (N, H, W, C)."""
    if ks <= 1:
        return mask
    out = F.max_pool2d(mask.permute(0, 3, 1, 2), kernel_size=ks, stride=1, padding=ks // 2)
    return out.permute(0, 2, 3, 1)


def erode(mask: torch.Tensor, ks: int) -> torch.Tensor:
    """Erosion with a ks x ks square element. mask: (N, H, W, C)."""
    return -dilate(-mask, ks)


def morph(mask: torch.Tensor, ks: int, mode: str) -> torch.Tensor:
    """mode in {"erode", "dilate"}."""
    if mode == "erode":
        return erode(mask, ks)
    if mode == "dilate":
        return dilate(mask, ks)
    raise ValueError(f"unknown morph mode: {mode}")


def soft_edge(mask: torch.Tensor, ks: int = 3) -> torch.Tensor:
    """Boundary band of a binary mask: dilate(mask) - erode(mask), in [0, 1]."""
    return torch.clamp(dilate(mask, ks) - erode(mask, ks), 0.0, 1.0)


def gaussian_blur(img: torch.Tensor, sigma: float = 1.0, ks: int = 5) -> torch.Tensor:
    """Separable Gaussian blur of NHWC images. Each pass is a weighted sum of
    rolled copies, as the JAX package shifts with `jnp.roll`: the border
    wraps around (no zero padding)."""
    radius = ks // 2
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    k = (k / k.sum()).tolist()

    def conv_axis(x, axis):
        out = torch.zeros_like(x)
        for i, w in enumerate(k):
            out = out + w * torch.roll(x, i - radius, dims=axis)
        return out

    return conv_axis(conv_axis(img, 1), 2)


def sobel_edges(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel gradients (gx, gy) of an NHWC image: a depthwise
    cross-correlation with zero padding ("SAME")."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=img.dtype, device=img.device)
    c = img.shape[-1]
    x = img.permute(0, 3, 1, 2)

    def depthwise(k):
        return F.conv2d(x, k.expand(c, 1, 3, 3), padding=1, groups=c).permute(0, 2, 3, 1)

    return depthwise(kx), depthwise(kx.T)
