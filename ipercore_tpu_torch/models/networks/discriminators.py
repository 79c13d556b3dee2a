"""Discriminator zoo: PatchGAN heads with global / body / head / background
crops.

Twin of `ipercore_tpu/models/networks/discriminators.py`. Inputs and outputs
are NHWC as in the JAX package; a PatchGAN permutes to NCHW once and runs its
convolutions there (at 512^2 its first maps are the largest tensors of the
train step's discriminator passes). Submodules carry the Flax names
(`global_model`, `body_model`, `Conv_0`, `scale_models_1`, ...), so a flat Flax
checkpoint carries over by name (`utils/checkpoint.flax_params_to_torch`).
Crops are bilinear grid samples of normalized boxes, differentiable in the
image.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.ops.sampling import grid_sample


def _cfg(cfg, key, default):
    if isinstance(cfg, Mapping):
        return cfg.get(key, default)
    return getattr(cfg, key, default)


def crop_by_bbox(imgs: torch.Tensor, bboxes: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Crop and resize by normalized boxes through a grid sample.

    Args:
        imgs: (N, H, W, C).
        bboxes: (N, 4) = (x0, y0, x1, y1) in [-1, 1] NDC.
        out_hw: output (h, w).

    Returns:
        (N, h, w, C)
    """
    h, w = out_hw
    ys = (torch.arange(h, dtype=imgs.dtype, device=imgs.device) + 0.5) / h
    xs = (torch.arange(w, dtype=imgs.dtype, device=imgs.device) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    x0, y0, x1, y1 = (bboxes[:, i, None, None] for i in range(4))
    grid = torch.stack([x0 + (x1 - x0) * gx[None], y0 + (y1 - y0) * gy[None]], dim=-1)
    return grid_sample(imgs, grid)


def _instance_norm_nchw(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class PatchDiscriminator(nn.Module):
    """70x70-style PatchGAN: 4x4 stride-2 convolutions, LeakyReLU(0.2),
    instance norm from the second layer on, a 1-channel head. The middle
    convolutions keep their bias (the instance norm after them cancels it, but
    the parameter is part of the checkpoints). Input (N, H, W, C) with C = 6
    (image + condition); output (N, h, w, 1)."""

    def __init__(self, cin: int = 6, ndf: int = 64, n_layers: int = 4, max_nf_mult: int = 8,
                 use_sigmoid: bool = False):
        super().__init__()
        self.n_layers, self.use_sigmoid = n_layers, use_sigmoid
        widths = [ndf] + [ndf * min(2 ** n, max_nf_mult) for n in range(1, n_layers + 1)] + [1]
        strides = [2] * n_layers + [1, 1]
        for i, (cout, s) in enumerate(zip(widths, strides)):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, cout, 4, stride=s, padding=1))
            cin = cout

    def forward(self, x):
        x = F.leaky_relu(self.Conv_0(x.permute(0, 3, 1, 2)), 0.2)
        for i in range(1, self.n_layers + 1):
            x = F.leaky_relu(_instance_norm_nchw(getattr(self, f"Conv_{i}")(x)), 0.2)
        x = getattr(self, f"Conv_{self.n_layers + 1}")(x)
        if self.use_sigmoid:
            x = torch.sigmoid(x)
        return x.permute(0, 2, 3, 1)


def _patch(cfg, bg: bool = False) -> PatchDiscriminator:
    """A PatchGAN of the config; its input width is `cond_nc` (image +
    condition, 6), or `bg_cond_nc` (background + mask, 4) for an aug-bg head."""
    return PatchDiscriminator(
        cin=_cfg(cfg, "bg_cond_nc", 4) if bg else _cfg(cfg, "cond_nc", 6), ndf=_cfg(cfg, "ndf", 64), n_layers=_cfg(cfg, "n_layers", 4),
        max_nf_mult=_cfg(cfg, "max_nf_mult", 8), use_sigmoid=_cfg(cfg, "use_sigmoid", False))


class GlobalDiscriminator(nn.Module):
    """Whole-image head (+ optional aug-bg head)."""

    def __init__(self, cfg, use_aug_bg: bool = False):
        super().__init__()
        self.use_aug_bg = use_aug_bg
        self.global_model = _patch(cfg)
        if use_aug_bg:
            self.bg_model = _patch(cfg, bg=True)

    def forward(self, x, bg_x=None, body_bbox=None, head_bbox=None):
        outs = [self.global_model(x)]
        if self.use_aug_bg and bg_x is not None:
            outs.append(self.bg_model(bg_x))
        return outs


class GlobalLocalDiscriminator(nn.Module):
    """Global + body-crop heads (+ optional aug-bg head)."""

    def __init__(self, cfg, use_aug_bg: bool = False):
        super().__init__()
        self.use_aug_bg = use_aug_bg
        self.global_model = _patch(cfg)
        self.local_model = _patch(cfg)
        if use_aug_bg:
            self.bg_model = _patch(cfg, bg=True)

    def forward(self, x, bg_x=None, body_bbox=None, head_bbox=None):
        outs = [self.global_model(x)]
        if body_bbox is not None:
            outs.append(self.local_model(crop_by_bbox(x, body_bbox, (x.shape[1] // 2, x.shape[2] // 2))))
        if self.use_aug_bg and bg_x is not None:
            outs.append(self.bg_model(bg_x))
        return outs


class GlobalBodyHeadDiscriminator(nn.Module):
    """The training default `patch_global_body_head`: global + body-crop +
    head-crop (+ optional aug-bg) heads."""

    def __init__(self, cfg, use_aug_bg: bool = False):
        super().__init__()
        self.use_aug_bg = use_aug_bg
        self.global_model = _patch(cfg)
        self.body_model = _patch(cfg)
        self.head_model = _patch(cfg)
        if use_aug_bg:
            self.bg_model = _patch(cfg, bg=True)

    def forward(self, x, bg_x=None, body_bbox=None, head_bbox=None):
        outs = [self.global_model(x)]
        if body_bbox is not None:
            outs.append(self.body_model(crop_by_bbox(x, body_bbox, (x.shape[1] // 2, x.shape[2] // 2))))
        if head_bbox is not None:
            outs.append(self.head_model(crop_by_bbox(x, head_bbox, (x.shape[1] // 4, x.shape[2] // 4))))
        if self.use_aug_bg and bg_x is not None:
            outs.append(self.bg_model(bg_x))
        return outs


class MultiScaleDiscriminator(nn.Module):
    """An image pyramid of PatchGANs (2x2 average pooling between scales)."""

    def __init__(self, cfg, n_scales: int = 2):
        super().__init__()
        self.n_scales = n_scales
        for i in range(n_scales):
            self.add_module(f"scale_models_{i}", _patch(cfg))

    def forward(self, x, bg_x=None, body_bbox=None, head_bbox=None):
        outs = []
        for i in range(self.n_scales):
            outs.append(getattr(self, f"scale_models_{i}")(x))
            if i != self.n_scales - 1:
                x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return outs


DISCRIMINATOR_REGISTRY = {
    "patch": GlobalDiscriminator,
    "patch_global": GlobalDiscriminator,
    "patch_global_local": GlobalLocalDiscriminator,
    "patch_global_body_head": GlobalBodyHeadDiscriminator,
    "multi_scale": MultiScaleDiscriminator,
}


def build_discriminator(name: str, cfg, use_aug_bg: bool = False,
                        device: torch.device | str = "cuda") -> nn.Module:
    """A discriminator by registry name, on `device`."""
    if name not in DISCRIMINATOR_REGISTRY:
        raise KeyError(f"unknown discriminator {name!r}; have {sorted(DISCRIMINATOR_REGISTRY)}")
    cls = DISCRIMINATOR_REGISTRY[name]
    net = cls(cfg) if cls is MultiScaleDiscriminator else cls(cfg, use_aug_bg=use_aug_bg)
    return net.to(device)
