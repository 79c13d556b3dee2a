"""The personalization trainer's other networks and losses in plain PyTorch:
the `patch_global` PatchGAN discriminator, the VGG19 perceptual loss and the
Sphere20a face-identity loss on head crops, LSGAN, mask BCE, total variation
and L1, as iPERCore v0.2.0's `Train` and `Discriminator` sections configure
them. Module and parameter names are those of the port's state dicts.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.generator import grid_sample

PYRAMID_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)
VGG19 = ((64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512), (512, 512, 512, 512))


class PatchGAN(nn.Module):
    """4x4 convolutions, stride 2 for `n_layers`, LeakyReLU(0.2), instance norm
    from the second layer on, a 1-channel head; (N, H, W, C) -> (N, h, w, 1)."""

    def __init__(self, cin=6, ndf=64, n_layers=4, max_nf_mult=8):
        super().__init__()
        self.n_layers = n_layers
        widths = [ndf] + [ndf * min(2 ** n, max_nf_mult) for n in range(1, n_layers + 1)] + [1]
        for i, (c, s) in enumerate(zip(widths, [2] * n_layers + [1, 1])):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, c, 4, stride=s, padding=1))
            cin = c

    def forward(self, x):
        x = F.leaky_relu(self.Conv_0(x.permute(0, 3, 1, 2)), 0.2)
        for i in range(1, self.n_layers + 1):
            y = getattr(self, f"Conv_{i}")(x)
            mean = y.mean(dim=(2, 3), keepdim=True)
            var = y.var(dim=(2, 3), keepdim=True, unbiased=False)
            x = F.leaky_relu((y - mean) * torch.rsqrt(var + 1e-5), 0.2)
        return getattr(self, f"Conv_{self.n_layers + 1}")(x).permute(0, 2, 3, 1)


class GlobalD(nn.Module):
    """`patch_global`: one PatchGAN over the whole image and its condition."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.global_model = PatchGAN(6, cfg["ndf"], cfg["n_layers"], cfg["max_nf_mult"])

    def forward(self, x):
        return [self.global_model(x)]


class VGG(nn.Module):
    """VGG19's five slices of 3x3 convolutions and ReLUs, 2x2 max pooling
    between them, on ImageNet-normalised inputs."""

    def __init__(self, slices=VGG19):
        super().__init__()
        self.slices = slices
        self.register_buffer("mean", torch.tensor((0.485, 0.456, 0.406)), persistent=False)
        self.register_buffer("std", torch.tensor((0.229, 0.224, 0.225)), persistent=False)
        cin = 3
        for si, widths in enumerate(slices):
            for wi, w in enumerate(widths):
                self.add_module(f"conv{si}_{wi}", nn.Conv2d(cin, w, 3, padding=1))
                cin = w

    def forward(self, x):
        x = (((x + 1.0) * 0.5 - self.mean) / self.std).permute(0, 3, 1, 2)
        feats = []
        for si, widths in enumerate(self.slices):
            for wi in range(len(widths)):
                x = F.relu(getattr(self, f"conv{si}_{wi}")(x))
            feats.append(x)
            if si != len(self.slices) - 1:
                x = F.max_pool2d(x, 2)
        return feats


class PReLU(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.full((c,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight * x)


class Sphere20a(nn.Module):
    """SphereFace-20a on (N, 112, 96, 3): four stages of a stride-2 3x3
    convolution and residual pairs, PReLU after every convolution, fc5 on the
    (512, 7, 6) map flattened channel-major; returns the four stage maps and fc5."""

    STAGES = ((1, 64, 1), (2, 128, 2), (3, 256, 4), (4, 512, 1))

    def __init__(self):
        super().__init__()
        cin = 3
        for s, w, pairs in self.STAGES:
            for i in range(1, 2 * pairs + 2):
                self.add_module(f"conv{s}_{i}", nn.Conv2d(cin if i == 1 else w, w, 3,
                                                          stride=2 if i == 1 else 1, padding=1))
                self.add_module(f"relu{s}_{i}", PReLU(w))
            cin = w
        self.fc5 = nn.Linear(512 * 7 * 6, 512)

    def _unit(self, x, s, i):
        y = getattr(self, f"conv{s}_{i}")(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return getattr(self, f"relu{s}_{i}")(y)

    def forward(self, x):
        feats = []
        for s, _, pairs in self.STAGES:
            x = self._unit(x, s, 1)
            for i in range(2, 2 * pairs + 2, 2):
                x = x + self._unit(self._unit(x, s, i), s, i + 1)
            feats.append(x)
        feats.append(self.fc5(x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)))
        return feats


def crop(imgs: torch.Tensor, boxes: torch.Tensor, hw: tuple) -> torch.Tensor:
    """Bilinear crops of boxes (N, 4) = (x0, y0, x1, y1) in [-1, 1] to (N, h, w, C)."""
    h, w = hw
    ys = (torch.arange(h, dtype=imgs.dtype, device=imgs.device) + 0.5) / h
    xs = (torch.arange(w, dtype=imgs.dtype, device=imgs.device) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    x0, y0, x1, y1 = (boxes[:, i, None, None] for i in range(4))
    return grid_sample(imgs, torch.stack([x0 + (x1 - x0) * gx[None], y0 + (y1 - y0) * gy[None]], dim=-1))


def pyramid_l1(fp, ft):
    loss = 0.0
    for w, a, b in zip(PYRAMID_WEIGHTS, fp, ft):
        loss = loss + w * torch.mean(torch.abs(a - b))
    return loss


def perceptual(vgg, pred, target):
    with torch.no_grad():
        ft = vgg(target)
    return pyramid_l1(vgg(pred), ft)


def face(net, pred, target, boxes, hw=(112, 96)):
    with torch.no_grad():
        ft = net(crop(target, boxes, hw))
    return pyramid_l1(net(crop(pred, boxes, hw)), ft)


def lsgan(outs, target: float):
    return sum(torch.mean((o - target) ** 2) for o in outs) / len(outs)


def tv(mask):
    return torch.mean(torch.abs(mask[:, 1:] - mask[:, :-1])) + torch.mean(torch.abs(mask[:, :, 1:] - mask[:, :, :-1]))


def mask_bce(pred, target, eps=1e-6):
    """BCE with the prediction clipped as min(max(p, eps), 1 - eps)."""
    p = torch.minimum(torch.maximum(pred, pred.new_full((), eps)), pred.new_full((), 1.0 - eps))
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def l1(a, b):
    return torch.mean(torch.abs(a - b))
