"""Training criterions: VGG perceptual loss, face identity loss (Sphere20a or
SENet-50 features), LSGAN, total variation, temporal smoothness, mask BCE, L1.

Twin of `ipercore_tpu/models/networks/criterions.py`, with `LPIPSLin` (the
published perceptual metric, used by `services/evaluate`). The feature networks have the JAX
package's layer names, so its flat `.npz` checkpoints load strictly
(`utils/checkpoint.load_params`). Every network takes NHWC images. The VGG
pyramid runs in NCHW and returns NCHW feature maps (the loss is a mean of
absolute differences, which does not depend on the layout; at 512^2 its maps
are the largest tensors of the train step); the face nets return NHWC maps
and, for Sphere20a, the fc5 vector.

Weights: a network is built by `build_*`, then `init_vgg_params` /
`init_face_params` load the shipped checkpoint in `assets/` when it is on
disk, else seeded random weights (`seeded_flat_params`). One deliberate
divergence from the JAX package: an explicit `.npz` path that does not exist
raises instead of falling back to the default or to random weights.
"""
from __future__ import annotations

import os
from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.models.networks.blocks import FrozenBatchNorm, conv_nhwc
from ipercore_tpu_torch.ops.sampling import resize_image
from ipercore_tpu_torch.utils.checkpoint import (
    WEIGHTS_DIR,
    load_generator_params,
    load_params,
    seeded_flat_params,
)

Device = Union[str, torch.device]

# ---------------------------------------------------------------------------
# VGG perceptual loss
# ---------------------------------------------------------------------------

_VGG19_SLICES = (
    (64, 64),                # relu1_2
    (128, 128),              # relu2_2
    (256, 256, 256, 256),    # relu3_4
    (512, 512, 512, 512),    # relu4_4
    (512, 512, 512, 512),    # relu5_4
)
_VGG16_SLICES = (
    (64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
_VGG11_SLICES = ((64,), (128,), (256, 256), (512, 512), (512, 512))

_VGG_SLICES_BY_TYPE = {
    "VGG19": _VGG19_SLICES, "VGG16": _VGG16_SLICES, "VGG11": _VGG11_SLICES}

# weights per slice ([1/32, 1/16, 1/8, 1/4, 1])
VGG_SLICE_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

DEFAULT_VGG_WEIGHTS = os.path.join(WEIGHTS_DIR, "vgg_perceptual.npz")
DEFAULT_FACELOSS_WEIGHTS = os.path.join(WEIGHTS_DIR, "faceloss.npz")


class VGGFeatures(nn.Module):
    """VGG feature pyramid (5 slices of 3x3 convolutions + ReLU, 2x2 max
    pooling between slices). Input NHWC in [-1, 1], renormalized with the
    ImageNet statistics; returns the 5 slice outputs as NCHW maps."""

    def __init__(self, slices: Sequence[Sequence[int]] = _VGG19_SLICES):
        super().__init__()
        self.slices = tuple(tuple(s) for s in slices)
        # constants that move with the module (no host-to-device copy a call)
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD), persistent=False)
        cin = 3
        for si, widths in enumerate(self.slices):
            for wi, w in enumerate(widths):
                self.add_module(f"conv{si}_{wi}", nn.Conv2d(cin, w, 3, padding=1))
                cin = w

    def forward(self, x):
        x = (x + 1.0) * 0.5
        x = ((x - self.mean.to(x.dtype)) / self.std.to(x.dtype)).permute(0, 3, 1, 2)
        feats = []
        for si, widths in enumerate(self.slices):
            for wi in range(len(widths)):
                x = F.relu(getattr(self, f"conv{si}_{wi}")(x))
            feats.append(x)
            if si != len(self.slices) - 1:
                x = F.max_pool2d(x, 2)
        return feats


def _frozen(net: nn.Module, device: Device) -> nn.Module:
    """Loss networks are not trained: no parameter of theirs takes a gradient."""
    net = net.to(device).eval()
    for p in net.parameters():
        p.requires_grad_(False)
    return net


def build_vgg(vgg_type: str = "VGG19", device: Device = "cuda") -> VGGFeatures:
    """Perceptual feature net by config name (VGG19 / VGG16 / VGG11)."""
    return _frozen(VGGFeatures(slices=_VGG_SLICES_BY_TYPE[vgg_type]), device)


def _load_or_seed(net: nn.Module, path: str | None, seed: int) -> nn.Module:
    if path:
        net.load_state_dict(load_params(path, net), strict=True)
    else:
        load_generator_params(net, seeded_flat_params(net, seed))
    return net


def init_vgg_params(net: VGGFeatures, weights_path: str | None = None, seed: int = 2) -> VGGFeatures:
    """Load the perceptual net's weights in place: `weights_path` (which must
    exist), else `assets/vgg_perceptual.npz` for the VGG19 layout when it is
    on disk, else `seeded_flat_params(net, seed)`."""
    if weights_path:
        if not os.path.exists(weights_path):
            raise FileNotFoundError(f"VGG weights {weights_path!r} do not exist")
        path = weights_path
    elif net.slices == _VGG19_SLICES and os.path.exists(DEFAULT_VGG_WEIGHTS):
        path = DEFAULT_VGG_WEIGHTS
    else:
        path = None
    return _load_or_seed(net, path, seed)


def _l1_pyramid(fp, ft, weights) -> torch.Tensor:
    loss = 0.0
    for w, a, b in zip(weights, fp, ft):
        loss = loss + w * torch.mean(torch.abs(a - b))
    return loss


def perceptual_loss(vgg: nn.Module, pred: torch.Tensor, target: torch.Tensor,
                    weights: Sequence[float] = VGG_SLICE_WEIGHTS) -> torch.Tensor:
    """Weighted L1 over feature slices; the target's features take no gradient."""
    fp = vgg(pred)
    with torch.no_grad():
        ft = vgg(target)
    return _l1_pyramid(fp, ft, weights)


class LPIPSLin(nn.Module):
    """LPIPS(lin) over the VGG16 pyramid, as the official
    `lpips.LPIPS(net='vgg')`: its input scaling is the ImageNet normalization
    of [-1, 1] inputs that `VGGFeatures` applies; the 5 slice taps are
    normalized to unit length over channels (+1e-10), their squared
    difference goes through a learned 1x1 bias-free conv (`lin{k}`), is
    averaged over space and summed over the taps. Weights from
    `utils/torch_convert.convert_lpips` load by name."""

    def __init__(self):
        super().__init__()
        self.vgg = VGGFeatures(slices=_VGG16_SLICES)
        for k, widths in enumerate(_VGG16_SLICES):
            self.add_module(f"lin{k}", nn.Conv2d(widths[-1], 1, 1, bias=False))

    def forward(self, a, b):
        """a, b: (N, H, W, 3) in [-1, 1] -> (N,) distances."""
        n = a.shape[0]
        total = 0.0
        for k, f in enumerate(self.vgg(torch.cat([a, b]))):
            f = f / torch.sqrt(torch.sum(f ** 2, dim=1, keepdim=True) + 1e-10)
            d = (f[:n] - f[n:]) ** 2
            total = total + getattr(self, f"lin{k}")(d).mean(dim=(1, 2, 3))
        return total


# ---------------------------------------------------------------------------
# Face identity loss (SphereFace-20a)
# ---------------------------------------------------------------------------


class ChannelPReLU(nn.Module):
    """Per-channel PReLU with the torch parameter name ('weight'), slope 0.25."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight * x)


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


class SphereFaceFeatures(nn.Module):
    """The Sphere20a trunk: conv{s}_{i} + per-channel PReLU (relu{s}_{i}),
    residual pairs, fc5 on the flattened (512, 7, 6) stage-4 map (flattened in
    NCHW order, as torch does). Input (N, 112, 96, 3); returns the 4 stage
    maps (NHWC) and the fc5 vector."""

    # (stage, width, residual pairs)
    STAGES = ((1, 64, 1), (2, 128, 2), (3, 256, 4), (4, 512, 1))

    def __init__(self):
        super().__init__()
        cin = 3
        for s, w, pairs in self.STAGES:
            for i in range(1, 2 * pairs + 2):
                self.add_module(f"conv{s}_{i}", _conv3(cin if i == 1 else w, w, 2 if i == 1 else 1))
                self.add_module(f"relu{s}_{i}", ChannelPReLU(w))
            cin = w
        self.fc5 = nn.Linear(512 * 7 * 6, 512)

    def _unit(self, x, s, i):
        return getattr(self, f"relu{s}_{i}")(conv_nhwc(getattr(self, f"conv{s}_{i}"), x))

    def forward(self, x):
        feats = []
        for s, _, pairs in self.STAGES:
            x = self._unit(x, s, 1)
            for i in range(2, 2 * pairs + 2, 2):
                x = x + self._unit(self._unit(x, s, i), s, i + 1)
            feats.append(x)
        feats.append(self.fc5(x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)))
        return feats


# per-level weights, shared by Sphere20a and SENet-50
FACE_SLICE_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)


def face_loss(face: nn.Module, pred: torch.Tensor, target: torch.Tensor,
              pred_bbox: torch.Tensor | None = None, target_bbox: torch.Tensor | None = None,
              hw: tuple[int, int] = (112, 96),
              weights: Sequence[float] = FACE_SLICE_WEIGHTS) -> torch.Tensor:
    """Weighted L1 over face-net feature levels of head crops. Boxes are
    (N, 4) NDC; without one the whole image is resized. `hw` is (112, 96) for
    Sphere20a, (224, 224) for SENet-50. The target's features take no
    gradient."""
    from ipercore_tpu_torch.models.networks.discriminators import crop_by_bbox

    def prep(img, bbox):
        return crop_by_bbox(img, bbox, hw) if bbox is not None else resize_image(img, hw[0], hw[1])

    fp = face(prep(pred, pred_bbox))
    with torch.no_grad():
        ft = face(prep(target, target_bbox))
    return _l1_pyramid(fp, ft, weights)


# ---------------------------------------------------------------------------
# SENet-50 face identity variant
# ---------------------------------------------------------------------------


class SEBottleneck(nn.Module):
    """1x1 (stride) - 3x3 - 1x1 bottleneck with a squeeze-excitation gate
    (global mean -> conv4 1x1 -> relu -> conv5 1x1 -> sigmoid) on the residual
    branch before the skip add. NHWC."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 compress_rate: int = 16):
        super().__init__()
        self.downsample = downsample
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.conv4 = nn.Conv2d(planes * 4, planes * 4 // compress_rate, 1)
        self.conv5 = nn.Conv2d(planes * 4 // compress_rate, planes * 4, 1)
        if downsample:
            self.downsample_conv = nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(planes * 4)

    def forward(self, x):
        out = F.relu(self.bn1(conv_nhwc(self.conv1, x)))
        out = F.relu(self.bn2(conv_nhwc(self.conv2, out)))
        out = self.bn3(conv_nhwc(self.conv3, out))
        gate = out.mean(dim=(1, 2), keepdim=True)
        gate = torch.sigmoid(conv_nhwc(self.conv5, F.relu(conv_nhwc(self.conv4, gate))))
        if self.downsample:
            x = self.downsample_bn(conv_nhwc(self.downsample_conv, x))
        return F.relu(gate * out + x)


class SENetFaceFeatures(nn.Module):
    """The SENet-50 trunk (layers [3, 4, 6, 3], no classifier): 7x7/2 stem,
    ceil-mode 3x3/2 max pool, 4 SE-bottleneck stages. Input (N, 224, 224, 3);
    returns the 5 stage maps (NHWC)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), self.layers), start=1):
            for bi in range(blocks):
                s = (1 if li == 1 else 2) if bi == 0 else 1
                down = bi == 0 and (s != 1 or inplanes != planes * 4)
                self.add_module(f"layer{li}_{bi}", SEBottleneck(inplanes, planes, s, down))
                inplanes = planes * 4

    def forward(self, x):
        x = F.relu(self.bn1(conv_nhwc(self.conv1, x)))
        # torch MaxPool2d(3, 2, ceil_mode=True): pad the bottom and right edge
        # with -inf
        x = F.max_pool2d(F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1), value=float("-inf")), 3, 2)
        x = x.permute(0, 2, 3, 1)
        feats = [x]
        for li, blocks in enumerate(self.layers, start=1):
            for bi in range(blocks):
                x = getattr(self, f"layer{li}_{bi}")(x)
            feats.append(x)
        return feats


def build_face_net(face_loss_path: str = "sphere20a", device: Device = "cuda"):
    """Face net by checkpoint path: SENet-50 at 224x224 when the file name
    mentions 'senet', else Sphere20a at 112x96. Returns (module, (h, w))."""
    if "senet" in os.path.basename(face_loss_path).lower():
        return _frozen(SENetFaceFeatures(), device), (224, 224)
    return _frozen(SphereFaceFeatures(), device), (112, 96)


def init_face_params(face_loss_path: str = "sphere20a", seed: int = 3, device: Device = "cuda"):
    """Face net and its weights by config path. A `.npz` path must exist and
    is loaded; "random" and SENet names start from `seeded_flat_params(net,
    seed)`; any other name (the symbolic "sphere20a") loads
    `assets/faceloss.npz` when it is on disk, else seeds.

    Returns (module, (h, w))."""
    net, hw = build_face_net(face_loss_path, device)
    name = os.path.basename(str(face_loss_path)).lower()
    if str(face_loss_path).endswith(".npz"):
        if not os.path.exists(face_loss_path):
            raise FileNotFoundError(f"face-loss weights {face_loss_path!r} do not exist")
        path = face_loss_path
    elif name != "random" and "senet" not in name and os.path.exists(DEFAULT_FACELOSS_WEIGHTS):
        path = DEFAULT_FACELOSS_WEIGHTS
    else:
        path = None
    return _load_or_seed(net, path, seed), hw


# ---------------------------------------------------------------------------
# GAN / regularization losses
# ---------------------------------------------------------------------------


def lsgan_loss(outs: Sequence[torch.Tensor], target: float) -> torch.Tensor:
    """LSGAN mean((out - target)^2) averaged over the heads; a crop that
    collapsed to size 0 is left out."""
    valid = [o for o in outs if o.numel() > 0]
    loss = 0.0
    for o in valid:
        loss = loss + torch.mean((o - target) ** 2)
    return loss / max(len(valid), 1)


def tv_loss(mask: torch.Tensor) -> torch.Tensor:
    """Total-variation smoothness of NHWC maps."""
    dh = torch.mean(torch.abs(mask[:, 1:] - mask[:, :-1]))
    dw = torch.mean(torch.abs(mask[:, :, 1:] - mask[:, :, :-1]))
    return dh + dw


def temporal_smooth_loss(frames: torch.Tensor) -> torch.Tensor:
    """L1 between consecutive frames (N, T, H, W, C)."""
    return torch.mean(torch.abs(frames[:, 1:] - frames[:, :-1]))


def mask_bce_loss(pred_mask: torch.Tensor, target_mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Binary cross-entropy of predicted attention masks. The clip is
    min(max(.)) as `jnp.clip` is, so a value equal to a bound passes half of
    its gradient, as in JAX (`torch.clamp` would pass all of it)."""
    lo, hi = pred_mask.new_full((), eps), pred_mask.new_full((), 1.0 - eps)
    p = torch.minimum(torch.maximum(pred_mask, lo), hi)
    t = target_mask
    return -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))
