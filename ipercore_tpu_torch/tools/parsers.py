"""SCHP (Self-Correction Human Parsing): the LIP 20-class human and cloth
parser.

The port's copy of `ipercore_tpu/tools/parsers.py`: the SCHP graph (a
ResNet-101 trunk with a 3-conv stem and frozen batch norms, the PSP context
head, the edge branch, the parsing decoder and the fusion head), its runner
and the host post-processing. `utils/torch_convert.convert_schp` carries the
published `exp-schp-lip.pth` into the same layout, and `assets/schp.npz`
loads through the strict carrier.

As in the JAX package, the adaptive average pooling of the PSP head and the
align_corners=True bilinear resizes are products with small matrices built in
numpy (`_adaptive_pool_matrix`, `_interp_matrix`), not `F.adaptive_avg_pool2d`
or `F.interpolate`, so the two packages compute the same sums. The network
takes NHWC at its boundary and runs NCHW inside; its submodules carry the
Flax names (`layer3_22`, `context_encoding`, `fushion_conv`, ...).

The connected-component clean-up runs on the host with scipy.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.models.networks.blocks import FrozenBatchNorm, frozen_bn_nchw as _bn
from ipercore_tpu_torch.utils.checkpoint import (WEIGHTS_DIR, load_flat_npz, load_generator_params,
                                                 seeded_flat_params)

SCHP_DEFAULT_WEIGHTS = os.path.join(WEIGHTS_DIR, "schp.npz")
# seeded weights when no weight file is given (the JAX package inits from PRNGKey(0))
SCHP_SEED = 9

# LIP label semantics (the reference's DATASET_SETTINGS["lip"]).
LIP_INPUT_SIZE = 473
LIP_NUM_CLASSES = 20
LIP_LABELS = [
    "Background", "Hat", "Hair", "Glove", "Sunglasses", "Upper-clothes",
    "Dress", "Coat", "Socks", "Pants", "Jumpsuits", "Scarf", "Skirt", "Face",
    "Left-arm", "Right-arm", "Left-leg", "Right-leg", "Left-shoe", "Right-shoe",
]
# The reference's LIP "body" set leaves out class 5 (Upper-clothes); kept.
LIP_TARGETS = {
    "body": (1, 2, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19),
    "skirt+dress": (6, 12),
    "background": (0,),
}


class ABN(nn.Module):
    """Frozen BatchNorm (eps 1e-5) + LeakyReLU(0.01), NCHW."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = FrozenBatchNorm(features)

    def forward(self, x):
        return F.leaky_relu(_bn(self.bn, x), 0.01)


def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align_corners=True linear interpolation weights."""
    w = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        w[:, 0] = 1.0
        return w
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    t = (src - lo).astype(np.float32)
    w[np.arange(n_out), lo] += 1.0 - t
    w[np.arange(n_out), hi] += t
    return w


def _adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic matrix of torch's AdaptiveAvgPool regions."""
    w = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        a = (i * n_in) // n_out
        b = -((-(i + 1) * n_in) // n_out)  # ceil
        w[i, a:b] = 1.0 / (b - a)
    return w


class _Matrices:
    """The resize and pooling matrices on a device, built once per shape (so
    that a forward on the card copies nothing from the host)."""

    def __init__(self):
        self._cache: dict = {}

    def get(self, kind: str, n_in: int, n_out: int, device) -> torch.Tensor:
        key = (kind, n_in, n_out, str(device))
        if key not in self._cache:
            make = _interp_matrix if kind == "interp" else _adaptive_pool_matrix
            self._cache[key] = torch.as_tensor(make(n_in, n_out), device=device)
        return self._cache[key]


def _apply_nchw(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Separable (h, H) and (w, W) matrices over the spatial axes of NCHW."""
    x = torch.einsum("yH,ncHW->ncyW", wy, x)
    return torch.einsum("xW,ncyW->ncyx", wx, x)


def _resize_ac(x: torch.Tensor, h: int, w: int, mats: _Matrices) -> torch.Tensor:
    H, W = x.shape[2], x.shape[3]
    if (H, W) == (h, w):
        return x
    return _apply_nchw(x, mats.get("interp", H, h, x.device), mats.get("interp", W, w, x.device))


def _pool(x: torch.Tensor, k: int, mats: _Matrices) -> torch.Tensor:
    return _apply_nchw(x, mats.get("pool", x.shape[2], k, x.device), mats.get("pool", x.shape[3], k, x.device))


def resize_bilinear_ac(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """align_corners=True bilinear resize of (N, H, W, C) by two products."""
    return _resize_ac(x.permute(0, 3, 1, 2), h, w, _Matrices()).permute(0, 2, 3, 1)


def adaptive_avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact AdaptiveAvgPool2d((k, k)) of (N, H, W, C) by two products."""
    return _pool(x.permute(0, 3, 1, 2), k, _Matrices()).permute(0, 2, 3, 1)


class SchpBottleneck(nn.Module):
    """ResNet bottleneck with dilation (stride on the 3x3), NCHW."""

    def __init__(self, cin: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        d = dilation
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=d, dilation=d, bias=False)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(features * 4)
        if cin != features * 4 or stride != 1:
            self.downsample_conv = nn.Conv2d(cin, features * 4, 1, stride=stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(features * 4)

    def forward(self, x):
        y = F.relu(_bn(self.bn1, self.conv1(x)))
        y = F.relu(_bn(self.bn2, self.conv2(y)))
        y = _bn(self.bn3, self.conv3(y))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = _bn(self.downsample_bn, self.downsample_conv(x))
        return F.relu(y + residual)


class PSPModule(nn.Module):
    """Pyramid scene parsing context head over pooled grids of 1, 2, 3, 6."""

    def __init__(self, cin: int = 2048, out_features: int = 512, sizes: tuple = (1, 2, 3, 6)):
        super().__init__()
        self.sizes = sizes
        for i in range(len(sizes)):
            self.add_module(f"stage{i}_conv", nn.Conv2d(cin, out_features, 1, bias=False))
            self.add_module(f"stage{i}_abn", ABN(out_features))
        self.bottleneck_conv = nn.Conv2d(cin + len(sizes) * out_features, out_features, 3, padding=1,
                                         bias=False)
        self.bottleneck_abn = ABN(out_features)

    def forward(self, x, mats: _Matrices):
        h, w = x.shape[2], x.shape[3]
        priors = []
        for i, size in enumerate(self.sizes):
            p = getattr(self, f"stage{i}_abn")(getattr(self, f"stage{i}_conv")(_pool(x, size, mats)))
            priors.append(_resize_ac(p, h, w, mats))
        y = self.bottleneck_conv(torch.cat(priors + [x], dim=1))
        return self.bottleneck_abn(y)


class EdgeModule(nn.Module):
    """Edge branch over (x2, x3, x4): one shared 3x3 edge head."""

    def __init__(self, cins: tuple = (256, 512, 1024), mid_fea: int = 256, out_fea: int = 2):
        super().__init__()
        for i, c in enumerate(cins, start=1):
            self.add_module(f"conv{i}_conv", nn.Conv2d(c, mid_fea, 1, bias=False))
            self.add_module(f"conv{i}_abn", ABN(mid_fea))
        self.conv4 = nn.Conv2d(mid_fea, out_fea, 3, padding=1)
        self.conv5 = nn.Conv2d(3 * out_fea, out_fea, 1)

    def forward(self, x1, x2, x3, mats: _Matrices):
        h, w = x1.shape[2], x1.shape[3]
        feas, edges = [], []
        for i, x in enumerate((x1, x2, x3), start=1):
            fea = getattr(self, f"conv{i}_abn")(getattr(self, f"conv{i}_conv")(x))
            edge = self.conv4(fea)
            if i > 1:
                fea, edge = _resize_ac(fea, h, w, mats), _resize_ac(edge, h, w, mats)
            feas.append(fea)
            edges.append(edge)
        return self.conv5(torch.cat(edges, dim=1)), torch.cat(feas, dim=1)


class DecoderModule(nn.Module):
    """Parsing decoder: the PSP feature upsampled onto the low-level x2."""

    def __init__(self, num_classes: int, c_top: int = 512, c_low: int = 256):
        super().__init__()
        self.conv1_conv = nn.Conv2d(c_top, 256, 1, bias=False)
        self.conv1_abn = ABN(256)
        self.conv2_conv = nn.Conv2d(c_low, 48, 1, bias=False)
        self.conv2_abn = ABN(48)
        self.conv3a_conv = nn.Conv2d(304, 256, 1, bias=False)
        self.conv3a_abn = ABN(256)
        self.conv3b_conv = nn.Conv2d(256, 256, 1, bias=False)
        self.conv3b_abn = ABN(256)
        self.conv4 = nn.Conv2d(256, num_classes, 1)

    def forward(self, xt, xl, mats: _Matrices):
        h, w = xl.shape[2], xl.shape[3]
        xt = _resize_ac(self.conv1_abn(self.conv1_conv(xt)), h, w, mats)
        xl = self.conv2_abn(self.conv2_conv(xl))
        x = self.conv3a_abn(self.conv3a_conv(torch.cat([xt, xl], dim=1)))
        x = self.conv3b_abn(self.conv3b_conv(x))
        return self.conv4(x), x


class SchpNet(nn.Module):
    """The SCHP graph (ResNet-101: layers 3 / 4 / 23 / 3; layer 4 dilated).

    Input (N, H, W, 3) normalised; output (N, H/4, W/4, num_classes) fusion
    logits (the runner resizes them to the frame).
    """

    STAGE_WIDTHS = (64, 128, 256, 512)

    def __init__(self, num_classes: int = LIP_NUM_CLASSES, layers: tuple = (3, 4, 23, 3)):
        super().__init__()
        self.num_classes, self.layers = num_classes, layers
        cin = 3
        for i, width in ((1, 64), (2, 64), (3, 128)):
            self.add_module(f"conv{i}", nn.Conv2d(cin, width, 3, stride=2 if i == 1 else 1, padding=1,
                                                  bias=False))
            self.add_module(f"bn{i}", FrozenBatchNorm(width))
            cin = width
        for li, (blocks, width) in enumerate(zip(layers, self.STAGE_WIDTHS), 1):
            for b in range(blocks):
                stride = 2 if (b == 0 and li in (2, 3)) else 1
                self.add_module(f"layer{li}_{b}", SchpBottleneck(cin, width, stride, 2 if li == 4 else 1))
                cin = width * 4
        self.context_encoding = PSPModule(cin)
        self.decoder = DecoderModule(num_classes)
        self.edge = EdgeModule()
        self.fushion_conv = nn.Conv2d(1024, 256, 1, bias=False)
        self.fushion_abn = ABN(256)
        self.fushion_head = nn.Conv2d(256, num_classes, 1)
        self.mats = _Matrices()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = F.relu(_bn(getattr(self, f"bn{i}"), getattr(self, f"conv{i}")(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # the -inf pad of the JAX package
        feats = []
        for li, blocks in enumerate(self.layers, 1):
            for b in range(blocks):
                x = getattr(self, f"layer{li}_{b}")(x)
            feats.append(x)
        x2, x3, x4, x5 = feats
        parsing, parsing_fea = self.decoder(self.context_encoding(x5, self.mats), x2, self.mats)
        _, edge_fea = self.edge(x2, x3, x4, self.mats)
        fused = self.fushion_abn(self.fushion_conv(torch.cat([parsing_fea, edge_fea], dim=1)))
        # Dropout2d(0.1) is the identity at inference
        return self.fushion_head(fused).permute(0, 2, 3, 1)


def find_largest_connected_mask(mask: np.ndarray) -> np.ndarray:
    """Keep the largest 4-connected component, then a morphological close
    with a 5x5 element (scipy's, which erodes at the image border)."""
    from scipy import ndimage

    mask = (mask > 0).astype(np.uint8)
    if mask.sum() == 0:
        return mask
    labels, n = ndimage.label(mask)
    if n > 1:
        sizes = ndimage.sum(mask, labels, index=np.arange(1, n + 1))
        mask = (labels == (1 + int(np.argmax(sizes)))).astype(np.uint8)
    return ndimage.binary_closing(mask.astype(bool), np.ones((5, 5), bool)).astype(np.uint8)


class SchpParser:
    """Batched SCHP on the device.

    Frames come in as (N, H, W, 3) RGB in [-1, 1]; the normalisation to
    [0, 1] and MEAN / STD is applied inside, in RGB order, as the JAX package
    applies it. Without `params` the weights are
    `seeded_flat_params(net, 9)` and `trained` is False (`build_parser`
    returns None then, and callers keep their fallbacks).
    """

    MEAN = (0.485, 0.456, 0.406)
    STD = (0.229, 0.224, 0.225)

    def __init__(self, params=None, input_size: int = LIP_INPUT_SIZE,
                 num_classes: int = LIP_NUM_CLASSES, device="cuda"):
        self.device = torch.device(device)
        self.net = SchpNet(num_classes=num_classes).eval()
        self.input_size = input_size
        self.trained = params is not None
        if params is None:
            params = seeded_flat_params(self.net, SCHP_SEED)
        load_generator_params(self.net, params)
        self.net.to(self.device)
        self.params = params
        self._mean = torch.tensor(self.MEAN, device=self.device)
        self._std = torch.tensor(self.STD, device=self.device)

    def logits(self, images) -> torch.Tensor:
        """(N, H, W, 3) in [-1, 1] -> (N, H, W, num_classes) logits on the
        device, resized back to the frames."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        h, w = x.shape[1], x.shape[2]
        y = ((x + 1.0) * 0.5 - self._mean) / self._std
        s = self.input_size
        with torch.inference_mode():
            y = _resize_ac(y.permute(0, 3, 1, 2), s, s, self.net.mats).permute(0, 2, 3, 1)
            out = self.net(y).permute(0, 3, 1, 2)
            return _resize_ac(out, h, w, self.net.mats).permute(0, 2, 3, 1)

    def parse(self, images, batch_size: int = 8) -> np.ndarray:
        """(N, H, W, 3) [-1, 1] -> (N, H, W) int64 label maps (the argmax)."""
        outs = [self.logits(images[i:i + batch_size]).argmax(dim=-1).cpu().numpy()
                for i in range(0, len(images), batch_size)]
        return np.concatenate(outs, axis=0)

    def run(self, images, target: str = "body", min_pixels: int = 100) -> tuple[bool, list[np.ndarray]]:
        """Labels, the `target` classes, the largest-component clean-up.

        Returns (found, per-frame binary masks). For "skirt+dress" it bails
        out, with the masks so far, at the first frame with fewer than
        `min_pixels` target pixels."""
        parse = self.parse(images)
        valid = np.zeros((self.net.num_classes,), np.uint8)
        valid[list(LIP_TARGETS[target])] = 1
        masks = []
        for p in parse:
            m = valid[p]
            if target == "skirt+dress" and m.sum() < min_pixels:
                return False, masks
            masks.append(find_largest_connected_mask(m))
        return True, masks


def build_parser(weights_path: Optional[str] = None, device="cuda") -> Optional[SchpParser]:
    """A trained `SchpParser` from `weights_path` (default
    `assets/schp.npz`; f16 on disk -> f32), or None when the file does not
    exist: downstream stages then keep their geometry fallbacks."""
    path = weights_path or SCHP_DEFAULT_WEIGHTS
    if not os.path.exists(path):
        return None
    flat = {k: np.asarray(v, np.float32) for k, v in load_flat_npz(path).items()}
    return SchpParser(params=flat, device=device)
