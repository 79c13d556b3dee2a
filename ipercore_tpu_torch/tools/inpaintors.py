"""Background inpainting and super-resolution.

The port's copy of `ipercore_tpu/tools/inpaintors.py`: DeepFill-v2-style
gated-convolution inpainting at a control size (`GatedInpaintor`, and the
stage-2 `RefineInpaintor` with its contextual-attention branch), then ESRGAN's
4x `RRDBNet` back up when the frame is at least four times the control size.
Without trained inpainting weights the hole is filled by diffusion
(`diffusion_fill`).

The networks take and return NHWC tensors and run NCHW inside; their
submodules carry the Flax names (`GatedConv_13`, `body_7/rdb2/conv3`, ...), so
`inpaintor.npz`, `inpaintor_refine.npz` and `esrgan.npz` load through the
strict carrier.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.ops.attention import ContextualAttention
from ipercore_tpu_torch.ops.sampling import resize_image
from ipercore_tpu_torch.utils.checkpoint import (WEIGHTS_DIR, load_flat_npz, load_generator_params,
                                                 seeded_flat_params)

INPAINT_DEFAULT_WEIGHTS = os.path.join(WEIGHTS_DIR, "inpaintor.npz")
SR_DEFAULT_WEIGHTS = os.path.join(WEIGHTS_DIR, "esrgan.npz")
REFINE_DEFAULT_WEIGHTS = os.path.join(WEIGHTS_DIR, "inpaintor_refine.npz")
# seeded weights when no weight file is given (the JAX package inits from
# PRNGKey(0), (2) and (1))
INPAINT_SEED, REFINE_SEED, SR_SEED = 10, 11, 12


class GatedConv(nn.Module):
    """Gated convolution: a 3x3 conv to 2 x features, elu(feature) x
    sigmoid(gate)."""

    def __init__(self, cin: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        d = dilation
        self.Conv_0 = nn.Conv2d(cin, 2 * features, 3, stride=stride, padding=d, dilation=d)

    def forward(self, x):
        feat, gate = self.Conv_0(x).chunk(2, dim=1)
        return F.elu(feat) * torch.sigmoid(gate)


def _deconv(cin: int, cout: int) -> nn.ConvTranspose2d:
    """Flax `ConvTranspose((4, 4), strides=(2, 2), padding="SAME")`."""
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)


class _Gated(nn.Module):
    """Holds `GatedConv_<i>` in Flax's order of creation."""

    def _gates(self, specs):
        for i, spec in enumerate(specs):
            self.add_module(f"GatedConv_{i}", GatedConv(*spec))

    def g(self, i: int, x):
        return getattr(self, f"GatedConv_{i}")(x)


class GatedInpaintor(_Gated):
    """Coarse gated-conv inpainting network (DeepFill-v2 stage-1 topology):
    (N, H, W, 4 = masked RGB + mask) -> (N, H, W, 3) in [-1, 1]."""

    def __init__(self, width: int = 48):
        super().__init__()
        w = width
        self._gates([(4, w), (w, 2 * w, 2), (2 * w, 2 * w), (2 * w, 4 * w, 2)]
                    + [(4 * w, 4 * w, 1, d) for d in (1, 2, 4, 8)]
                    + [(4 * w, 4 * w), (2 * w, 2 * w), (w, w)])
        self.ConvTranspose_0 = _deconv(4 * w, 2 * w)
        self.ConvTranspose_1 = _deconv(2 * w, w)
        self.Conv_0 = nn.Conv2d(w, 3, 3, padding=1)

    def forward(self, x):
        y = x.permute(0, 3, 1, 2)
        for i in range(9):
            y = self.g(i, y)
        y = self.g(9, self.ConvTranspose_0(y))
        y = self.g(10, self.ConvTranspose_1(y))
        return torch.tanh(self.Conv_0(y)).permute(0, 2, 3, 1)


class RefineInpaintor(_Gated):
    """DeepFill-v2 stage-2 refinement: a dilated gated-conv branch and a
    contextual-attention branch (attention at H/4) over the coarse result,
    concatenated and decoded to the refined RGB."""

    def __init__(self, width: int = 48):
        super().__init__()
        w = width
        a = [(4, w), (w, 2 * w, 2), (2 * w, 2 * w), (2 * w, 4 * w, 2)] + [(4 * w, 4 * w, 1, d) for d in (1, 2, 4, 8)]
        b = [(4, w), (w, w, 2), (w, 2 * w), (2 * w, 2 * w, 2), (2 * w, 4 * w), (4 * w, 4 * w)]
        self._gates(a + b + [(8 * w, 4 * w), (2 * w, 2 * w), (w, w)])
        self.ContextualAttention_0 = ContextualAttention()
        self.ConvTranspose_0 = _deconv(4 * w, 2 * w)
        self.ConvTranspose_1 = _deconv(2 * w, w)
        self.Conv_0 = nn.Conv2d(w, 3, 3, padding=1)

    def forward(self, x, hole_mask):
        """x: (N, H, W, 4) = coarse-filled RGB + mask; hole_mask (N, H, W, 1).
        Returns (N, H, W, 3) refined RGB in [-1, 1]."""
        x = x.permute(0, 3, 1, 2)
        a = x
        for i in range(8):
            a = self.g(i, a)
        b = x
        for i in range(8, 13):
            b = self.g(i, b)
        m4 = (resize_image(hole_mask, b.shape[2], b.shape[3]) > 0.25).to(b.dtype)
        b = self.ContextualAttention_0(b.permute(0, 2, 3, 1), m4).permute(0, 3, 1, 2)
        b = self.g(13, b)
        y = self.g(14, torch.cat([a, b], dim=1))
        y = self.g(15, self.ConvTranspose_0(y))
        y = self.g(16, self.ConvTranspose_1(y))
        return torch.tanh(self.Conv_0(y)).permute(0, 2, 3, 1)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResidualDenseBlock(nn.Module):
    """ESRGAN residual dense block: conv1..conv4 emit `growth` channels from
    the running concat (lrelu 0.2), conv5 projects back to `width`;
    out = x + 0.2 * conv5."""

    def __init__(self, width: int = 64, growth: int = 32):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i + 1}", _conv3(width + i * growth, growth))
        self.conv5 = _conv3(width + 4 * growth, width)

    def forward(self, x):
        feats = [x]
        for i in range(4):
            feats.append(F.leaky_relu(getattr(self, f"conv{i + 1}")(torch.cat(feats, dim=1)), 0.2))
        return x + 0.2 * self.conv5(torch.cat(feats, dim=1))


class RRDB(nn.Module):
    """Residual-in-residual dense block: 3 RDBs + a 0.2-scaled residual."""

    def __init__(self, width: int = 64, growth: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(width, growth)
        self.rdb2 = ResidualDenseBlock(width, growth)
        self.rdb3 = ResidualDenseBlock(width, growth)

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """ESRGAN 4x RRDBNet: conv_first, `n_blocks` RRDBs, the conv_body
    residual, nearest-2x conv_up1 and conv_up2, conv_hr, conv_last; lrelu
    0.2. Works in the checkpoint's [0, 1] image domain:
    (N, H, W, 3) -> (N, 4H, 4W, 3)."""

    def __init__(self, width: int = 64, growth: int = 32, n_blocks: int = 23):
        super().__init__()
        self.n_blocks = n_blocks
        self.conv_first = _conv3(3, width)
        for i in range(n_blocks):
            self.add_module(f"body_{i}", RRDB(width, growth))
        self.conv_body = _conv3(width, width)
        self.conv_up1 = _conv3(width, width)
        self.conv_up2 = _conv3(width, width)
        self.conv_hr = _conv3(width, width)
        self.conv_last = _conv3(width, 3)

    def forward(self, x):
        feat = self.conv_first(x.permute(0, 3, 1, 2))
        y = feat
        for i in range(self.n_blocks):
            y = getattr(self, f"body_{i}")(y)
        y = feat + self.conv_body(y)
        for conv in (self.conv_up1, self.conv_up2):
            # exactly 2x: nearest picks source pixel j // 2, as `jax.image.resize`
            y = F.leaky_relu(conv(F.interpolate(y, scale_factor=2, mode="nearest")), 0.2)
        y = F.leaky_relu(self.conv_hr(y), 0.2)
        return self.conv_last(y).permute(0, 2, 3, 1)


def diffusion_fill(img: torch.Tensor, mask: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Iterative masked diffusion inpaint (the training-free fallback).
    img: (N, H, W, 3); mask: (N, H, W, 1), 1 = hole to fill."""
    from ipercore_tpu_torch.models.flow_composition import boundary_fill

    return boundary_fill(img, 1.0 - mask, torch.ones_like(mask), iters=iters)


def _flat(path: str) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in load_flat_npz(path).items()}


class SuperResolutionInpaintor:
    """Inpaint at `control_size`, refine, super-resolve back.

    Weights as the JAX package picks them: given parameters, else the files
    (`weights_path` or `assets/inpaintor.npz`, `refine_weights_path` or
    `assets/inpaintor_refine.npz`, `assets/esrgan.npz`) when they exist, else
    seeded (10, 11, 12). `trained` (the gated net runs, else diffusion),
    `refine_trained` and `sr_trained` say which parts had weights.
    """

    def __init__(self, inpaint_params=None, sr_params=None, control_size: int = 256,
                 trained: bool = False, sr_blocks: int = 23, weights_path: str = None,
                 refine_params=None, refine_weights_path: str = None, device="cuda"):
        self.device = torch.device(device)
        self.control_size = control_size
        self.net = GatedInpaintor().eval()
        self.refine = RefineInpaintor().eval()
        self.sr = RRDBNet(n_blocks=sr_blocks).eval()
        if inpaint_params is None:
            path = weights_path or INPAINT_DEFAULT_WEIGHTS
            if os.path.exists(path):
                inpaint_params = _flat(path)
        self.trained = trained or inpaint_params is not None
        # stage 2 only with trained weights: an untrained attention decoder
        # would corrupt the stage-1 result
        self.refine_trained = refine_params is not None
        rpath = refine_weights_path or REFINE_DEFAULT_WEIGHTS
        if refine_params is None and os.path.exists(rpath):
            refine_params, self.refine_trained = _flat(rpath), True
        self.sr_trained = sr_params is not None
        if sr_params is None and os.path.exists(SR_DEFAULT_WEIGHTS):
            sr_params, self.sr_trained = _flat(SR_DEFAULT_WEIGHTS), True
        for net, params, seed in ((self.net, inpaint_params, INPAINT_SEED),
                                  (self.refine, refine_params, REFINE_SEED),
                                  (self.sr, sr_params, SR_SEED)):
            load_generator_params(net, params if params is not None else seeded_flat_params(net, seed))
            net.to(self.device)

    def run_inpainting(self, image, mask) -> np.ndarray:
        """image: (H, W, 3) in [-1, 1]; mask: (H, W, 1), 1 = the person
        region to remove. Returns the (H, W, 3) inpainted background (numpy):
        the gated stage, the refinement when trained, and the 4x SR when
        trained and max(H, W) >= 4 x the control size, then a resize to
        (H, W)."""
        img = torch.as_tensor(np.asarray(image), dtype=torch.float32, device=self.device)
        msk = torch.as_tensor(np.asarray(mask), dtype=torch.float32, device=self.device)
        H, W = img.shape[:2]
        s = self.control_size
        img_c = resize_image(img, s, s)[None]
        mask_c = (resize_image(msk, s, s)[None] > 0.5).float()
        with torch.inference_mode():
            if self.trained:
                out = self.net(torch.cat([img_c * (1 - mask_c), mask_c], dim=-1))
                out = img_c * (1 - mask_c) + out * mask_c
                if self.refine_trained:
                    ref = self.refine(torch.cat([out, mask_c], dim=-1), mask_c)
                    out = img_c * (1 - mask_c) + ref * mask_c
            else:
                out = diffusion_fill(img_c * (1 - mask_c), mask_c)
            if (H, W) != (s, s):
                if self.sr_trained and max(H, W) >= 4 * s:
                    out = self.sr((out + 1.0) * 0.5)
                    out = torch.clamp(out, 0.0, 1.0) * 2.0 - 1.0
                out = resize_image(out, H, W)
        return out[0].cpu().numpy()


def build_background_inpaintors(name: str = "gated_conv+rrdb", device="cuda", **kw) -> SuperResolutionInpaintor:
    """The background inpaintor (`name` is kept for the callers; one kind)."""
    return SuperResolutionInpaintor(device=device, **kw)
