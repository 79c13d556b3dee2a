"""Human matting, segmentation half: the person segmenter.

The port's copy of the part of `ipercore_tpu/tools/mattors.py` that person
detection needs: `PersonSegUNet` (an encoder-decoder person segmenter, the
role of the reference's PointRend masks), its weight file and a `HumanMattor`
that builds and loads it. The matting half — `HumanMattor.run`, the trimap
(`generate_trimap`) and the refiners (`MattingRefiner`, `GCAMattingRefiner`) —
belongs to a later slice of the port (ROADMAP Queue 1 item 8) and raises
NotImplementedError until then; the refiner's weights are not read.

The network takes and returns NHWC tensors and runs NCHW inside. Its
submodules carry Flax's auto-names (`ConvBlock_0`, `Conv_0`,
`ConvTranspose_0`, ...), so the `seg/params/...` entries of `person_seg.npz`
load through the carrier once the `seg/` prefix is taken off.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.utils.checkpoint import (WEIGHTS_DIR, load_generator_params,
                                                 seeded_flat_params)

DEFAULT_WEIGHTS = os.path.join(WEIGHTS_DIR, "person_seg.npz")
GCA_WEIGHTS = os.path.join(WEIGHTS_DIR, "matting_gca.npz")
# seeded weights when no weight file is given (the JAX package inits from PRNGKey(0))
PERSON_SEG_SEED = 5
_LATER = "the matting half of tools/mattors.py is ported with ROADMAP Queue 1 item 8"


def _read_trees(path: str, tops=None):
    """The top-level trees of a weight file (only those named in `tops`, when
    given), f16 on disk -> f32, each a flat dict keyed `params/...` as the
    carrier takes it; None when the file does not exist."""
    if not os.path.exists(path):
        return None
    trees: dict[str, dict[str, np.ndarray]] = {}
    with np.load(path) as z:
        for k in z.files:
            top, _, rest = k.partition("/")
            if tops is None or top in tops:
                trees.setdefault(top, {})[rest] = np.asarray(z[k], np.float32)
    return trees


def load_default_weights(path: str = None):
    """{"seg": flat, "mat": flat} trained parameters of a weight file (f16 on
    disk -> f32), each flat dict keyed `params/...` as the carrier takes it;
    None when the file does not exist."""
    return _read_trees(path or DEFAULT_WEIGHTS)


def _has_tree(path: str, top: str) -> bool:
    with np.load(path) as z:
        return any(k.partition("/")[0] == top for k in z.files)


class ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, 3, padding=1)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return F.relu(self.Conv_1(F.relu(self.Conv_0(x))))


class PersonSegUNet(nn.Module):
    """UNet person segmenter: (N, H, W, 3) -> (N, H, W, 1) logits; four
    downs, a dilated-conv context block (rates 2, 4) at the bottleneck, and
    4x4 stride-2 transposed convolutions up (Flax `padding="SAME"`, which is
    torch's `padding=1` on the flipped kernel the carrier stores)."""

    def __init__(self, widths: tuple = (32, 64, 128, 256, 256), context_rates: tuple = (2, 4)):
        super().__init__()
        self.widths, self.context_rates = widths, context_rates
        blocks, cin = [], 3
        for w in widths:
            blocks.append(ConvBlock(cin, w))
            cin = w
        for i, r in enumerate(context_rates):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, cin, 3, padding=r, dilation=r))
        for i, (w, skip) in enumerate(zip(reversed(widths[:-1]), reversed(widths[:-1]))):
            self.add_module(f"ConvTranspose_{i}", nn.ConvTranspose2d(cin, w, 4, stride=2, padding=1))
            blocks.append(ConvBlock(w + skip, w))
            cin = w
        for i, b in enumerate(blocks):
            self.add_module(f"ConvBlock_{i}", b)
        self.add_module(f"Conv_{len(context_rates)}", nn.Conv2d(cin, 1, 1))

    def forward(self, x):
        n_down = len(self.widths) - 1
        x = x.permute(0, 3, 1, 2)
        skips = []
        for i in range(n_down):
            x = getattr(self, f"ConvBlock_{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = getattr(self, f"ConvBlock_{n_down}")(x)
        for i in range(len(self.context_rates)):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        for i, s in enumerate(reversed(skips)):
            x = getattr(self, f"ConvTranspose_{i}")(x)
            x = getattr(self, f"ConvBlock_{n_down + 1 + i}")(torch.cat([x, s], dim=1))
        return getattr(self, f"Conv_{len(self.context_rates)}")(x).permute(0, 2, 3, 1)


class MattingRefiner:
    """Trimap-guided alpha refiner: not ported yet."""

    def __init__(self, *args, **kw):
        raise NotImplementedError(_LATER)


class GCAMattingRefiner(MattingRefiner):
    """Guided-contextual-attention alpha refiner: not ported yet."""


def generate_trimap(*args, **kw):
    """Binary person mask -> trimap: not ported yet."""
    raise NotImplementedError(_LATER)


class HumanMattor:
    """The person segmenter of the end-to-end mattor, on the device.

    Weights as the JAX package picks them: `seg_params` when given (flat, in
    the Flax layout); else the `seg` tree of `weights_path` or
    `assets/person_seg.npz`, or where that file is absent and
    `assets/matting_gca.npz` holds a `mat` tree, its `seg` tree; else
    `seeded_flat_params(seg, 5)`. `trained` is True when weights were given
    or found. `segment` gives logits; `run` (the matting) is not ported yet.
    """

    def __init__(self, seg_params=None, weights_path: str = None,
                 gca_weights_path: str = None, device="cuda"):
        self.device = torch.device(device)
        self.seg = PersonSegUNet().eval()
        if seg_params is None:
            found = _read_trees(weights_path or DEFAULT_WEIGHTS, ("seg",))
            gca_path = gca_weights_path or GCA_WEIGHTS
            if found is not None:
                seg_params = found["seg"]
            elif os.path.exists(gca_path) and _has_tree(gca_path, "mat"):
                seg_params = _read_trees(gca_path, ("seg",)).get("seg")
        self.trained = seg_params is not None
        if seg_params is None:
            seg_params = seeded_flat_params(self.seg, PERSON_SEG_SEED)
        load_generator_params(self.seg, seg_params)
        self.seg.to(self.device)
        self.seg_params = seg_params

    def segment(self, images) -> torch.Tensor:
        """(N, H, W, 3) in [-1, 1] (numpy or tensor) -> (N, H, W, 1) logits
        on the device."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return self.seg(x)

    def run(self, images, fallback_mask=None, batch_size: int = 16):
        raise NotImplementedError(_LATER)
