"""Human matting: person segmentation -> trimap -> alpha matting.

The port's copy of `ipercore_tpu/tools/mattors.py`:
  * `PersonSegUNet`: an encoder-decoder person segmenter (the role of the
    reference's PointRend masks), also person detection's segmenter;
  * `generate_trimap`: the erode / dilate band around a person mask;
  * `MattingRefiner` and `GCAMattingRefiner`: trimap-guided alpha refiners,
    the second with a contextual-attention block at its bottleneck
    (`ops/attention.py`) and GroupNorm'd convolutions;
  * `HumanMattor.run`: segmenter, the compactness gate and the IoU-gated band
    around a fallback (SMPL) silhouette, the trimap and the refiner.

The networks take and return NHWC tensors and run NCHW inside. Their
submodules carry Flax's auto-names (`ConvBlock_0`, `NormConvBlock_2`,
`GroupNorm_1`, `ConvTranspose_0`, ...), so the `seg/params/...` and
`mat/params/...` entries of `person_seg.npz` and `matting_gca.npz` load
through the carrier once the top-level prefix is taken off.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.ops.attention import ContextualAttention
from ipercore_tpu_torch.ops.morphology import dilate, erode
from ipercore_tpu_torch.ops.sampling import resize_image
from ipercore_tpu_torch.utils.checkpoint import (WEIGHTS_DIR, load_generator_params,
                                                 seeded_flat_params)

DEFAULT_WEIGHTS = os.path.join(WEIGHTS_DIR, "person_seg.npz")
GCA_WEIGHTS = os.path.join(WEIGHTS_DIR, "matting_gca.npz")
# seeded weights when no weight file is given (the JAX package inits from
# PRNGKey(0) and PRNGKey(1))
PERSON_SEG_SEED = 5
MATTING_SEED = 8
# The refiner runs in sub-batches whose estimated peak stays under this many
# bytes (`HumanMattor.refiner_sub_batch`): with the fused contextual attention
# the peak grows with the pixels, not with their square.
REFINER_BUDGET_BYTES = 8 * 2 ** 30
# Peak bytes per input pixel of one `GCAMattingRefiner` forward at published
# widths, f32, with margin: 1222 measured on an H100 at 512^2 (the slope of
# the peak between 2 and 4 frames a call; `chip_smoke.py` holds the estimate
# above the measurement). The full-resolution decoder level dominates: the
# skip, the upsampled features, their concat, a conv output and GroupNorm's
# temporaries, about 300 floats a pixel.
REFINER_BYTES_PER_PIXEL = 1536


def _read_trees(path: str):
    """The top-level trees of a weight file, f16 on disk -> f32, each a flat
    dict keyed `params/...` as the carrier takes it; None when the file does
    not exist."""
    if not os.path.exists(path):
        return None
    trees: dict[str, dict[str, np.ndarray]] = {}
    with np.load(path) as z:
        for k in z.files:
            top, _, rest = k.partition("/")
            trees.setdefault(top, {})[rest] = np.asarray(z[k], np.float32)
    return trees


def load_default_weights(path: str = None):
    """{"seg": flat, "mat": flat} trained parameters of a weight file (f16 on
    disk -> f32), each flat dict keyed `params/...` as the carrier takes it;
    None when the file does not exist."""
    return _read_trees(path or DEFAULT_WEIGHTS)


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


def _unet_down(blocks, x):
    skips = []
    for b in blocks[:-1]:
        x = b(x)
        skips.append(x)
        x = F.max_pool2d(x, 2, 2)
    return blocks[-1](x), skips


class MattingRefiner(nn.Module):
    """Trimap-guided alpha refiner: (N, H, W, 4 = RGB + trimap) -> alpha
    (N, H, W, 1) in (0, 1)."""

    def __init__(self, widths: tuple = (32, 64, 128)):
        super().__init__()
        self.widths = widths
        cin, blocks = 4, []
        for w in widths:
            blocks.append(ConvBlock(cin, w))
            cin = w
        for i, w in enumerate(reversed(widths[:-1])):
            self.add_module(f"ConvTranspose_{i}", nn.ConvTranspose2d(cin, w, 4, stride=2, padding=1))
            blocks.append(ConvBlock(2 * w, w))
            cin = w
        for i, b in enumerate(blocks):
            self.add_module(f"ConvBlock_{i}", b)
        self.Conv_0 = nn.Conv2d(cin, 1, 1)

    def forward(self, x):
        k = len(self.widths)
        x, skips = _unet_down([getattr(self, f"ConvBlock_{i}") for i in range(k)], x.permute(0, 3, 1, 2))
        for i, s in enumerate(reversed(skips)):
            x = getattr(self, f"ConvTranspose_{i}")(x)
            x = getattr(self, f"ConvBlock_{k + i}")(torch.cat([x, s], dim=1))
        return torch.sigmoid(self.Conv_0(x)).permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """Flax's `nn.GroupNorm` on NCHW: groups of consecutive channels,
    epsilon 1e-6 (torch's default is 1e-5), and Flax's one-pass variance
    E[x^2] - E[x]^2 clipped at 0; parameters `scale` and `bias`."""

    SEED_VALUES = {"scale": 1.0}

    def __init__(self, features: int, num_groups: int = 8, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        n, c, h, w = x.shape
        g = x.reshape(n, self.num_groups, -1)
        mean = g.mean(dim=-1, keepdim=True)
        var = torch.clamp((g * g).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(n, c, h, w)
        return y * self.scale[:, None, None] + self.bias[:, None, None]


class NormConvBlock(nn.Module):
    """conv3 - GroupNorm(8) - relu, twice (NCHW)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, 3, padding=1)
        self.GroupNorm_0 = GroupNorm(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1)
        self.GroupNorm_1 = GroupNorm(features)

    def forward(self, x):
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        return F.relu(self.GroupNorm_1(self.Conv_1(x)))


class GCAMattingRefiner(nn.Module):
    """Guided-contextual-attention alpha refiner: a GroupNorm'd UNet over
    (RGB + trimap) with contextual attention at the bottleneck, which
    rebuilds the features of the trimap's unknown band (resized to the
    bottleneck, > 0.25) from the certain pixels' patches. The net predicts
    alpha only in the unknown band: alpha = fg + unknown * sigmoid(logit)."""

    def __init__(self, widths: tuple = (32, 64, 128)):
        super().__init__()
        self.widths = widths
        cin, blocks = 4, []
        for w in widths:
            blocks.append(NormConvBlock(cin, w))
            cin = w
        blocks.append(NormConvBlock(cin, cin))  # after the attention
        self.gca = ContextualAttention()
        for i, w in enumerate(reversed(widths[:-1])):
            self.add_module(f"ConvTranspose_{i}", nn.ConvTranspose2d(cin, w, 4, stride=2, padding=1))
            blocks.append(NormConvBlock(2 * w, w))
            cin = w
        for i, b in enumerate(blocks):
            self.add_module(f"NormConvBlock_{i}", b)
        self.Conv_0 = nn.Conv2d(cin, 1, 1)

    def forward(self, x):
        """x: (N, H, W, 4) = RGB + trimap (0 bg / 0.5 unknown / 1 fg)."""
        trimap = x[..., 3:4]
        unknown = ((trimap > 0.25) & (trimap < 0.75)).to(x.dtype)
        fg = (trimap >= 0.75).to(x.dtype)
        k = len(self.widths)
        y, skips = _unet_down([getattr(self, f"NormConvBlock_{i}") for i in range(k)], x.permute(0, 3, 1, 2))
        u = (resize_image(unknown, y.shape[2], y.shape[3]) > 0.25).to(x.dtype)
        y = self.gca(y.permute(0, 2, 3, 1), u).permute(0, 3, 1, 2)
        y = getattr(self, f"NormConvBlock_{k}")(y)
        for i, s in enumerate(reversed(skips)):
            y = getattr(self, f"ConvTranspose_{i}")(y)
            y = getattr(self, f"NormConvBlock_{k + 1 + i}")(torch.cat([y, s], dim=1))
        pred = torch.sigmoid(self.Conv_0(y)).permute(0, 2, 3, 1)
        return fg + unknown * pred


def generate_trimap(mask: torch.Tensor, erode_ks: int = 11, dilate_ks: int = 21) -> torch.Tensor:
    """Binary person mask (N, H, W, 1), person = 1 -> trimap {0, 0.5, 1}."""
    fg = erode(mask, erode_ks)
    return fg + (dilate(mask, dilate_ks) - fg) * 0.5


class HumanMattor:
    """End-to-end person matting on the device.

    Weights as the JAX package picks them. `seg_params` / `mat_params` when
    given (flat, in the Flax layout). The refiner is a `GCAMattingRefiner`
    when `mat_params` are in its layout, or when they are None and
    `gca_weights_path` (default `assets/matting_gca.npz`) exists; else a
    `MattingRefiner`. (The JAX package builds a `MattingRefiner` for any
    given `mat_params`, and so cannot take GCA parameters.) With neither given: the
    `seg` and `mat` trees of `weights_path` (default `assets/person_seg.npz`)
    when it exists; then, for the GCA refiner, the `mat` tree of the GCA file
    and its `seg` tree if no segmenter was found. What is still missing is
    seeded: the segmenter with seed 5, the refiner with seed 8. `trained` is
    True when segmenter weights were given or found.
    """

    def __init__(self, seg_params=None, mat_params=None, weights_path: str = None,
                 gca_weights_path: str = None, device="cuda"):
        self.device = torch.device(device)
        self.seg = PersonSegUNet().eval()
        gca_path = gca_weights_path or GCA_WEIGHTS
        use_gca = (os.path.exists(gca_path) if mat_params is None
                   else any(k.startswith("params/NormConvBlock_") for k in mat_params))
        self.mat = (GCAMattingRefiner() if use_gca else MattingRefiner()).eval()
        if seg_params is None and mat_params is None:
            found = load_default_weights(weights_path)
            if found is not None:
                seg_params, mat_params = found.get("seg"), found.get("mat")
            if use_gca:
                gca = _read_trees(gca_path)
                if gca is not None and "mat" in gca:
                    mat_params = gca["mat"]
                    if "seg" in gca and seg_params is None:
                        seg_params = gca["seg"]
        self.trained = seg_params is not None
        if seg_params is None:
            seg_params = seeded_flat_params(self.seg, PERSON_SEG_SEED)
        if mat_params is None:
            mat_params = seeded_flat_params(self.mat, MATTING_SEED)
        load_generator_params(self.seg, seg_params)
        load_generator_params(self.mat, mat_params)
        self.seg.to(self.device)
        self.mat.to(self.device)
        self.seg_params, self.mat_params = seg_params, mat_params
        # per frame of the last `run`: the compactness gate and the band
        # choice (None where no fallback mask was given); and the frames of
        # the refiner's last call
        self.last_run: dict = {}

    def segment(self, images) -> torch.Tensor:
        """(N, H, W, 3) in [-1, 1] (numpy or tensor) -> (N, H, W, 1) logits
        on the device."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return self.seg(x)

    def refiner_sub_batch(self, h: int, w: int) -> int:
        """Frames per refiner call at h x w: the budget over the estimated
        peak of one frame, at least 1."""
        return max(1, int(REFINER_BUDGET_BYTES // (REFINER_BYTES_PER_PIXEL * h * w)))

    def run(self, images, fallback_mask=None, batch_size: int = 16):
        """images: (N, H, W, 3) in [-1, 1]; fallback_mask: (N, H, W, 1)
        person = 1 (the SMPL silhouette) or None.

        Returns numpy (alpha (N, H, W, 1) person opacity, mask (N, H, W, 1)).
        Runs in chunks of `batch_size` frames, the refiner in sub-batches of
        `refiner_sub_batch` frames; the result does not depend on either.
        """
        alphas, masks, compact, band = [], [], [], []
        sub = None
        for i in range(0, len(images), batch_size):
            fb = None if fallback_mask is None else fallback_mask[i:i + batch_size]
            a, m, c, b, sub = self._run_chunk(images[i:i + batch_size], fb)
            alphas.append(a)
            masks.append(m)
            compact += c
            band += b
        self.last_run = {"compact": compact, "use_band": band, "sub_batch": sub}
        return np.concatenate(alphas), np.concatenate(masks)

    def _run_chunk(self, images, fallback_mask):
        from ipercore_tpu_torch.tools.detection import mask_is_compact

        x = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=self.device)
        n = x.shape[0]
        compact = band = [None] * n
        with torch.inference_mode():
            if self.trained:
                mask = (torch.sigmoid(self.seg(x)) > 0.5).float()
                if fallback_mask is not None:
                    # the compactness gate: a segmenter that fires on scattered
                    # blobs loses the frame to the SMPL silhouette outright
                    sil = torch.as_tensor(np.asarray(fallback_mask), dtype=torch.float32, device=self.device)
                    m_np = (mask[..., 0] > 0.5).cpu().numpy()
                    compact = [bool(mask_is_compact(m)) for m in m_np]
                    c = torch.tensor(compact, dtype=torch.float32, device=self.device)[:, None, None, None]
                    mask = c * mask + (1 - c) * sil
                    # the band: inside the eroded silhouette is person, outside
                    # the dilated one background, the segmenter decides between,
                    # where the two agree (IoU > 0.5)
                    inter = (sil * mask).sum(dim=(1, 2, 3))
                    union = torch.maximum(sil, mask).sum(dim=(1, 2, 3))
                    use_band = (inter / torch.clamp(union, min=1.0) > 0.5)[:, None, None, None]
                    fg = erode(sil, 11)
                    banded = torch.clamp(fg + (dilate(sil, 31) - fg) * mask, 0.0, 1.0)
                    mask = torch.where(use_band, banded, mask)
                    band = use_band.flatten().tolist()
            elif fallback_mask is not None:
                mask = torch.as_tensor(np.asarray(fallback_mask), dtype=torch.float32, device=self.device)
            else:
                mask = torch.ones(x.shape[:3] + (1,), device=self.device)
            trimap = generate_trimap(mask)
            sub = None
            if self.trained:
                inp = torch.cat([x, trimap], dim=-1)
                sub = min(n, self.refiner_sub_batch(x.shape[1], x.shape[2]))
                alpha = torch.cat([self.mat(inp[i:i + sub]) for i in range(0, n, sub)])
                # trimap-certain regions are authoritative
                alpha = torch.where(trimap == 1.0, 1.0, torch.where(trimap == 0.0, 0.0, alpha))
            else:
                alpha = trimap  # the soft band around the geometric silhouette
        return alpha.cpu().numpy(), mask.cpu().numpy(), compact, band, sub


def build_mattor(name: str = "person_seg+refine", device="cuda", **kw):
    """"person_seg+refine" (a `HumanMattor`) or "schp" / "schp+gca" (the
    SCHP LIP-20 parser, `tools/parsers.SchpParser`, with `params=`)."""
    if name in ("schp", "schp+gca"):
        from ipercore_tpu_torch.tools.parsers import SchpParser

        return SchpParser(params=kw.get("params"), device=device)
    return HumanMattor(device=device, **kw)
