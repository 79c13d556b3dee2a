"""Generators: BGNet inpaintor + the Liquid-Warping generator family.

Twin of `ipercore_tpu/models/networks/generators.py`, all nine registry
names:

  * `LWBGenerator` with a fusion per stage: "spade" (AttLWB-SPADE, the
    default, and AttLWB-Front, which has no BGNet), "adain" (AttLWB-AdaIN),
    "add" / "avg" (AddLWB / AvgLWB), "softgate_add" / "softgate_avg"
    (SoftGateAddLWB / SoftGateAvgLWB); with and without temporal feedback,
    for inference (`forward_src` / `forward_tsf`) and for training
    (`forward` over nt time steps);
  * the baselines `InputConcatGenerator` (sources folded into channels next
    to the target input, one auto-encoder) and `TextureWarpingGenerator`
    (the UV-warped target input alone), which have no source stream and
    return (bg, tsf_imgs, tsf_masks) from `forward`.

Config mirrors the JAX package's:
{"BGNet": {...}, "SIDNet": {...}, "TSFNet": {...}} with num_filters / n_res_block.
"""
from __future__ import annotations

from typing import Mapping, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.models.networks.blocks import (
    FusedLWB,
    RegressHeads,
    ResAutoEncoder,
    ResidualBlock,
    ResidualBlockIN,
    SelfAttentionLWB,
    SkipDecoder,
    _conv,
    _deconv,
    conv_nhwc,
    instance_norm,
    warp,
)
from ipercore_tpu_torch.ops.sampling import grid_sample, resize_flow, resize_image


def _cfg_get(cfg, key: str, sub: str, default):
    block = cfg.get(key, {}) if isinstance(cfg, Mapping) else getattr(cfg, key, {})
    if isinstance(block, Mapping):
        return block.get(sub, default)
    return getattr(block, sub, default)


class ResNetInpaintor(nn.Module):
    """BGNet: masked-background inpainting. Input (N, H, W, 4) = masked RGB +
    mask; output (N, H, W, 3) in [-1, 1]."""

    def __init__(self, num_filters=(64, 128, 128, 256), n_res_block: int = 6):
        super().__init__()
        nf = tuple(num_filters)
        self.n_stage, self.n_res_block = len(nf), n_res_block
        self.Conv_0 = _conv(4, nf[0], 7)
        for i in range(1, len(nf)):
            self.add_module(f"Conv_{i}", _conv(nf[i - 1], nf[i], 3, 2))
        for i in range(n_res_block):
            self.add_module(f"ResidualBlockIN_{i}", ResidualBlockIN(nf[-1]))
        for k, i in enumerate(range(len(nf) - 1, 0, -1)):
            self.add_module(f"ConvTranspose_{k}", _deconv(nf[i], nf[i - 1], bias=False))
        self.add_module(f"Conv_{len(nf)}", _conv(nf[0], 3, 7, bias=False))

    def forward(self, x):
        for i in range(self.n_stage):
            x = F.relu(instance_norm(conv_nhwc(getattr(self, f"Conv_{i}"), x)))
        for i in range(self.n_res_block):
            x = getattr(self, f"ResidualBlockIN_{i}")(x)
        for k in range(self.n_stage - 1):
            x = F.relu(instance_norm(conv_nhwc(getattr(self, f"ConvTranspose_{k}"), x)))
        return torch.tanh(conv_nhwc(getattr(self, f"Conv_{self.n_stage}"), x))


def _forward_bg(bg_net: nn.Module, bg_inputs):
    """Inpaint background(s): (bs, ns, h, w, 4) -> (bs, ns, h, w, 3)."""
    bs, ns = bg_inputs.shape[0], bg_inputs.shape[1]
    out = bg_net(bg_inputs.reshape((bs * ns,) + tuple(bg_inputs.shape[2:])))
    return out.reshape((bs, ns) + tuple(out.shape[1:]))


def _bg_net(cfg) -> ResNetInpaintor:
    return ResNetInpaintor(num_filters=tuple(_cfg_get(cfg, "BGNet", "num_filters", (64, 128, 128, 256))),
                           n_res_block=int(_cfg_get(cfg, "BGNet", "n_res_block", 6)))


FUSION_MODES = ("spade", "adain", "add", "avg", "softgate_add", "softgate_avg")


class LWBGenerator(nn.Module):
    """The Liquid-Warping generator. `fusion_mode` selects the fusion of the
    warped source features into the transfer stream at every encoder and
    residual stage (`FUSION_MODES`); `use_bg_net=False` drops BGNet
    (AttLWB-Front: the background must then be given).

    `feat_warp_stride` > 1 warps LWB features on a coarser grid and upsamples
    back (active only where the feature map is at least 32 px after striding);
    1 is exact. `compute_dtype` lives in `models/imitator.synthesize_frames`.
    """

    def __init__(self, cfg, fusion_mode: str = "spade", use_bg_net: bool = True,
                 feat_warp_stride: int = 1, temporal: bool = False):
        super().__init__()
        if fusion_mode not in FUSION_MODES:
            raise ValueError(f"unknown fusion mode {fusion_mode!r}; have {FUSION_MODES}")
        self.feat_warp_stride = feat_warp_stride
        self.temporal = temporal
        self.use_bg_net = use_bg_net
        if use_bg_net:
            self.bg_net = _bg_net(cfg)
        sid_filters = tuple(_cfg_get(cfg, "SIDNet", "num_filters", (64, 128, 256)))
        sid_res = int(_cfg_get(cfg, "SIDNet", "n_res_block", 6))
        self.src_net = ResAutoEncoder(6, sid_filters, sid_res)

        tsf_filters = tuple(_cfg_get(cfg, "TSFNet", "num_filters", (64, 128, 256)))
        tsf_res = int(_cfg_get(cfg, "TSFNet", "n_res_block", 6))
        self.tsf_filters, self.tsf_res = tsf_filters, tsf_res
        cin = 6
        for i, nf in enumerate(tsf_filters):  # bias-free encoder stages
            self.add_module(f"tsf_enc_{i}", _conv(cin, nf, 3, 2, bias=False))
            cin = nf
        self.tsf_net_dec = SkipDecoder(tsf_filters, tuple(reversed(tsf_filters)))
        self.tsf_heads = RegressHeads(tsf_filters[0])
        for i in range(tsf_res):
            self.add_module(f"tsf_res_blocks_{i}", ResidualBlock(tsf_filters[-1]))

        def make_fusion(channel: int, src_channel: int) -> nn.Module:
            if fusion_mode in ("spade", "adain"):
                return SelfAttentionLWB(channel, src_channel, channel, mode=fusion_mode, temporal=temporal)
            if fusion_mode in ("add", "avg"):
                return FusedLWB(channel, fuse=fusion_mode)
            return FusedLWB(channel, fuse=fusion_mode.split("_")[1], soft_gate=True)

        for i, c in enumerate(tsf_filters):
            self.add_module(f"enc_fusion_{i}", make_fusion(c, sid_filters[i]))
        for i in range(tsf_res):
            self.add_module(f"res_fusion_{i}", make_fusion(tsf_filters[-1], sid_filters[-1]))

    # --- SIDNet -----------------------------------------------------------
    def forward_src(self, src_inputs, only_enc: bool = True):
        """Encode source identity features.

        Args:
            src_inputs: (bs, ns, h, w, 6) = morphed RGB + part condition map.

        Returns:
            src_enc_outs: list of (bs, ns, h_i, w_i, c_i);
            src_res_outs: list of (bs, ns, h_k, w_k, c_k);
            (+ img (bs, ns, h, w, 3), mask (bs, ns, h, w, 1) if only_enc=False)
        """
        bs, ns = src_inputs.shape[0], src_inputs.shape[1]
        flat = src_inputs.reshape((bs * ns,) + tuple(src_inputs.shape[2:]))
        enc_outs = self.src_net.encode(flat)
        res_outs = self.src_net.res_out(enc_outs[-1])
        unflat = lambda x: x.reshape((bs, ns) + tuple(x.shape[1:]))
        enc_u = [unflat(x) for x in enc_outs]
        res_u = [unflat(x) for x in res_outs]
        if only_enc:
            return enc_u, res_u
        bottleneck = res_outs[-1] if res_outs else enc_outs[-1]
        img, mask = self.src_net.regress(self.src_net.decode(bottleneck))
        return enc_u, res_u, unflat(img), unflat(mask)

    # --- BGNet --------------------------------------------------------------
    def forward_bg(self, bg_inputs):
        """Inpaint background(s): (bs, ns, h, w, 4) -> (bs, ns, h, w, 3).
        Without BGNet (AttLWB-Front) it raises AttributeError, as the JAX
        twin does."""
        return _forward_bg(self.bg_net, bg_inputs)

    # --- TSFNet (one time step) ----------------------------------------------
    def _prewarp(self, feats, flows):
        """Warp all sources' same-scale features in one sample call.
        feats: (bs, n, h, w, c); flows: (bs, n, H, W, 2)."""
        bs, n = feats.shape[0], feats.shape[1]
        flat = feats.reshape((bs * n,) + tuple(feats.shape[2:]))
        fl = flows.reshape((bs * n,) + tuple(flows.shape[2:]))
        h, w = flat.shape[1], flat.shape[2]
        s = self.feat_warp_stride
        if s > 1 and h % s == 0 and w % s == 0 and h // s >= 32:
            small = grid_sample(flat, resize_flow(fl, h // s, w // s))
            out = resize_image(small, h, w).to(flat.dtype)
        else:
            out = warp(flat, fl)
        return out.reshape((bs, n) + tuple(out.shape[1:]))

    def _prewarp_stages(self, enc_outs, res_outs, flows):
        """Pre-warp every encoder stage, and all residual stages in one call."""
        warped_enc = [self._prewarp(f, flows) for f in enc_outs]
        warped_res = []
        if res_outs:  # n_res_block can be 0
            res_cat = torch.cat(list(res_outs), dim=-1)
            warped_res = torch.chunk(self._prewarp(res_cat, flows), len(res_outs), dim=-1)
        return warped_enc, warped_res

    def forward_tsf(self, tsf_inputs, src_enc_outs, src_res_outs, Tst,
                    temp_enc_outs=None, temp_res_outs=None, Ttt=None):
        """One TSF step.

        Args:
            tsf_inputs: (bs, h, w, 6) warped-UV image + target condition map.
            src_enc_outs / src_res_outs: SIDNet stages, each (bs, ns, h_i, w_i, c_i).
            Tst: (bs, ns, H, W, 2) source -> target flows.
            temp_enc_outs / temp_res_outs: optional SIDNet stages of the
                previous predictions, each (bs, nt, h_i, w_i, c_i);
            Ttt: optional (bs, nt, H, W, 2) previous -> current flows. The
                temporal features are used when both are given (and the
                generator is temporal).

        Returns:
            tsf_img (bs, h, w, 3), tsf_mask (bs, h, w, 1).
        """
        warped_enc, warped_res = self._prewarp_stages(src_enc_outs, src_res_outs, Tst)
        use_temp = temp_enc_outs is not None and Ttt is not None
        if use_temp:
            temp_enc, temp_res = self._prewarp_stages(temp_enc_outs, temp_res_outs, Ttt)

        x = tsf_inputs
        enc_outs = []
        for i in range(len(self.tsf_filters)):
            x = F.relu(conv_nhwc(getattr(self, f"tsf_enc_{i}"), x))
            x = getattr(self, f"enc_fusion_{i}")(
                x, warped_enc[i], Tst, temp_x=temp_enc[i] if use_temp else None, Ttt=Ttt,
                pre_warped=True)
            enc_outs.append(x)
        for i in range(self.tsf_res):
            x = getattr(self, f"tsf_res_blocks_{i}")(x)
            x = getattr(self, f"res_fusion_{i}")(
                x, warped_res[i], Tst, temp_x=temp_res[i] if use_temp else None, Ttt=Ttt,
                pre_warped=True)
        x = self.tsf_net_dec(x, enc_outs)
        return self.tsf_heads(x)

    # --- full training-style forward ------------------------------------------
    def forward(self, bg_inputs, src_inputs, tsf_inputs, Tst, Ttt=None, only_tsf: bool = True):
        """Full forward over nt time steps.

        Args:
            bg_inputs: (bs, nbg, h, w, 4), or None (then, and without BGNet,
                bg_img is None).
            src_inputs: (bs, ns, h, w, 6).
            tsf_inputs: (bs, nt, h, w, 6).
            Tst: (bs, nt, ns, h, w, 2); Ttt: (bs, nt - 1, h, w, 2) or None.
                A temporal generator feeds step t the SIDNet features of its
                prediction at t - 1, warped by Ttt[:, t - 1].

        Returns:
            (bg_img (bs, nbg, h, w, 3), tsf_imgs (bs, nt, h, w, 3),
            tsf_masks (bs, nt, h, w, 1)); with only_tsf=False
            (bg_img, src_imgs, src_masks, tsf_imgs, tsf_masks), the source
            reconstructions (bs, ns, h, w, 3) and (bs, ns, h, w, 1) included.
        """
        nt = tsf_inputs.shape[1]
        bg_img = self.forward_bg(bg_inputs) if self.use_bg_net and bg_inputs is not None else None
        if only_tsf:
            src_enc_outs, src_res_outs = self.forward_src(src_inputs, only_enc=True)
        else:
            src_enc_outs, src_res_outs, src_imgs, src_masks = self.forward_src(src_inputs, only_enc=False)

        tsf_imgs, tsf_masks = [], []
        for t in range(nt):
            temp_enc_outs = temp_res_outs = t_Ttt = None
            if t != 0 and self.temporal and Ttt is not None:
                prev_img = tsf_imgs[-1] * (1.0 - tsf_masks[-1])
                prev_in = torch.cat([prev_img, tsf_inputs[:, t - 1, ..., 0:3]], dim=-1)[:, None]
                temp_enc_outs, temp_res_outs = self.forward_src(prev_in, only_enc=True)
                t_Ttt = Ttt[:, t - 1:t]
            img, mask = self.forward_tsf(tsf_inputs[:, t], src_enc_outs, src_res_outs, Tst[:, t],
                                         temp_enc_outs, temp_res_outs, t_Ttt)
            tsf_imgs.append(img)
            tsf_masks.append(mask)
        tsf_imgs = torch.stack(tsf_imgs, dim=1)
        tsf_masks = torch.stack(tsf_masks, dim=1)
        if only_tsf:
            return bg_img, tsf_imgs, tsf_masks
        return bg_img, src_imgs, src_masks, tsf_imgs, tsf_masks


class _Baseline(nn.Module):
    """The baselines' common part: BGNet and one `ResAutoEncoder` (`net`) run
    on each time step's input."""

    def __init__(self, cfg, cin: int):
        super().__init__()
        tsf_filters = tuple(_cfg_get(cfg, "TSFNet", "num_filters", (64, 128, 256)))
        tsf_res = int(_cfg_get(cfg, "TSFNet", "n_res_block", 6))
        self.net = ResAutoEncoder(cin, tsf_filters, tsf_res)
        self.bg_net = _bg_net(cfg)

    def forward_bg(self, bg_inputs):
        """Inpaint background(s): (bs, ns, h, w, 4) -> (bs, ns, h, w, 3)."""
        return _forward_bg(self.bg_net, bg_inputs)

    def _step_input(self, src_inputs, tsf_t):
        raise NotImplementedError

    def forward(self, bg_inputs, src_inputs, tsf_inputs, Tst=None, Ttt=None, only_tsf: bool = True):
        """bg_inputs (bs, nbg, h, w, 4) or None; src_inputs (bs, ns, h, w, 6);
        tsf_inputs (bs, nt, h, w, 6); Tst, Ttt and only_tsf are not used.

        Returns (bg_img or None, tsf_imgs (bs, nt, h, w, 3), tsf_masks
        (bs, nt, h, w, 1)): a baseline has no source reconstruction."""
        bg_img = self.forward_bg(bg_inputs) if bg_inputs is not None else None
        imgs, masks = [], []
        for t in range(tsf_inputs.shape[1]):
            img, mask = self.net(self._step_input(src_inputs, tsf_inputs[:, t]))
            imgs.append(img)
            masks.append(mask)
        return bg_img, torch.stack(imgs, 1), torch.stack(masks, 1)


class InputConcatGenerator(_Baseline):
    """Baseline without warping: the sources folded into channels (source
    major) next to each step's target input, one auto-encoder of
    `num_source * 6 + 6` input channels."""

    def __init__(self, cfg, num_source: int = 2):
        super().__init__(cfg, num_source * 6 + 6)

    def _step_input(self, src_inputs, tsf_t):
        bs, ns, h, w, c = src_inputs.shape
        src_cat = src_inputs.permute(0, 2, 3, 1, 4).reshape(bs, h, w, ns * c)
        return torch.cat([src_cat, tsf_t], dim=-1)


class TextureWarpingGenerator(_Baseline):
    """Baseline of UV-texture warping alone: the auto-encoder sees each step's
    target input (the warped UV image and the target condition), no feature
    warping."""

    def __init__(self, cfg):
        super().__init__(cfg, 6)

    def _step_input(self, src_inputs, tsf_t):
        return tsf_t


# the LWB family's names and their constructor arguments
LWB_GENERATORS = {
    "AttLWB-SPADE": dict(fusion_mode="spade", use_bg_net=True),
    "AttLWB-Front": dict(fusion_mode="spade", use_bg_net=False),
    "AttLWB-AdaIN": dict(fusion_mode="adain", use_bg_net=True),
    "AddLWB": dict(fusion_mode="add", use_bg_net=True),
    "AvgLWB": dict(fusion_mode="avg", use_bg_net=True),
    "SoftGateAddLWB": dict(fusion_mode="softgate_add", use_bg_net=True),
    "SoftGateAvgLWB": dict(fusion_mode="softgate_avg", use_bg_net=True),
}
GENERATOR_NAMES = tuple(LWB_GENERATORS) + ("InputConcat", "TextureWarping")


def build_generator(name: str, cfg, temporal: bool = False, feat_warp_stride: int = 1,
                    num_source: int = 2, device: Union[str, torch.device] = "cuda") -> nn.Module:
    """Build a generator of `GENERATOR_NAMES` in eval mode on `device`.
    `temporal` adds the feedback of previous predictions (no new weights) and
    `feat_warp_stride` the strided feature warp, both for the LWB family;
    `num_source` sets InputConcat's input channels (Flax infers them from the
    first call)."""
    if name not in GENERATOR_NAMES:
        raise KeyError(f"unknown generator {name!r}; have {sorted(GENERATOR_NAMES)}")
    if name == "InputConcat":
        gen = InputConcatGenerator(cfg, num_source=num_source)
    elif name == "TextureWarping":
        gen = TextureWarpingGenerator(cfg)
    else:
        gen = LWBGenerator(cfg, feat_warp_stride=feat_warp_stride, temporal=temporal,
                           **LWB_GENERATORS[name])
    return gen.to(device).eval()
