"""Generators: BGNet inpaintor + the Liquid-Warping generator (AttLWB-SPADE).

Twin of `ipercore_tpu/models/networks/generators.py`. Only the default
generator of the repo, AttLWB-SPADE, is ported, with and without temporal
feedback, for inference (`forward_src` / `forward_tsf`) and for training
(`forward` over nt time steps); the other registry names raise
`NotImplementedError` naming the later slice.

Config mirrors the JAX package's:
{"BGNet": {...}, "SIDNet": {...}, "TSFNet": {...}} with num_filters / n_res_block.
"""
from __future__ import annotations

from typing import Mapping, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.models.networks.blocks import (
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


class LWBGenerator(nn.Module):
    """The Liquid-Warping generator with SPADE attention fusion.

    `feat_warp_stride` > 1 warps LWB features on a coarser grid and upsamples
    back (active only where the feature map is at least 32 px after striding);
    1 is exact. `compute_dtype` lives in `models/imitator.synthesize_frames`.
    """

    def __init__(self, cfg, fusion_mode: str = "spade", use_bg_net: bool = True,
                 feat_warp_stride: int = 1, temporal: bool = False):
        super().__init__()
        if fusion_mode != "spade":
            raise NotImplementedError(
                f"fusion mode {fusion_mode!r} belongs to a later slice of the port")
        self.feat_warp_stride = feat_warp_stride
        self.temporal = temporal
        self.use_bg_net = use_bg_net
        if use_bg_net:
            self.bg_net = ResNetInpaintor(
                num_filters=tuple(_cfg_get(cfg, "BGNet", "num_filters", (64, 128, 128, 256))),
                n_res_block=int(_cfg_get(cfg, "BGNet", "n_res_block", 6)))
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
        for i, c in enumerate(tsf_filters):
            self.add_module(f"enc_fusion_{i}",
                            SelfAttentionLWB(c, sid_filters[i], c, temporal=temporal))
        for i in range(tsf_res):
            self.add_module(f"res_fusion_{i}", SelfAttentionLWB(
                tsf_filters[-1], sid_filters[-1], tsf_filters[-1], temporal=temporal))

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
        """Inpaint background(s): (bs, ns, h, w, 4) -> (bs, ns, h, w, 3)."""
        bs, ns = bg_inputs.shape[0], bg_inputs.shape[1]
        flat = bg_inputs.reshape((bs * ns,) + tuple(bg_inputs.shape[2:]))
        out = self.bg_net(flat)
        return out.reshape((bs, ns) + tuple(out.shape[1:]))

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
            bg_inputs: (bs, nbg, h, w, 4).
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


GENERATOR_NAMES = (
    "AttLWB-SPADE", "AttLWB-Front", "AttLWB-AdaIN", "AddLWB", "AvgLWB",
    "SoftGateAddLWB", "SoftGateAvgLWB", "InputConcat", "TextureWarping",
)


def build_generator(name: str, cfg, temporal: bool = False, feat_warp_stride: int = 1,
                    device: Union[str, torch.device] = "cuda") -> nn.Module:
    """Build a generator in eval mode on `device`. Only "AttLWB-SPADE" is
    ported; `temporal` adds the feedback of previous predictions (no new
    weights)."""
    if name not in GENERATOR_NAMES:
        raise KeyError(f"unknown generator {name!r}; have {sorted(GENERATOR_NAMES)}")
    if name != "AttLWB-SPADE":
        raise NotImplementedError(
            f"generator {name!r} is not ported yet: the rest of the generator zoo "
            "belongs to the slice after temporal mode, viewer and swapper")
    gen = LWBGenerator(cfg, fusion_mode="spade", use_bg_net=True,
                       feat_warp_stride=feat_warp_stride, temporal=temporal)
    return gen.to(device).eval()
