"""Shared network building blocks (torch.nn, NHWC at every call).

Twin of `ipercore_tpu/models/networks/blocks.py`: the blocks of every
Liquid-Warping generator (attention LWB with SPADE or AdaIN, the add / avg
and soft-gated fusions, the auto-encoder of the baselines). Every module
takes and returns NHWC tensors like its Flax counterpart and permutes to NCHW
only around its convolutions. Submodules
carry the Flax auto-names (`Conv_0`, `ConvTranspose_1`, `SPADE_0`, ...), so a
flat Flax checkpoint key `params/a/b/kernel` maps to the state-dict key
`a.b.weight` with no table (`utils/checkpoint.flax_params_to_torch`).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.ops.sampling import grid_sample, resize_flow
from ipercore_tpu_torch.ops.spade_conv_cuda import pack_conv3x3, spade_conv_relu, spade_modulate


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW convolution module to an NHWC tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


def _deconv(cin: int, cout: int, bias: bool = True) -> nn.ConvTranspose2d:
    """Flax `ConvTranspose((4, 4), strides=(2, 2), padding="SAME")`."""
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1, bias=bias)


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm over the last axis (NHWC), holding torch's
    parameter set (scale, bias, running mean and variance) as parameters
    under the Flax names, so a converted checkpoint carries over by name."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def forward(self, x):
        return (x - self.mean) * (self.scale * torch.rsqrt(self.var + self.eps)) + self.bias


def frozen_bn_nchw(bn: FrozenBatchNorm, x: torch.Tensor) -> torch.Tensor:
    """`FrozenBatchNorm` (its parameters and epsilon) on an NCHW tensor."""
    c = lambda p: p[:, None, None]
    return (x - c(bn.mean)) * c(bn.scale * torch.rsqrt(bn.var + bn.eps)) + c(bn.bias)


def instance_norm_stats(x: torch.Tensor, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and reciprocal standard deviation (biased variance) of NHWC `x`
    over its spatial dims, each (N, 1, 1, C)."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return mean, torch.rsqrt(var + eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free instance norm over the spatial dims of NHWC (biased
    variance, as `InstanceNorm2d(affine=False)`)."""
    mean, rstd = instance_norm_stats(x, eps)
    return (x - mean) * rstd


class ConvIN(nn.Module):
    """Conv + optional instance norm + ReLU."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 use_bias: bool = True, norm: bool = True, act: bool = True):
        super().__init__()
        self.Conv_0 = _conv(cin, features, kernel, stride, use_bias)
        self.norm, self.act = norm, act

    def forward(self, x):
        x = conv_nhwc(self.Conv_0, x)
        if self.norm:
            x = instance_norm(x)
        return F.relu(x) if self.act else x


class ResidualBlock(nn.Module):
    """conv3-relu-conv3 residual (no norm)."""

    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = _conv(features, features, 3)
        self.Conv_1 = _conv(features, features, 3)

    def forward(self, x):
        h = F.relu(conv_nhwc(self.Conv_0, x))
        return x + conv_nhwc(self.Conv_1, h)


class ResidualBlockIN(nn.Module):
    """conv3-IN-relu-conv3-IN residual (BGNet variant)."""

    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = _conv(features, features, 3)
        self.Conv_1 = _conv(features, features, 3)

    def forward(self, x):
        h = F.relu(instance_norm(conv_nhwc(self.Conv_0, x)))
        return x + instance_norm(conv_nhwc(self.Conv_1, h))


class Encoder(nn.Module):
    """Stride-2 conv stack; returns per-stage features."""

    def __init__(self, cin: int, num_filters: Sequence[int], use_bias: bool = True):
        super().__init__()
        self.n = len(num_filters)
        for i, nf in enumerate(num_filters):
            self.add_module(f"Conv_{i}", _conv(cin, nf, 3, 2, use_bias))
            cin = nf

    def forward(self, x, get_details: bool = True):
        outs = []
        for i in range(self.n):
            x = F.relu(conv_nhwc(getattr(self, f"Conv_{i}"), x))
            outs.append(x)
        return outs if get_details else x


class Decoder(nn.Module):
    """ConvTranspose-up stack."""

    def __init__(self, cin: int, num_filters: Sequence[int]):
        super().__init__()
        self.n = len(num_filters)
        for i, nf in enumerate(num_filters):
            self.add_module(f"ConvTranspose_{i}", _deconv(cin, nf))
            cin = nf

    def forward(self, x):
        for i in range(self.n):
            x = F.relu(conv_nhwc(getattr(self, f"ConvTranspose_{i}"), x))
        return x


class SkipDecoder(nn.Module):
    """Up-convs with encoder skip concat + conv."""

    def __init__(self, enc_num_filters: Sequence[int], dec_num_filters: Sequence[int]):
        super().__init__()
        self.n = n = len(dec_num_filters)
        cin = enc_num_filters[-1]
        for i, nf in enumerate(dec_num_filters):
            self.add_module(f"ConvTranspose_{i}", _deconv(cin, nf))
            if i != n - 1:
                self.add_module(f"Conv_{i}", _conv(enc_num_filters[n - 2 - i] + nf, nf, 3))
            cin = nf

    def forward(self, x, enc_outs):
        n = self.n
        for i in range(n):
            x = F.relu(conv_nhwc(getattr(self, f"ConvTranspose_{i}"), x))
            if i != n - 1:
                skip = torch.cat([enc_outs[n - 2 - i], x], dim=-1)
                x = F.relu(conv_nhwc(getattr(self, f"Conv_{i}"), skip))
        return x


class RegressHeads(nn.Module):
    """img (tanh) + attention mask (sigmoid) heads."""

    def __init__(self, cin: int):
        super().__init__()
        self.Conv_0 = _conv(cin, 3, 5, bias=False)
        self.Conv_1 = _conv(cin, 1, 5, bias=False)

    def forward(self, x):
        return (torch.tanh(conv_nhwc(self.Conv_0, x)),
                torch.sigmoid(conv_nhwc(self.Conv_1, x)))


class ResAutoEncoder(nn.Module):
    """SIDNet body: encoder + res blocks + decoder + heads."""

    def __init__(self, cin: int, num_filters: Sequence[int], n_res_block: int):
        super().__init__()
        self.n_res_block = n_res_block
        self.encoders = Encoder(cin, num_filters, use_bias=True)
        for i in range(n_res_block):
            self.add_module(f"res_blocks_{i}", ResidualBlock(num_filters[-1]))
        self.decoders = Decoder(num_filters[-1], tuple(reversed(num_filters)))
        self.heads = RegressHeads(num_filters[0])

    def encode(self, x):
        return self.encoders(x, get_details=True)

    def res_out(self, x):
        outs = []
        for i in range(self.n_res_block):
            x = getattr(self, f"res_blocks_{i}")(x)
            outs.append(x)
        return outs

    def decode(self, x):
        return self.decoders(x)

    def regress(self, x):
        return self.heads(x)

    def forward(self, x):
        enc = self.encoders(x, get_details=False)
        for i in range(self.n_res_block):
            enc = getattr(self, f"res_blocks_{i}")(enc)
        return self.heads(self.decoders(enc))


class SPADE(nn.Module):
    """Spatially-adaptive denorm conditioned on the attention-fused feature
    (instance norm, 3x3 convs, nhidden = 128).

    Where no autograd graph is recorded and both inputs are float32, the
    three convolutions run on K5 (`ops/spade_conv_cuda`: the kernel on a CUDA
    tensor, its plain version on a CPU one), with the modulation in its
    epilogue; training and the autocast (bf16) path keep the `nn.Conv2d`
    path."""

    def __init__(self, norm_nc: int, cond_nc: int, nhidden: int = 128):
        super().__init__()
        self.Conv_0 = _conv(cond_nc, nhidden, 3)
        self.Conv_1 = _conv(nhidden, norm_nc, 3)
        self.Conv_2 = _conv(nhidden, norm_nc, 3)

    def packed_weights(self):
        """((wp0, b0), (wp12, b12)): `Conv_0`, and `Conv_1` / `Conv_2` with
        interleaved (gamma, beta) columns, packed by `pack_conv3x3`."""
        return (pack_conv3x3((self.Conv_0.weight,), (self.Conv_0.bias,)),
                pack_conv3x3((self.Conv_1.weight, self.Conv_2.weight), (self.Conv_1.bias, self.Conv_2.bias)))

    def forward(self, x, condmap):
        if not torch.is_grad_enabled() and x.dtype == condmap.dtype == torch.float32:
            (wp0, b0), (wp12, b12) = self.packed_weights()
            mean, rstd = instance_norm_stats(x)
            return spade_modulate(spade_conv_relu(condmap, wp0, b0), wp12, b12, x, mean, rstd)
        normalized = instance_norm(x)
        actv = F.relu(conv_nhwc(self.Conv_0, condmap))
        gamma = conv_nhwc(self.Conv_1, actv)
        beta = conv_nhwc(self.Conv_2, actv)
        return normalized * (1.0 + gamma) + beta


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """LWB warp: bilinear-sample features (N, H, W, C) through a flow grid
    (N, Hf, Wf, 2), resizing the flow to the feature resolution first."""
    flow = resize_flow(flow, x.shape[1], x.shape[2])
    return grid_sample(x, flow)


def attention_fuse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Pixel-wise softmax attention over the source axis.
    q: (N, H, W, C); k, v: (N, S, H, W, C) -> (N, H, W, C)."""
    dk = k.shape[-1]
    logits = torch.einsum("nshwc,nhwc->nshw", k, q) / (dk ** 0.5)
    alpha = torch.softmax(logits, dim=1)
    return torch.einsum("nshw,nshwc->nhwc", alpha, v)


def adain(content: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
          eps: float = 1e-5) -> torch.Tensor:
    """AdaIN with per-pixel channel statistics: `content` (NHWC) normalized by
    its channel mean and std (unbiased, ddof = 1) and re-styled by (gamma,
    beta)."""
    mean = content.mean(dim=-1, keepdim=True)
    std = content.std(dim=-1, keepdim=True, unbiased=True)
    return (content - mean) / (std + eps) * gamma + beta


def _warped(x, flow, pre_warped: bool, h: int, w: int):
    """(bs, n, H', W', c) features -> (bs * n, h, w, c), warped by `flow`
    (bs, n, H, W, 2) unless `pre_warped`."""
    bs, n = x.shape[0], x.shape[1]
    if pre_warped:
        return x.reshape((bs * n, h, w) + tuple(x.shape[4:]))
    return warp(x.reshape((bs * n,) + tuple(x.shape[2:])),
                flow.reshape((bs * n,) + tuple(flow.shape[2:])))


class SelfAttentionLWB(nn.Module):
    """Attention-fuse (pre-)warped source features and modulate the transfer
    stream: by SPADE conditioned on the fused feature (mode="spade"), or by
    AdaIN with the fused feature's channel std (ddof = 1) and mean as gamma
    and beta (mode="adain", no weights besides fq / fk / fv). With
    `temporal`, warped features of previous predictions join the sources as
    extra keys and values through the same `fk` / `fv` convolutions, so a
    temporal block has no weights of its own."""

    def __init__(self, channel: int, src_channel: int, tsf_channel: int, mode: str = "spade",
                 temporal: bool = False):
        super().__init__()
        if mode not in ("spade", "adain"):
            raise ValueError(f"unknown SelfAttentionLWB mode {mode}")
        self.channel, self.mode = channel, mode
        self.temporal = temporal
        self.fk = _conv(src_channel, channel, 1)
        self.fv = _conv(src_channel, channel, 1)
        self.fq = _conv(tsf_channel, channel, 1)
        if mode == "spade":
            self.SPADE_0 = SPADE(norm_nc=tsf_channel, cond_nc=channel)

    def forward(self, tsf_x, src_x, Tst=None, temp_x=None, Ttt=None, pre_warped: bool = False):
        """
        Args:
            tsf_x: (bs, h, w, c1) transfer-stream feature.
            src_x: (bs, ns, H', W', c2) per-source features, already warped to
                the target pose when pre_warped=True.
            Tst: (bs, ns, H, W, 2) flows (ignored when pre_warped).
            temp_x: optional (bs, nt, H', W', c2) temporal features, used only
                by a temporal block and only together with Ttt.
            Ttt: optional (bs, nt, H, W, 2).

        Returns:
            (bs, h, w, c1) modulated feature.
        """
        bs, ns = src_x.shape[0], src_x.shape[1]
        h, w = tsf_x.shape[1], tsf_x.shape[2]
        src_warp = _warped(src_x, Tst, pre_warped, h, w)
        K = [conv_nhwc(self.fk, src_warp).reshape(bs, ns, h, w, self.channel)]
        V = [conv_nhwc(self.fv, src_warp).reshape(bs, ns, h, w, self.channel)]
        if self.temporal and temp_x is not None and Ttt is not None:
            nt = temp_x.shape[1]
            temp_warp = _warped(temp_x, Ttt, pre_warped, h, w)
            K.append(conv_nhwc(self.fk, temp_warp).reshape(bs, nt, h, w, self.channel))
            V.append(conv_nhwc(self.fv, temp_warp).reshape(bs, nt, h, w, self.channel))
        q = conv_nhwc(self.fq, tsf_x)
        x = attention_fuse(q, torch.cat(K, dim=1), torch.cat(V, dim=1))
        if self.mode == "spade":
            return self.SPADE_0(tsf_x, x)
        return adain(tsf_x, x.std(dim=-1, keepdim=True, unbiased=True), x.mean(dim=-1, keepdim=True))


class FusedLWB(nn.Module):
    """The non-attention LWB fusions. `fuse` "add" / "avg": the sum / mean of
    the transfer feature and the warped sources. `soft_gate`: the transfer
    feature plus sigmoid(conv3(relu(conv3(tsf)))) times the sum / mean of the
    warped sources (`Conv_0`, `Conv_1`: c -> c). Temporal features are not
    used."""

    def __init__(self, channel: int, fuse: str = "add", soft_gate: bool = False):
        super().__init__()
        if fuse not in ("add", "avg"):
            raise ValueError(f"unknown FusedLWB fuse {fuse}")
        self.fuse, self.soft_gate = fuse, soft_gate
        if soft_gate:
            self.Conv_0 = _conv(channel, channel, 3)
            self.Conv_1 = _conv(channel, channel, 3)

    def forward(self, tsf_x, src_x, Tst=None, temp_x=None, Ttt=None, pre_warped: bool = False):
        """tsf_x (bs, h, w, c); src_x (bs, ns, H', W', c), warped by Tst
        (bs, ns, H, W, 2) unless pre_warped. Returns (bs, h, w, c)."""
        bs, ns = src_x.shape[0], src_x.shape[1]
        h, w = tsf_x.shape[1], tsf_x.shape[2]
        src_warp = src_x if pre_warped else _warped(src_x, Tst, False, h, w).reshape(bs, ns, h, w, -1)
        if self.soft_gate:
            fused = src_warp.sum(dim=1) if self.fuse == "add" else src_warp.mean(dim=1)
            g = conv_nhwc(self.Conv_1, F.relu(conv_nhwc(self.Conv_0, tsf_x)))
            return tsf_x + torch.sigmoid(g) * fused
        stacked = torch.cat([tsf_x[:, None], src_warp], dim=1)
        return stacked.sum(dim=1) if self.fuse == "add" else stacked.mean(dim=1)
