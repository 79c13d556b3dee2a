"""The Liquid Warping generators in plain PyTorch (NHWC at every call).

Liu et al., "Liquid Warping GAN with Attention", TPAMI 2021 (arXiv
2011.09055), and the Liquid Warping Block of ICCV 2019 (arXiv 1909.12224), as
iPERCore v0.2.0 configures them: BGNet inpaints the background, SIDNet encodes
the source views, TSFNet renders the target and fuses the warped source
features at each of its encoder stages and residual blocks. AttLWB-SPADE
fuses by attention over the sources followed by SPADE; AddLWB adds the warped
features to the transfer stream. The module and parameter names are those of
the port's state dicts, so one state dict loads into both.

Departure: the warps of the source features call
`torch.nn.functional.grid_sample` directly.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _conv(cin, cout, k, stride=1, bias=True):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


def _deconv(cin, cout, bias=True):
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1, bias=bias)


def instance_norm(x, eps=1e-5):
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def grid_sample(imgs: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """Bilinear, zero-padded, align_corners=False: (N, H, W, C) at (N, h, w, 2)."""
    out = F.grid_sample(imgs.permute(0, 3, 1, 2), grids.to(imgs.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1)


def resize_flow(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Linear, antialiased resize of a flow grid (..., H, W, 2) to (..., h, w, 2)."""
    if flow.shape[-3] == h and flow.shape[-2] == w:
        return flow
    lead = flow.shape[:-3]
    x = flow.reshape((-1,) + flow.shape[-3:]).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).reshape(lead + (h, w, flow.shape[-1]))


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    return grid_sample(x, resize_flow(flow, x.shape[1], x.shape[2]))


class Residual(nn.Module):
    def __init__(self, c, norm=False):
        super().__init__()
        self.Conv_0, self.Conv_1, self.norm = _conv(c, c, 3), _conv(c, c, 3), norm

    def forward(self, x):
        n = instance_norm if self.norm else (lambda t: t)
        return x + n(conv(self.Conv_1, F.relu(n(conv(self.Conv_0, x)))))


class BGNet(nn.Module):
    def __init__(self, nf, n_res):
        super().__init__()
        self.n_stage, self.n_res = len(nf), n_res
        self.Conv_0 = _conv(4, nf[0], 7)
        for i in range(1, len(nf)):
            self.add_module(f"Conv_{i}", _conv(nf[i - 1], nf[i], 3, 2))
        for i in range(n_res):
            self.add_module(f"ResidualBlockIN_{i}", Residual(nf[-1], norm=True))
        for k, i in enumerate(range(len(nf) - 1, 0, -1)):
            self.add_module(f"ConvTranspose_{k}", _deconv(nf[i], nf[i - 1], bias=False))
        self.add_module(f"Conv_{len(nf)}", _conv(nf[0], 3, 7, bias=False))

    def forward(self, x):
        for i in range(self.n_stage):
            x = F.relu(instance_norm(conv(getattr(self, f"Conv_{i}"), x)))
        for i in range(self.n_res):
            x = getattr(self, f"ResidualBlockIN_{i}")(x)
        for k in range(self.n_stage - 1):
            x = F.relu(instance_norm(conv(getattr(self, f"ConvTranspose_{k}"), x)))
        return torch.tanh(conv(getattr(self, f"Conv_{self.n_stage}"), x))


class Stack(nn.Module):
    """`Conv_i` stride-2 encoder or `ConvTranspose_i` decoder, ReLU after each."""

    def __init__(self, cin, nf, up):
        super().__init__()
        self.names = []
        for i, c in enumerate(nf):
            name = f"ConvTranspose_{i}" if up else f"Conv_{i}"
            self.add_module(name, _deconv(cin, c) if up else _conv(cin, c, 3, 2))
            self.names.append(name)
            cin = c

    def forward(self, x):
        outs = []
        for name in self.names:
            x = F.relu(conv(getattr(self, name), x))
            outs.append(x)
        return outs


class Heads(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.Conv_0, self.Conv_1 = _conv(cin, 3, 5, bias=False), _conv(cin, 1, 5, bias=False)

    def forward(self, x):
        return torch.tanh(conv(self.Conv_0, x)), torch.sigmoid(conv(self.Conv_1, x))


class SIDNet(nn.Module):
    def __init__(self, cin, nf, n_res):
        super().__init__()
        self.n_res = n_res
        self.encoders = Stack(cin, nf, up=False)
        for i in range(n_res):
            self.add_module(f"res_blocks_{i}", Residual(nf[-1]))
        self.decoders = Stack(nf[-1], tuple(reversed(nf)), up=True)
        self.heads = Heads(nf[0])


class SkipDecoder(nn.Module):
    def __init__(self, enc, dec):
        super().__init__()
        self.n = n = len(dec)
        cin = enc[-1]
        for i, c in enumerate(dec):
            self.add_module(f"ConvTranspose_{i}", _deconv(cin, c))
            if i != n - 1:
                self.add_module(f"Conv_{i}", _conv(enc[n - 2 - i] + c, c, 3))
            cin = c

    def forward(self, x, enc_outs):
        n = self.n
        for i in range(n):
            x = F.relu(conv(getattr(self, f"ConvTranspose_{i}"), x))
            if i != n - 1:
                x = F.relu(conv(getattr(self, f"Conv_{i}"), torch.cat([enc_outs[n - 2 - i], x], dim=-1)))
        return x


class SPADE(nn.Module):
    def __init__(self, norm_nc, cond_nc, nhidden=128):
        super().__init__()
        self.Conv_0 = _conv(cond_nc, nhidden, 3)
        self.Conv_1 = _conv(nhidden, norm_nc, 3)
        self.Conv_2 = _conv(nhidden, norm_nc, 3)

    def forward(self, x, cond):
        a = F.relu(conv(self.Conv_0, cond))
        return instance_norm(x) * (1.0 + conv(self.Conv_1, a)) + conv(self.Conv_2, a)


class AttentionLWB(nn.Module):
    """Attention over the warped sources, pixel by pixel, then SPADE."""

    def __init__(self, c, src_c):
        super().__init__()
        self.c = c
        self.fk, self.fv, self.fq = _conv(src_c, c, 1), _conv(src_c, c, 1), _conv(c, c, 1)
        self.SPADE_0 = SPADE(c, c)

    def forward(self, x, src):  # x (bs, h, w, c); src (bs, ns, h, w, c') already warped
        bs, ns, h, w = src.shape[:4]
        flat = src.reshape((bs * ns, h, w) + tuple(src.shape[4:]))
        k = conv(self.fk, flat).reshape(bs, ns, h, w, self.c)
        v = conv(self.fv, flat).reshape(bs, ns, h, w, self.c)
        q = conv(self.fq, x)
        alpha = torch.softmax(torch.einsum("nshwc,nhwc->nshw", k, q) / (self.c ** 0.5), dim=1)
        return self.SPADE_0(x, torch.einsum("nshw,nshwc->nhwc", alpha, v))


class AddLWB(nn.Module):
    """The transfer feature plus the warped sources."""

    def forward(self, x, src):
        return torch.cat([x[:, None], src], dim=1).sum(dim=1)


class LWBGenerator(nn.Module):
    """BGNet + SIDNet + TSFNet with the fusion `fusion` ("spade" or "add")."""

    def __init__(self, cfg: dict, fusion: str):
        super().__init__()
        bg, sid, tsf = cfg["BGNet"], cfg["SIDNet"], cfg["TSFNet"]
        self.bg_net = BGNet(tuple(bg["num_filters"]), int(bg["n_res_block"]))
        sid_f = tuple(sid["num_filters"])
        self.src_net = SIDNet(6, sid_f, int(sid["n_res_block"]))
        self.tsf_f, self.tsf_res = tuple(tsf["num_filters"]), int(tsf["n_res_block"])
        cin = 6
        for i, c in enumerate(self.tsf_f):
            self.add_module(f"tsf_enc_{i}", _conv(cin, c, 3, 2, bias=False))
            cin = c
        self.tsf_net_dec = SkipDecoder(self.tsf_f, tuple(reversed(self.tsf_f)))
        self.tsf_heads = Heads(self.tsf_f[0])
        for i in range(self.tsf_res):
            self.add_module(f"tsf_res_blocks_{i}", Residual(self.tsf_f[-1]))
        make = (lambda c, s: AttentionLWB(c, s)) if fusion == "spade" else (lambda c, s: AddLWB())
        for i, c in enumerate(self.tsf_f):
            self.add_module(f"enc_fusion_{i}", make(c, sid_f[i]))
        for i in range(self.tsf_res):
            self.add_module(f"res_fusion_{i}", make(self.tsf_f[-1], sid_f[-1]))

    def forward_bg(self, x):  # (bs, n, h, w, 4) -> (bs, n, h, w, 3)
        out = self.bg_net(x.reshape((-1,) + tuple(x.shape[2:])))
        return out.reshape(tuple(x.shape[:2]) + tuple(out.shape[1:]))

    def forward_src(self, x):
        """SIDNet stages of (bs, ns, h, w, 6): encoder outputs and residual outputs,
        each (bs, ns, h_i, w_i, c_i)."""
        bs, ns = x.shape[:2]
        enc = self.src_net.encoders(x.reshape((bs * ns,) + tuple(x.shape[2:])))
        res, y = [], enc[-1]
        for i in range(self.src_net.n_res):
            y = getattr(self.src_net, f"res_blocks_{i}")(y)
            res.append(y)
        unflat = lambda t: t.reshape((bs, ns) + tuple(t.shape[1:]))
        return [unflat(t) for t in enc], [unflat(t) for t in res]

    def forward_tsf(self, tsf_in, src_enc, src_res, Tst):
        """tsf_in (bs, h, w, 6); SIDNet stages (bs, ns, ...); Tst (bs, ns, H, W, 2)."""
        bs, ns = Tst.shape[:2]

        def warped(feat):
            flat = feat.reshape((bs * ns,) + tuple(feat.shape[2:]))
            out = warp(flat, Tst.reshape((bs * ns,) + tuple(Tst.shape[2:])))
            return out.reshape((bs, ns) + tuple(out.shape[1:]))

        x, enc_outs = tsf_in, []
        for i in range(len(self.tsf_f)):
            x = F.relu(conv(getattr(self, f"tsf_enc_{i}"), x))
            x = getattr(self, f"enc_fusion_{i}")(x, warped(src_enc[i]))
            enc_outs.append(x)
        for i in range(self.tsf_res):
            x = getattr(self, f"tsf_res_blocks_{i}")(x)
            x = getattr(self, f"res_fusion_{i}")(x, warped(src_res[i]))
        return self.tsf_heads(self.tsf_net_dec(x, enc_outs))

    def forward_train(self, bg_in, src_in, tsf_in, Tst):
        """The training forward over nt time steps: bg_in (bs, 1, S, S, 4),
        src_in (bs, ns, S, S, 6), tsf_in (bs, nt, S, S, 6), Tst (bs, nt, ns,
        S, S, 2) -> background (bs, 1, S, S, 3), the sources' reconstructions
        and masks (bs, ns, ...), the targets' images and masks (bs, nt, ...)."""
        bg = self.forward_bg(bg_in)
        bs, ns = src_in.shape[:2]
        enc, res = self.forward_src(src_in)
        last = (res or enc)[-1]
        dec = self.src_net.decoders(last.reshape((bs * ns,) + tuple(last.shape[2:])))[-1]
        src_img, src_mask = self.src_net.heads(dec)
        unflat = lambda t: t.reshape((bs, ns) + tuple(t.shape[1:]))
        outs = [self.forward_tsf(tsf_in[:, t], enc, res, Tst[:, t]) for t in range(tsf_in.shape[1])]
        return (bg, unflat(src_img), unflat(src_mask), torch.stack([o[0] for o in outs], 1),
                torch.stack([o[1] for o in outs], 1))
