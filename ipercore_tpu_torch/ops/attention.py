"""Contextual attention: rebuild masked-region features from known-region
patches (twin of `ipercore_tpu/ops/attention.py`, shared by the GCA matting
refiner and the stage-2 inpaintor).

Every pixel's 3x3 feature patch (zero padded) is a query and a key; the
score is the cosine similarity of two patches times `softmax_scale`, keys
inside the hole get an additive -1e9, and the value is each key pixel's own
feature vector. Pixels inside the hole take the attention output, the others
keep their features.

Two routes compute it:
  * `contextual_attention_plain`: the JAX package's two products and a
    softmax, holding the (HW)^2 affinity of every frame. It runs on the CPU
    and in the checks.
  * `contextual_attention_fused`: one `F.scaled_dot_product_attention` call
    with the same normalised patches as query and key, the features as value
    and the -1e9 mask as an additive f32 bias. On the card it runs under the
    memory-efficient backend alone (`sdpa_kernel(EFFICIENT_ATTENTION)`), which
    never holds the affinity and raises rather than fall back to the math
    backend. The bias is additive, not boolean: where every key is masked,
    each score rounds to -1e9 in f32 and the softmax is uniform (the output is
    the mean of the features), as in the JAX package; a boolean mask gives
    NaN there.

The JAX module is plain XLA, not a Pallas kernel, so the card's route is a
PyTorch call. A CUDA tensor takes the fused route, a CPU tensor the plain one
(`ops/dispatch.use_kernel`; `force_plain()` runs the plain route on the card
for comparisons).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.ops.dispatch import use_kernel

MASKED_BIAS = -1e9


def _patches(f: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, HW, 9C) normalised 3x3 patches (zero padded), each
    divided by max(its norm, 1e-4). The order of the 9C features differs from
    the JAX package's, which a cosine similarity does not see."""
    n, h, w, c = f.shape
    p = F.unfold(f.permute(0, 3, 1, 2), 3, padding=1).transpose(1, 2)
    return p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True), min=1e-4)


def _bias(hole_mask: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 1) hole mask -> (N, HW) f32 additive key bias: 0 for a known
    pixel (< 0.5), -1e9 for one inside the hole."""
    n = hole_mask.shape[0]
    known = hole_mask.reshape(n, -1) < 0.5
    return torch.where(known, 0.0, MASKED_BIAS).to(torch.float32)


def _merge(f: torch.Tensor, recon: torch.Tensor, hole_mask: torch.Tensor) -> torch.Tensor:
    return torch.where(hole_mask > 0.5, recon.reshape(f.shape), f)


def contextual_attention_plain(f: torch.Tensor, hole_mask: torch.Tensor,
                               softmax_scale: float = 10.0) -> torch.Tensor:
    """The JAX package's formulation: the (N, HW, HW) affinity, softmax,
    and its product with the features."""
    n, h, w, c = f.shape
    qn = _patches(f)
    sim = torch.bmm(qn, qn.transpose(1, 2))
    attn = torch.softmax(sim * softmax_scale + _bias(hole_mask)[:, None, :], dim=-1)
    recon = torch.bmm(attn, f.reshape(n, h * w, c))
    return _merge(f, recon, hole_mask)


def contextual_attention_fused(f: torch.Tensor, hole_mask: torch.Tensor,
                               softmax_scale: float = 10.0) -> torch.Tensor:
    """One `scaled_dot_product_attention` call: q = k = the normalised
    patches (N, 1, HW, 9C), v = f (N, 1, HW, C), an additive bias (N, 1, 1, HW)
    broadcast over the queries. On a CUDA tensor only the memory-efficient
    backend may run (it raises when it cannot take the shapes); on the CPU
    PyTorch picks its backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    n, h, w, c = f.shape
    # the fused kernels need stride 1 on the last dimension: the patches come
    # transposed from `unfold`, and a network's NHWC view of NCHW features is
    # strided too
    q = _patches(f)[:, None].contiguous()
    v = f.reshape(n, 1, h * w, c).contiguous()
    bias = _bias(hole_mask)[:, None, None, :].to(f.dtype)
    if f.is_cuda:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = F.scaled_dot_product_attention(q, q, v, attn_mask=bias, scale=softmax_scale)
    else:
        out = F.scaled_dot_product_attention(q, q, v, attn_mask=bias, scale=softmax_scale)
    return _merge(f, out[:, 0], hole_mask)


def contextual_attention(f: torch.Tensor, hole_mask: torch.Tensor,
                         softmax_scale: float = 10.0) -> torch.Tensor:
    """f: (N, H, W, C); hole_mask: (N, H, W, 1), 1 = region to rebuild.
    Returns (N, H, W, C): the attention's reconstruction inside the mask, the
    features outside. A CUDA tensor takes the fused route, a CPU tensor the
    plain one."""
    if use_kernel(f):
        return contextual_attention_fused(f, hole_mask, softmax_scale)
    return contextual_attention_plain(f, hole_mask, softmax_scale)


class ContextualAttention(nn.Module):
    """The parameter-free module form (the Flax module's place in a network)."""

    def __init__(self, softmax_scale: float = 10.0):
        super().__init__()
        self.softmax_scale = softmax_scale

    def forward(self, f, hole_mask):
        return contextual_attention(f, hole_mask, self.softmax_scale)
