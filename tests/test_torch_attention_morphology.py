"""Parity of the port's contextual attention and edge morphology with the
JAX package (`ipercore_tpu/ops/attention.py`, `ops/morphology.py`), on the
same numpy inputs.

Tolerances: attention within 1e-5 (f32 sums of a 9C-long dot product and a
softmax over HW keys, computed in another order); the plain and the fused
routes within 1e-5 of each other; `soft_edge` exact; the blur within 1e-6,
Sobel within 1e-5 (f32 sums of up to 9 products).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ipercore_tpu.ops import morphology as jm
from ipercore_tpu.ops.attention import ContextualAttention as JaxContextualAttention
from ipercore_tpu_torch.ops import attention as ta
from ipercore_tpu_torch.ops import morphology as tm


def _features(seed, n, h, w, c):
    return np.random.RandomState(seed).randn(n, h, w, c).astype(np.float32)


def _holes(n, h, w):
    """Frame 0: a rectangular hole; frame 1: everything masked; frame 2:
    nothing masked; frame 3: a random scatter."""
    hole = np.zeros((n, h, w, 1), np.float32)
    hole[0, h // 4:3 * h // 4, w // 3:2 * w // 3] = 1
    hole[1] = 1
    hole[3] = (np.random.RandomState(7).rand(h, w, 1) > 0.6)
    return hole


def _jax(f, hole):
    return np.asarray(JaxContextualAttention().apply({}, jnp.asarray(f), jnp.asarray(hole)))


@pytest.mark.parametrize("h,w,c", [(16, 16, 8), (24, 32, 16), (32, 32, 4)])
def test_contextual_attention_matches_jax(h, w, c):
    f = _features(h + c, 4, h, w, c)
    hole = _holes(4, h, w)
    want = _jax(f, hole)
    for route in (ta.contextual_attention_plain, ta.contextual_attention_fused, ta.contextual_attention):
        got = route(torch.tensor(f), torch.tensor(hole)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=route.__name__)
    module = ta.ContextualAttention()(torch.tensor(f), torch.tensor(hole)).numpy()
    np.testing.assert_allclose(module, want, rtol=0, atol=1e-5)


def test_all_masked_frame_is_the_mean_and_none_masked_keeps_the_features():
    """Where every key is masked, each score rounds to -1e9 in f32 and the
    softmax is uniform: the output is the mean of the features, in JAX and in
    both routes (a boolean mask would give NaN); where nothing is masked the
    features pass through."""
    f = _features(3, 4, 16, 16, 8)
    hole = _holes(4, 16, 16)
    mean = f[1].reshape(-1, 8).mean(0)
    for got in (_jax(f, hole),
                ta.contextual_attention_plain(torch.tensor(f), torch.tensor(hole)).numpy(),
                ta.contextual_attention_fused(torch.tensor(f), torch.tensor(hole)).numpy()):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[1], np.broadcast_to(mean, got[1].shape), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[2], f[2])
        outside = hole[0, ..., 0] < 0.5
        np.testing.assert_array_equal(got[0][outside], f[0][outside])


def test_fused_route_is_the_plain_route_on_the_cpu():
    f = _features(5, 2, 20, 12, 6)
    hole = _holes(4, 20, 12)[:2]
    plain = ta.contextual_attention_plain(torch.tensor(f), torch.tensor(hole)).numpy()
    fused = ta.contextual_attention_fused(torch.tensor(f), torch.tensor(hole)).numpy()
    np.testing.assert_allclose(fused, plain, rtol=0, atol=1e-5)


def test_soft_edge_matches_jax():
    m = (np.random.RandomState(1).rand(2, 12, 14, 3) > 0.5).astype(np.float32)
    for ks in (3, 5):
        np.testing.assert_array_equal(tm.soft_edge(torch.tensor(m), ks).numpy(),
                                      np.asarray(jm.soft_edge(jnp.asarray(m), ks)))


@pytest.mark.parametrize("sigma,ks", [(1.0, 5), (2.0, 7)])
def test_gaussian_blur_matches_jax_and_wraps_at_the_border(sigma, ks):
    img = _features(2, 2, 12, 14, 3)
    got = tm.gaussian_blur(torch.tensor(img), sigma, ks).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.gaussian_blur(jnp.asarray(img), sigma, ks)), rtol=0, atol=1e-6)
    # a single bright pixel in the corner spreads to the opposite border
    spot = np.zeros((1, 12, 14, 1), np.float32)
    spot[0, 0, 0] = 1
    out = tm.gaussian_blur(torch.tensor(spot), sigma, ks).numpy()
    assert out[0, -1, -1, 0] > 0 and out[0, -1, 0, 0] > 0 and out[0, 0, -1, 0] > 0


def test_sobel_edges_match_jax():
    img = _features(4, 2, 12, 14, 3)
    gx, gy = tm.sobel_edges(torch.tensor(img))
    jx, jy = jm.sobel_edges(jnp.asarray(img))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jy), rtol=0, atol=1e-5)


def test_fused_route_hands_the_attention_dense_last_dimensions(monkeypatch):
    """The card's fused kernels refuse inputs whose last dimension is strided
    ("No available kernel"); the refiners hand the attention an NHWC view of
    NCHW features, so the route must make q, k, v and the bias dense there."""
    seen = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def spy(q, k, v, attn_mask=None, scale=None):
        seen.update(q=q.stride(-1), k=k.stride(-1), v=v.stride(-1), bias=attn_mask.stride(-1))
        return sdpa(q, k, v, attn_mask=attn_mask, scale=scale)

    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention", spy)
    f = torch.tensor(_features(8, 2, 8, 6, 4)).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert f.stride(-1) != 1
    hole = torch.tensor(_holes(4, 8, 6)[:2])
    got = ta.contextual_attention_fused(f, hole)
    assert seen == {"q": 1, "k": 1, "v": 1, "bias": 1}
    np.testing.assert_allclose(got.numpy(), ta.contextual_attention_plain(f, hole).numpy(), rtol=0, atol=1e-5)
