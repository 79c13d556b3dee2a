"""Sampling, resizing, morphology and boundary fill: JAX package (XLA sampler
and the Pallas sampler in interpret mode) vs the PyTorch port (CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ipercore_tpu.models import flow_composition as jfc
from ipercore_tpu.ops import morphology as jmorph
from ipercore_tpu.ops import sampling as jsamp
from ipercore_tpu.ops.sampling_pallas import grid_sample_pallas
from ipercore_tpu_torch.models import flow_composition as tfc
from ipercore_tpu_torch.ops import morphology as tmorph
from ipercore_tpu_torch.ops import sampling as tsamp
from ipercore_tpu_torch.ops import sampling_cuda as tsc

from tests.test_torch_common import n, t


def _img_grid(C, seed, N=2, H=24, W=20, h=17, w=15):
    rng = np.random.RandomState(seed)
    img = rng.randn(N, H, W, C).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (N, h, w, 2)).astype(np.float32)
    grid[0, :3] = -2.0  # the flow sentinel
    grid[-1, 0, 0] = [-1.0, -1.0]  # exactly on the border
    grid[-1, 0, 1] = [1.0, 1.0]
    return img, grid


@pytest.mark.parametrize("C", [3, 64, 128])
@pytest.mark.parametrize("fn", ["plain", "library"])
def test_grid_sample_matches_jax(C, fn):
    img, grid = _img_grid(C, seed=C)
    ref = np.asarray(jsamp.grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    f = tsc.grid_sample_nhwc if fn == "plain" else tsamp.grid_sample
    out = n(f(t(img), t(grid)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    assert (out[0, :3] == 0).all()  # sentinel samples to zero


@pytest.mark.parametrize("hw", [(16, 32), (13, 11)])
def test_grid_sample_plain_matches_pallas_interpret(hw):
    img, grid = _img_grid(3, seed=7, N=1, H=16, W=16, h=hw[0], w=hw[1])
    ref = np.asarray(grid_sample_pallas(jnp.asarray(img), jnp.asarray(grid), interpret=True))
    np.testing.assert_allclose(n(tsc.grid_sample_plain(t(img), t(grid))), ref, atol=1e-5, rtol=0)


def test_grid_sample_wrapper_bf16_shared_image_and_checks():
    img, grid = _img_grid(3, seed=8)
    out_bf = tsc.grid_sample_nhwc(t(img).to(torch.bfloat16), t(grid))
    assert out_bf.dtype == torch.float32
    want = tsc.grid_sample_nhwc(t(img).to(torch.bfloat16).float(), t(grid))
    np.testing.assert_array_equal(n(out_bf), n(want))
    one = t(img[:1])
    np.testing.assert_array_equal(n(tsc.grid_sample_nhwc(one.expand(2, -1, -1, -1), t(grid))),
                                  n(tsc.grid_sample_nhwc(one.repeat(2, 1, 1, 1), t(grid))))
    far = t(grid).clone()
    far[0, 5, 5] = 1e30  # far outside: never turned into an index, samples to zero
    assert (n(tsc.grid_sample_nhwc(t(img), far))[0, 5, 5] == 0).all()
    with pytest.raises(TypeError):
        tsc.grid_sample_nhwc(t(img).double(), t(grid))
    with pytest.raises(ValueError):
        tsc.grid_sample_nhwc(t(img), t(grid)[..., :1])


@pytest.mark.parametrize("shape,hw", [((2, 3, 16, 16, 2), (8, 8)), ((2, 16, 16, 2), (32, 32)),
                                      ((1, 2, 24, 24, 2), (6, 6)), ((2, 16, 16, 2), (16, 16))])
def test_resize_flow(shape, hw):
    rng = np.random.RandomState(9)
    flow = rng.uniform(-1, 1, shape).astype(np.float32)
    flow[..., :3, :, :] = -2.0  # sentinels are blended at the edge, as in JAX
    ref = np.asarray(jsamp.resize_flow(jnp.asarray(flow), *hw))
    out = n(tsamp.resize_flow(t(flow), *hw))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(8, 8), (40, 40)])
def test_resize_image(hw):
    rng = np.random.RandomState(10)
    img = rng.randn(2, 20, 20, 5).astype(np.float32)
    ref = np.asarray(jsamp.resize_image(jnp.asarray(img), *hw))
    np.testing.assert_allclose(n(tsamp.resize_image(t(img), *hw)), ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize("ks", [1, 3, 11, 51])
@pytest.mark.parametrize("op", ["dilate", "erode"])
def test_morphology_exact(op, ks):
    rng = np.random.RandomState(11)
    mask = (rng.rand(2, 40, 40, 1) > 0.7).astype(np.float32)
    ref = np.asarray(getattr(jmorph, op)(jnp.asarray(mask), ks))
    np.testing.assert_array_equal(n(getattr(tmorph, op)(t(mask), ks)), ref)
    np.testing.assert_array_equal(n(tmorph.morph(t(mask), ks, op)), ref)


def test_morph_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tmorph.morph(torch.zeros(1, 4, 4, 1), 3, "open")


def test_boundary_fill():
    rng = np.random.RandomState(12)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    known = np.zeros((2, 32, 32, 1), np.float32)
    known[:, 10:20, 10:20] = 1
    target = np.zeros_like(known)
    target[:, 4:26, 4:26] = 1
    target *= 1 - known
    ref = np.asarray(jfc.boundary_fill(jnp.asarray(img), jnp.asarray(known), jnp.asarray(target), iters=8))
    out = n(tfc.boundary_fill(t(img), t(known), t(target), iters=8))
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    assert np.abs(out[:, 5, 5]).sum() > 0  # the ring was reached


def test_merge_uv_img():
    rng = np.random.RandomState(13)
    uv = rng.randn(3, 8, 8, 3).astype(np.float32)
    vis = (rng.rand(3, 8, 8, 1) > 0.5).astype(np.float32)
    ref = np.asarray(jfc.merge_uv_img(jnp.asarray(uv), jnp.asarray(vis)))
    np.testing.assert_allclose(n(tfc.merge_uv_img(t(uv), t(vis))), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(16, 32), (13, 11)])
def test_grid_sample_strided_grid_and_out_view_match_pallas_interpret(hw):
    """The main path's call: the grid read through its pixel stride inside a
    (N, h, w, J, 2) flows tensor, the result written into the first three
    channels of a (N, h, w, 6) buffer whose other channels stay as they were."""
    img, grid = _img_grid(3, seed=7, N=2, H=16, W=16, h=hw[0], w=hw[1])
    ref = np.asarray(grid_sample_pallas(jnp.asarray(img[:1]).repeat(2, 0), jnp.asarray(grid),
                                        interpret=True))
    flows = torch.full((2,) + hw + (3, 2), 7.0)
    flows[..., 1, :] = t(grid)
    buf = torch.full((2,) + hw + (6,), 5.0)
    out = tsc.grid_sample_nhwc(t(img[:1]).expand(2, -1, -1, -1), flows[..., 1, :], out=buf[..., :3])
    assert out.data_ptr() == buf.data_ptr()
    np.testing.assert_allclose(n(buf[..., :3]), ref, atol=1e-5, rtol=0)
    assert (n(buf[..., 3:]) == 5.0).all()
    np.testing.assert_array_equal(n(buf[..., :3]), n(tsc.grid_sample_nhwc(t(img[:1]).expand(2, -1, -1, -1),
                                                                          t(grid))))


def test_grid_sample_out_must_fit():
    img, grid = _img_grid(3, seed=2)
    with pytest.raises(ValueError):
        tsc.grid_sample_nhwc(t(img), t(grid), out=torch.zeros(2, 17, 15, 4))
    with pytest.raises(ValueError):
        tsc.grid_sample_nhwc(t(img), t(grid), out=torch.zeros(2, 17, 15, 3, dtype=torch.float64))


def test_pixel_stride_of_views():
    flows = torch.zeros(2, 5, 6, 3, 2)
    assert tsc._pixel_stride(flows[..., 0, :]) == 6
    assert tsc._pixel_stride(torch.zeros(2, 5, 6, 6)[..., :3]) == 6
    assert tsc._pixel_stride(torch.zeros(2, 5, 6, 2)) == 2
    assert tsc._pixel_stride(torch.zeros(2, 6, 5, 2).transpose(1, 2)) is None
