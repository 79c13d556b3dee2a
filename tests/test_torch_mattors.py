"""Parity of the port's matting half of `tools/mattors.py` with the JAX
package: the trimap, both refiners (narrow and seeded, then the published
`matting_gca.npz` at full width), and `HumanMattor.run`'s three branches
with the compactness gate and the IoU-gated band, on the same inputs and
parameters; and the refiner's sub-batch does not change the result.

Tolerances: the trimap and the masks exact; refiner outputs within 1e-5
(f32 convolutions, GroupNorm and attention summed in another order); alphas
of `run` within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_common import history_weights, unflatten_to_jax
from ipercore_tpu.tools import mattors as jmt
from ipercore_tpu_torch.tools import mattors as tmt
from ipercore_tpu_torch.utils.checkpoint import load_generator_params, seeded_flat_params

S = 64


def _perturbed(net, seed):
    """Seeded parameters with non-zero biases and GroupNorm scales, so the
    checks see every parameter."""
    flat = seeded_flat_params(net, seed)
    rng = np.random.RandomState(seed)
    return {k: (v if k.endswith("kernel") else v + 0.1 * rng.randn(*v.shape).astype(np.float32))
            for k, v in flat.items()}


def _trimap_inputs(n, size, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    mask = np.zeros((n, size, size, 1), np.float32)
    for i in range(n):
        y0, x0 = rng.randint(2, size // 3, 2)
        mask[i, y0:y0 + size // 2, x0:x0 + size // 3] = 1
    tri = np.asarray(jmt.generate_trimap(jnp.asarray(mask)))
    return np.concatenate([x, tri], -1)


@pytest.mark.parametrize("erode_ks,dilate_ks", [(11, 21), (3, 7)])
def test_generate_trimap_matches_jax(erode_ks, dilate_ks):
    mask = (np.random.RandomState(0).rand(3, 40, 48, 1) > 0.4).astype(np.float32)
    got = tmt.generate_trimap(torch.tensor(mask), erode_ks, dilate_ks).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmt.generate_trimap(jnp.asarray(mask), erode_ks, dilate_ks)))


@pytest.mark.parametrize("name,widths", [("MattingRefiner", (8, 16, 32)), ("GCAMattingRefiner", (8, 16, 32)),
                                         ("GCAMattingRefiner", (32, 64, 128))])
def test_refiners_match_jax(name, widths):
    net = getattr(tmt, name)(widths).eval()
    flat = _perturbed(net, 8)
    load_generator_params(net, flat)
    inp = _trimap_inputs(2, 32, 1)
    with torch.no_grad():
        got = net(torch.tensor(inp)).numpy()
    want = np.asarray(getattr(jmt, name)(widths).apply(unflatten_to_jax(flat), jnp.asarray(inp)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _red_threshold_segmenter() -> dict:
    """`PersonSegUNet` parameters under which the segmenter's logit is
    relu(relu(red)) - 0.5: the person mask is the pixels whose red channel
    exceeds 0.5 (every other kernel and bias is zero)."""
    flat = {k: np.zeros_like(v) for k, v in seeded_flat_params(tmt.PersonSegUNet(), 5).items()}
    flat["params/ConvBlock_0/Conv_0/kernel"][1, 1, 0, 0] = 1.0
    flat["params/ConvBlock_0/Conv_1/kernel"][1, 1, 0, 0] = 1.0
    flat["params/ConvBlock_8/Conv_0/kernel"][1, 1, 32, 0] = 1.0  # the skip of ConvBlock_0
    flat["params/ConvBlock_8/Conv_1/kernel"][1, 1, 0, 0] = 1.0
    flat["params/Conv_2/kernel"][0, 0, 0, 0] = 1.0
    flat["params/Conv_2/bias"][0] = -0.5
    return flat


def _scenes(n=4):
    """Frames and SMPL-like fallback silhouettes that take every branch:
    0 a compact red person on the silhouette (gate passes, band), 1 a compact
    red person away from it (gate passes, no band), 2 scattered red noise
    (gate fails: the silhouette), 3 no red (gate fails)."""
    rng = np.random.RandomState(3)
    imgs = rng.uniform(-1, 0.4, (n, S, S, 3)).astype(np.float32)
    sil = np.zeros((n, S, S, 1), np.float32)
    sil[:, 12:56, 24:40] = 1
    imgs[0, 14:54, 22:41, 0] = 0.9
    imgs[1, 10:50, 2:16, 0] = 0.9
    imgs[2, ..., 0] = np.where(rng.rand(S, S) > 0.7, 0.9, -0.5)
    return imgs, sil


@pytest.fixture(scope="module")
def weight_file(tmp_path_factory):
    """A `matting_gca.npz`-layout file: the red-threshold segmenter and a
    seeded GCA refiner at published widths."""
    seg = _red_threshold_segmenter()
    mat = _perturbed(tmt.GCAMattingRefiner(), 8)
    path = str(tmp_path_factory.mktemp("mattor") / "matting_gca.npz")
    np.savez(path, **{f"seg/{k}": v for k, v in seg.items()}, **{f"mat/{k}": v for k, v in mat.items()})
    return path


def _both(path, tmp_path_factory):
    missing = str(tmp_path_factory.mktemp("none") / "person_seg.npz")
    jx = jmt.HumanMattor(weights_path=missing, gca_weights_path=path)
    pt = tmt.HumanMattor(weights_path=missing, gca_weights_path=path, device="cpu")
    assert isinstance(jx.mat, jmt.GCAMattingRefiner) and isinstance(pt.mat, tmt.GCAMattingRefiner)
    assert jx.trained and pt.trained
    return jx, pt


def test_run_trained_with_fallback_matches_jax_on_every_branch(weight_file, tmp_path_factory):
    jx, pt = _both(weight_file, tmp_path_factory)
    imgs, sil = _scenes()
    ja, jm_ = jx.run(imgs, fallback_mask=sil)
    ta, tm_ = pt.run(imgs, fallback_mask=sil)
    np.testing.assert_array_equal(tm_, np.asarray(jm_))
    np.testing.assert_allclose(ta, np.asarray(ja), rtol=0, atol=1e-5)
    assert pt.last_run["compact"] == [True, True, False, False]
    assert pt.last_run["use_band"] == [True, False, True, True]
    # the band keeps the eroded silhouette and drops what lies beyond the dilated one
    assert tm_[0, 30, 32, 0] == 1 and tm_[1, 30, 8, 0] == 1 and tm_[1, 30, 32, 0] == 0
    np.testing.assert_array_equal(tm_[2:], sil[2:])


def test_run_trained_without_fallback_matches_jax(weight_file, tmp_path_factory):
    jx, pt = _both(weight_file, tmp_path_factory)
    imgs, _ = _scenes()
    ja, jm_ = jx.run(imgs)
    ta, tm_ = pt.run(imgs)
    np.testing.assert_array_equal(tm_, np.asarray(jm_))
    np.testing.assert_allclose(ta, np.asarray(ja), rtol=0, atol=1e-5)
    assert pt.last_run["compact"] == [None] * 4


@pytest.mark.parametrize("fallback", [True, False])
def test_run_untrained_is_the_trimap_as_in_jax(fallback, tmp_path_factory):
    missing = str(tmp_path_factory.mktemp("none") / "x.npz")
    jx = jmt.HumanMattor(weights_path=missing, gca_weights_path=missing)
    pt = tmt.HumanMattor(weights_path=missing, gca_weights_path=missing, device="cpu")
    assert not jx.trained and not pt.trained and isinstance(pt.mat, tmt.MattingRefiner)
    imgs, sil = _scenes()
    fb = sil if fallback else None
    ja, jm_ = jx.run(imgs, fallback_mask=fb)
    ta, tm_ = pt.run(imgs, fallback_mask=fb)
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_array_equal(tm_, np.asarray(jm_))


def test_refiner_sub_batch_does_not_change_the_result(weight_file, tmp_path_factory, monkeypatch):
    """16 frames through the refiner in one call against two calls of 8
    (GroupNorm and the attention are per frame)."""
    _, pt = _both(weight_file, tmp_path_factory)
    imgs, sil = _scenes()
    imgs, sil = np.concatenate([imgs] * 4), np.concatenate([sil] * 4)
    one, _ = pt.run(imgs, fallback_mask=sil)
    assert pt.last_run["sub_batch"] >= 16
    monkeypatch.setattr(tmt, "REFINER_BUDGET_BYTES", 8 * tmt.REFINER_BYTES_PER_PIXEL * S * S)
    assert pt.refiner_sub_batch(S, S) == 8
    two, _ = pt.run(imgs, fallback_mask=sil)
    assert pt.last_run["sub_batch"] == 8
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-6)
    # and chunks of 4 frames, as JAX's recursion over `batch_size`
    four, _ = pt.run(imgs, fallback_mask=sil, batch_size=4)
    np.testing.assert_allclose(four, one, rtol=0, atol=1e-6)


def test_published_matting_gca_loads_strictly_and_matches_jax(tmp_path_factory):
    """`matting_gca.npz` (f16 `seg` and `mat` trees) at published widths,
    from git history, through both packages' loaders, at 64^2."""
    path = history_weights("matting_gca", tmp_path_factory)
    jx, pt = _both(path, tmp_path_factory)
    inp = _trimap_inputs(2, S, 5)
    with torch.no_grad():
        got = pt.mat(torch.tensor(inp)).numpy()
    want = np.asarray(jx._mat(jx.mat_params, jnp.asarray(inp)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    logits = pt.segment(inp[..., :3]).numpy()
    np.testing.assert_allclose(logits, np.asarray(jx._seg(jx.seg_params, jnp.asarray(inp[..., :3]))),
                               rtol=0, atol=1e-4 * max(1.0, float(np.abs(logits).max())))


def test_build_mattor_names(tmp_path):
    missing = str(tmp_path / "x.npz")
    assert isinstance(tmt.build_mattor(device="cpu", weights_path=missing, gca_weights_path=missing),
                      tmt.HumanMattor)
