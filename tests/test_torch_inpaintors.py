"""Parity of the port's background inpainting and super-resolution
(`tools/inpaintors.py`) with the JAX package: the published
`inpaintor.npz`, `inpaintor_refine.npz` (64^2) and `esrgan.npz` (23 blocks,
16^2) through both packages, the nearest 2x upsampling, the diffusion fill,
and every branch of `run_inpainting`.

Tolerances: networks within 1e-4 of their largest output (f32 convolutions
in another order; the refiner's attention mask at H/4 is thresholded the
same way in both); the nearest 2x and the diffusion fill exact / within 1e-6;
`run_inpainting` within 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_common import history_weights, unflatten_to_jax
from ipercore_tpu.tools import inpaintors as jin
from ipercore_tpu_torch.tools import inpaintors as tin
from ipercore_tpu_torch.utils.checkpoint import load_flat_npz, load_generator_params, seeded_flat_params


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / max(np.abs(np.asarray(want)).max(), 1e-30))


def _flat(name, tmp_path_factory):
    return {k: np.asarray(v, np.float32) for k, v in load_flat_npz(history_weights(name, tmp_path_factory)).items()}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return {n: _flat(n, tmp_path_factory) for n in ("inpaintor", "inpaintor_refine", "esrgan")}


def _hole_inputs(n, s, seed):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (n, s, s, 3)).astype(np.float32)
    mask = np.zeros((n, s, s, 1), np.float32)
    mask[:, s // 4:3 * s // 4, s // 3:2 * s // 3] = 1
    return img, mask


def test_published_gated_and_refine_inpaintors_match_jax(weights):
    img, mask = _hole_inputs(2, 64, 0)
    x = np.concatenate([img * (1 - mask), mask], -1)
    net = tin.GatedInpaintor().eval()
    load_generator_params(net, weights["inpaintor"])
    with torch.no_grad():
        got = net(torch.tensor(x)).numpy()
    want = jin.GatedInpaintor().apply(unflatten_to_jax(weights["inpaintor"]), jnp.asarray(x))
    assert _rel(got, want) <= 1e-4
    ref = tin.RefineInpaintor().eval()
    load_generator_params(ref, weights["inpaintor_refine"])
    with torch.no_grad():
        got = ref(torch.tensor(x), torch.tensor(mask)).numpy()
    want = jin.RefineInpaintor().apply(unflatten_to_jax(weights["inpaintor_refine"]), jnp.asarray(x),
                                       jnp.asarray(mask))
    assert _rel(got, want) <= 1e-4


def test_published_rrdbnet_matches_jax(weights):
    assert len([k for k in weights["esrgan"] if k.startswith("params/body_")]) == 23 * 3 * 5 * 2
    x = np.random.RandomState(1).rand(1, 16, 16, 3).astype(np.float32)
    net = tin.RRDBNet().eval()
    load_generator_params(net, weights["esrgan"])
    with torch.no_grad():
        got = net(torch.tensor(x)).numpy()
    want = jin.RRDBNet().apply(unflatten_to_jax(weights["esrgan"]), jnp.asarray(x))
    assert got.shape == (1, 64, 64, 3)
    assert _rel(got, want) <= 1e-4


def test_nearest_2x_is_jax_resize_bit_for_bit():
    y = np.random.RandomState(2).randn(2, 5, 7, 3).astype(np.float32)
    got = torch.nn.functional.interpolate(torch.tensor(y).permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    want = jax.image.resize(jnp.asarray(y), (2, 10, 14, 3), "nearest")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_diffusion_fill_matches_jax():
    img, mask = _hole_inputs(2, 32, 3)
    got = tin.diffusion_fill(torch.tensor(img), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(jin.diffusion_fill(jnp.asarray(img), jnp.asarray(mask))),
                               rtol=0, atol=1e-6)


def _frame(h, w, seed):
    rng = np.random.RandomState(seed)
    image = np.clip(np.sin(np.arange(w)[None, :, None] / 5.0 + np.arange(3)) * 0.5
                    + 0.1 * rng.randn(h, w, 3), -1, 1).astype(np.float32)
    mask = np.zeros((h, w, 1), np.float32)
    mask[h // 4:3 * h // 4, w // 3:w // 2] = 1
    return image, mask


@pytest.mark.parametrize("branch", ["untrained", "trained", "refine", "sr"])
def test_run_inpainting_matches_jax(branch, weights, tmp_path_factory):
    """control 16: the untrained diffusion fill; the gated net; with the
    refinement; and the SR branch on a frame 4x the control size (64^2, a
    2-block RRDBNet, seeded; the JAX package takes the same parameters)."""
    missing = str(tmp_path_factory.mktemp("none") / "x.npz")
    kw = dict(control_size=16, weights_path=missing, refine_weights_path=missing, sr_blocks=2)
    trained = branch != "untrained"
    sr_flat = seeded_flat_params(tin.RRDBNet(n_blocks=2), 12)
    tkw = dict(kw, inpaint_params=weights["inpaintor"] if trained else None,
               refine_params=weights["inpaintor_refine"] if branch in ("refine", "sr") else None,
               sr_params=sr_flat if branch == "sr" else None)
    pt = tin.SuperResolutionInpaintor(device="cpu", **tkw)
    jx = jin.SuperResolutionInpaintor(**{k: (unflatten_to_jax(v) if isinstance(v, dict) else v)
                                         for k, v in tkw.items()})
    assert (pt.trained, pt.refine_trained, pt.sr_trained) == (jx.trained, jx.refine_trained, jx.sr_trained)
    for h, w in ((64, 64), (40, 56)):
        image, mask = _frame(h, w, 4)
        got = pt.run_inpainting(image, mask)
        want = np.asarray(jx.run_inpainting(image, mask))
        assert got.shape == (h, w, 3)
        assert _rel(got, want) <= 1e-4, (branch, h, w)
