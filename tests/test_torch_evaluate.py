"""`services/evaluate` of the port against the JAX package's: psnr / ssim,
`LPIPSLin` (64²) and `InceptionV3Features` (96²) from the same seeded
weights, the Frechet distance, `evaluate_frames` with and without a saved
LPIPS checkpoint and with a saved Inception checkpoint (the `fid` key, at
299²; the proxy VGG on `vgg_perceptual.npz` in both, restored from git
history when it is not on disk), and the command line on two PNG
directories against `scripts/evaluate/eval_imitator.py`.

Tolerances: psnr / ssim 1e-5; the networks 1e-4 relative (of the largest
output); the proxy metrics and LPIPS 1e-4 relative; the Frechet distances
1e-3 relative with no absolute floor (the eigenvalues of a product of two
covariance matrices of features that agree to 1e-5).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipercore_tpu.models.networks.criterions import LPIPSLin as JLPIPS
from ipercore_tpu.models.networks.criterions import VGGFeatures as JVGG
from ipercore_tpu.models.networks.inception import InceptionV3Features as JInception
from ipercore_tpu.services import evaluate as JE
from ipercore_tpu.utils import checkpoint as jckpt
from ipercore_tpu_torch.models.networks.criterions import LPIPSLin
from ipercore_tpu_torch.models.networks.inception import InceptionV3Features
from ipercore_tpu_torch.services import evaluate as TE
from ipercore_tpu_torch.utils import checkpoint as tckpt
from ipercore_tpu_torch.utils import video as tvid

from tests.test_torch_common import ROOT, history_weights, n, t, unflatten_to_jax


def _frames(seed, shape=(3, 32, 32, 3)):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, shape).astype(np.float32)


def test_psnr_and_ssim_match_jax():
    a = _frames(0)
    b = np.clip(a + _frames(1) * 0.2, -1, 1)
    for fn in ("psnr", "ssim"):
        want = np.asarray(getattr(JE, fn)(jnp.asarray(a), jnp.asarray(b)))
        got = n(getattr(TE, fn)(t(a), t(b)))
        assert got.shape == want.shape == (3,)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=fn)
    assert float(TE.ssim(t(a), t(a)).min()) == pytest.approx(1.0, abs=1e-5)


def _rel(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max() / np.abs(want).max()


def test_lpips_lin_matches_jax():
    net = LPIPSLin().eval()
    flat = tckpt.seeded_flat_params(net, 3)
    tckpt.load_generator_params(net, flat)
    a, b = _frames(2, (2, 64, 64, 3)), _frames(3, (2, 64, 64, 3))
    want = np.asarray(jax.jit(JLPIPS().apply)(unflatten_to_jax(flat), jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = n(net(t(a), t(b)))
    assert got.shape == (2,) and (got > 0).all()
    _rel(got, want)


def test_inception_features_match_jax():
    """96² keeps the CPU cost down; the stride chain stays valid (as the JAX
    package's own test)."""
    net = InceptionV3Features().eval()
    flat = tckpt.seeded_flat_params(net, 4)
    tckpt.load_generator_params(net, flat)
    assert 20e6 < sum(v.size for v in flat.values()) < 24e6
    x = _frames(5, (2, 96, 96, 3))
    want = np.asarray(jax.jit(JInception().apply)(unflatten_to_jax(flat), jnp.asarray(x)))
    with torch.no_grad():
        got = n(net(t(x)))
    assert got.shape == (2, 2048) and got.std() > 0
    _rel(got, want)


def test_frechet_distance_matches_jax():
    rng = np.random.RandomState(6)
    f1, f2 = rng.randn(40, 16), rng.randn(40, 16) * 1.3 + 0.2
    args = (f1.mean(0), np.cov(f1, rowvar=False), f2.mean(0), np.cov(f2, rowvar=False))
    assert TE.frechet_distance(*args) == JE.frechet_distance(*args)
    assert TE.frechet_distance(*args[:2], *args[:2]) == pytest.approx(0.0, abs=1e-6)


@pytest.fixture(scope="module")
def proxy(tmp_path_factory):
    """The proxy VGG19 pyramid on `vgg_perceptual.npz` in both packages."""
    path = history_weights("vgg_perceptual", tmp_path_factory)
    jnet = JVGG()
    like = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    jmetric = JE.PerceptualMetric(params=jckpt.load_params(path, like=like), image_size=32)
    tmetric = TE.PerceptualMetric(params=tckpt.load_flat_npz(path), device="cpu")
    return jmetric, tmetric


def _check_metrics(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        tol = 1e-5 if k in ("ssim", "psnr") else (1e-3 if k.startswith("fid") else 1e-4)
        atol = 0.0 if k.startswith("fid") else (1e-4 if k == "psnr" else 1e-6)
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=atol, err_msg=k)


def test_evaluate_frames_keys_and_values(proxy, tmp_path):
    """Without the LPIPS and Inception weights: `lpips_proxy` and `fid_proxy`;
    with a saved LPIPS checkpoint: `lpips` instead of the proxy. Both as JAX
    gives them."""
    jmetric, tmetric = proxy
    a = _frames(7, (4, 32, 32, 3))
    b = np.clip(a + _frames(8, (4, 32, 32, 3)) * 0.3, -1, 1)
    nothing = str(tmp_path / "absent.npz")
    jnets = dict(fid_net=JE.InceptionFID(weights_path=nothing), lpips_net=JE.LPIPSMetric(weights_path=nothing))
    tnets = dict(fid_net=TE.InceptionFID(weights_path=nothing, device="cpu"),
                 lpips_net=TE.LPIPSMetric(weights_path=nothing, device="cpu"))
    assert not tnets["fid_net"].available and not tnets["lpips_net"].available
    want = JE.evaluate_frames(a, b, metric=jmetric, **jnets)
    got = TE.evaluate_frames(a, b, metric=tmetric, device="cpu", **tnets)
    assert set(got) == {"ssim", "psnr", "lpips_proxy", "fid_proxy"}
    _check_metrics(got, want)

    lpips_path = str(tmp_path / "lpips.npz")
    tckpt.save_params(lpips_path, tckpt.seeded_flat_params(LPIPSLin(), 9))
    jnets["lpips_net"] = JE.LPIPSMetric(weights_path=lpips_path)
    tnets["lpips_net"] = TE.LPIPSMetric(weights_path=lpips_path, device="cpu")
    assert tnets["lpips_net"].available
    want = JE.evaluate_frames(a, b, metric=jmetric, **jnets)
    got = TE.evaluate_frames(a, b, metric=tmetric, device="cpu", **tnets)
    assert set(got) == {"ssim", "psnr", "lpips", "fid_proxy"}
    _check_metrics(got, want)


def test_evaluate_frames_fid_matches_jax(proxy, tmp_path):
    """With a saved InceptionV3 checkpoint: `fid` instead of the proxy, the
    frames resized from 32² to 299² (antialiased linear) and pooled by
    Inception in each package, the Frechet distance as JAX gives it."""
    jmetric, tmetric = proxy
    a = _frames(12, (4, 32, 32, 3))
    b = np.clip(a + _frames(13, (4, 32, 32, 3)) * 0.3, -1, 1)
    fid_path = str(tmp_path / "inception.npz")
    tckpt.save_params(fid_path, tckpt.seeded_flat_params(InceptionV3Features(), 4))
    nothing = str(tmp_path / "absent.npz")
    want = JE.evaluate_frames(a, b, metric=jmetric, fid_net=JE.InceptionFID(weights_path=fid_path),
                              lpips_net=JE.LPIPSMetric(weights_path=nothing))
    got = TE.evaluate_frames(a, b, metric=tmetric, device="cpu",
                             fid_net=TE.InceptionFID(weights_path=fid_path, device="cpu"),
                             lpips_net=TE.LPIPSMetric(weights_path=nothing, device="cpu"))
    assert set(got) == {"ssim", "psnr", "lpips_proxy", "fid"}
    assert got["fid"] > 0  # about 1e-7: seeded Inception's pool3 features are about 1e-4
    _check_metrics(got, want)


def test_metric_nets_take_weights_given_in_memory():
    """`params` stands in for a weights file: `available` turns on and the
    net holds exactly those weights."""
    flat = tckpt.seeded_flat_params(LPIPSLin(), 1)
    m = TE.LPIPSMetric(weights_path="/nonexistent.npz", params=flat, device="cpu")
    assert m.available
    back = tckpt.torch_params_to_flax(m.net)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    fid = TE.InceptionFID(weights_path="/nonexistent.npz", params=tckpt.seeded_flat_params(InceptionV3Features(), 2),
                          device="cpu")
    assert fid.available
    mu, cov = fid.feature_stats(_frames(3, (3, 32, 32, 3)))
    assert mu.shape == (2048,) and cov.shape == (2048, 2048)


def test_cli_matches_the_jax_script(tmp_path, capsys, monkeypatch):
    """Two PNG directories through the port's `main` and through
    `scripts/evaluate/eval_imitator.py`: the same keys and frame count, ssim
    and psnr within 1e-5 (the proxy VGG of each package is its own when the
    weights are not on disk)."""
    dirs = {}
    for name, seed in (("pred", 10), ("gt", 11)):
        d = tmp_path / name
        d.mkdir()
        for i, img in enumerate(_frames(seed, (3, 24, 24, 3))):
            tvid.save_image(str(d / f"frame_{i:04d}.png"), img)
        dirs[name] = str(d)
    argv = ["--pred_dir", dirs["pred"], "--gt_dir", dirs["gt"], "--image_size", "32"]
    monkeypatch.setattr(TE, "INCEPTION_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setattr(TE, "LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setattr(JE, "INCEPTION_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setattr(JE, "LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    assert TE.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spec = importlib.util.spec_from_file_location(
        "eval_imitator", os.path.join(ROOT, "scripts", "evaluate", "eval_imitator.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) == {"ssim", "psnr", "lpips_proxy", "fid_proxy", "n_frames"}
    assert got["n_frames"] == want["n_frames"] == 3
    for k in ("ssim", "psnr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert TE.main(["--pred_dir", str(tmp_path / "pred"), "--gt_dir", str(tmp_path), "--device", "cpu"]) == 1
