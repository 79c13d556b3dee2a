"""The synthetic scene generator (`tools/synth_data.py`) against its JAX twin
on the CPU: JAX's own draws are recorded in call order and replayed through a
`Draws`-shaped object, so every function sees the same random numbers; then
the JAX package's own property tests on the port's `torch.Generator` draws."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipercore_tpu.models import smpl as jsmpl
from ipercore_tpu.models.mesh import load_assets as jload_assets
from ipercore_tpu.tools import synth_data as jsd
from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.tools import synth_data as tsd

from tests.test_torch_common import n, t

KINDS = ("uniform", "normal", "bernoulli", "randint", "dirichlet")


class Replay:
    """A `Draws`-shaped object that hands back recorded JAX draws in order,
    checking each call's kind and shape."""

    device = torch.device("cpu")

    def __init__(self, log):
        self.log, self.i = log, 0

    def _next(self, kind, shape):
        assert self.i < len(self.log), f"the port drew more than JAX's {len(self.log)} times"
        k, s, v = self.log[self.i]
        assert (kind, tuple(shape)) == (k, s), f"draw {self.i}: port {kind}{tuple(shape)}, JAX {k}{s}"
        self.i += 1
        return torch.as_tensor(np.array(v))

    def uniform(self, shape, lo=0.0, hi=1.0):
        return self._next("uniform", shape)

    def normal(self, shape):
        return self._next("normal", shape)

    def bernoulli(self, p, shape):
        return self._next("bernoulli", shape)

    def randint(self, shape, lo, hi):
        return self._next("randint", shape)

    def dirichlet(self, alpha, shape):
        return self._next("dirichlet", tuple(shape) + (len(alpha),))


def run_both(monkeypatch, jax_fn, port_fn):
    """(JAX result, port result, number of draws): `jax_fn()` runs eagerly
    with every `jax.random` sampler recorded, `port_fn(replay)` on the
    recording, which it must use up."""
    log = []
    with monkeypatch.context() as m:
        for kind in KINDS:
            def wrap(*a, _orig=getattr(jax.random, kind), _kind=kind, **kw):
                out = _orig(*a, **kw)
                log.append((_kind, tuple(out.shape), np.asarray(out)))
                return out

            m.setattr(jax.random, kind, wrap)
        ref = jax_fn()
    replay = Replay(log)
    out = port_fn(replay)
    assert replay.i == len(log), f"the port drew {replay.i} of JAX's {len(log)} times"
    return ref, out, len(log)


def close(a, b, tol=1e-5):
    a, b = n(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), atol=tol, rtol=0)


@pytest.fixture(scope="module")
def bodies():
    jm = jsmpl.synthetic_model(nu=16, nv=14)
    ja = jload_assets(jm, uv_map_path="/nonexistent", part_path="/nonexistent")
    tm = tsmpl.synthetic_model(nu=16, nv=14, device="cpu")
    ta = tload_assets(tm, device="cpu", synthetic=True)
    return jm, ja, tm, ta


KEY = jax.random.PRNGKey(7)


def test_linspace_matches_jax():
    """Bit-equal up to 352 points (every size the tests and `chip_smoke.py`
    take), within one ulp above, where XLA's CPU code generation changes."""
    for lo, hi in ((-1, 1), (0, 1), (0.0, 1.0)):
        for size in (2, 3, 16, 32, 40, 48, 64, 96, 127, 128, 256, 352):
            np.testing.assert_array_equal(n(tsd._linspace(lo, hi, size, "cpu")),
                                          np.asarray(jnp.linspace(lo, hi, size)))
        for size in (353, 512):
            np.testing.assert_allclose(n(tsd._linspace(lo, hi, size, "cpu")),
                                       np.asarray(jnp.linspace(lo, hi, size)), atol=6e-8, rtol=0)


def test_resize_matches_jax_image_resize():
    """`resize_linear` on a tensor, as the scenes take it."""
    x = np.random.RandomState(0).uniform(-1, 1, (2, 16, 12, 3)).astype(np.float32)
    for shape in ((2, 64, 48, 3), (2, 8, 6, 3), (2, 4, 3, 3), (2, 37, 5, 3)):
        got = resize_linear(t(x), shape)
        assert isinstance(got, torch.Tensor)
        close(got, jax.image.resize(jnp.asarray(x), shape, "linear"))


# one batch and size everywhere (those of `test_compose_scene_matches_jax`),
# so that JAX compiles each eager primitive once for the whole file
B, S = 2, 64
CASES = {
    "natural_pose": (lambda k, jb: jsd.natural_pose(k, B),
                     lambda d, tb: tsd.natural_pose(d, B)),
    "make_theta": (lambda k, jb: jsd.make_theta(k, B, natural_frac=0.65),
                   lambda d, tb: tsd.make_theta(d, B, natural_frac=0.65)),
    "make_theta_no_yaw": (lambda k, jb: jsd.make_theta(k, B, yaw=False, pose_std=0.4),
                          lambda d, tb: tsd.make_theta(d, B, yaw=False, pose_std=0.4)),
    "synth_background": (lambda k, jb: jsd.synth_background(k, B, S),
                         lambda d, tb: tsd.synth_background(d, B, S)),
    "fractal_noise": (lambda k, jb: jsd.fractal_noise(k, B, S, 1),
                      lambda d, tb: tsd.fractal_noise(d, B, S, 1)),
    "synth_background_photo": (lambda k, jb: jsd.synth_background_photo(k, B, S),
                               lambda d, tb: tsd.synth_background_photo(d, B, S)),
    "synth_background_studio": (lambda k, jb: jsd.synth_background_studio(k, B, S),
                                lambda d, tb: tsd.synth_background_studio(d, B, S)),
    "synth_background_mix": (lambda k, jb: jsd.synth_background_mix(k, B, S, real_frac=0.3),
                             lambda d, tb: tsd.synth_background_mix(d, B, S, real_frac=0.3)),
    "garment_tables": (lambda k, jb: jsd.garment_tables(k, B, jb[1].face_parts),
                       lambda d, tb: tsd.garment_tables(d, B, tb[1].face_parts)),
    "random_holes": (lambda k, jb: jsd.random_holes(k, B, S),
                     lambda d, tb: tsd.random_holes(d, B, S)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_on_its_draws(monkeypatch, bodies, name):
    jfn, tfn = CASES[name]
    jb, tb = bodies[:2], bodies[2:]
    ref, out, draws = run_both(monkeypatch, lambda: jfn(KEY, jb), lambda d: tfn(d, tb))
    assert draws > 0
    close(out, ref)


@pytest.mark.parametrize("bank", ["present", "empty"])
def test_synth_background_real(monkeypatch, bank):
    if bank == "empty":
        empty = np.zeros((0, 2, 2, 3), np.float32)
        monkeypatch.setattr(jsd, "_TEXTURE_BANK", empty)
        monkeypatch.setattr(tsd, "_TEXTURE_BANK", empty)
    else:
        assert tsd._texture_bank().shape[0] > 0  # scikit-learn's sample images
        np.testing.assert_array_equal(tsd._texture_bank(), jsd._texture_bank())
    ref, out, _ = run_both(monkeypatch, lambda: jsd.synth_background_real(KEY, B, S),
                           lambda d: tsd.synth_background_real(d, B, S))
    close(out, ref)


def _image(seed, shape=(B, S, S, 3)):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("name", ["photo_augment", "motion_blur", "person_texture_mix"])
def test_image_functions_match_jax(monkeypatch, name):
    img = _image(1)
    if name == "photo_augment":
        jfn = lambda: jsd.photo_augment(KEY, jnp.asarray(img), strength=0.8)
        tfn = lambda d: tsd.photo_augment(d, t(img), strength=0.8)
    elif name == "motion_blur":
        jfn = lambda: jsd.motion_blur(KEY, jnp.asarray(img), p=0.7)
        tfn = lambda d: tsd.motion_blur(d, t(img), p=0.7)
    else:
        cond = (img + 1) * 0.5
        jfn = lambda: jsd.person_texture_mix(KEY, jnp.asarray(cond), B, S, real_frac=0.5)
        tfn = lambda d: tsd.person_texture_mix(d, t(cond), B, S, real_frac=0.5)
    ref, out, _ = run_both(monkeypatch, jfn, tfn)
    close(out, ref)


def test_render_fim_and_garment_texture_match_jax(monkeypatch, bodies):
    jm, ja, tm, ta = bodies
    theta = np.asarray(jsd.make_theta(jax.random.PRNGKey(3), B, natural_frac=1.0))
    jfim = jsd.render_fim(jm, jnp.asarray(theta), 2 * S, f2uvs=ja.f2uvs)
    tfim = tsd.render_fim(tm, t(theta), 2 * S, f2uvs=ta.f2uvs)
    assert tfim.dtype == torch.int32 and (n(tfim) >= 0).mean() > 0.02
    np.testing.assert_array_equal(n(tfim), np.asarray(jfim))
    np.testing.assert_array_equal(n(tsd.render_fim(tm, t(theta), 2 * S)), n(tfim))
    ref, out, _ = run_both(monkeypatch, lambda: jsd.garment_texture(KEY, jfim, ja.face_parts),
                           lambda d: tsd.garment_texture(d, tfim, ta.face_parts))
    close(out, ref)


@pytest.mark.parametrize("photo", [True, False])
def test_compose_scene_matches_jax(monkeypatch, bodies, photo):
    jm, ja, tm, ta = bodies
    kw = dict(photo=photo, real_frac=0.3, studio_frac=0.5, garment_frac=0.5, natural_frac=0.65)
    ref, out, draws = run_both(monkeypatch, lambda: jsd.compose_scene(KEY, jm, ja, B, S, **kw),
                               lambda d: tsd.compose_scene(d, tm, ta, B, S, **kw))
    assert draws > (60 if photo else 8)
    for field in tsd.SceneBatch._fields:
        close(getattr(out, field), getattr(ref, field))
    assert 0.02 < float(out.mask.mean()) < 0.6


def test_pose2d_targets_match_jax():
    rng = np.random.RandomState(4)
    j2d = rng.uniform(-0.9, 0.9, (3, 19, 2)).astype(np.float32)
    for jfn, tfn in ((jsd.make_pose2d_targets, tsd.make_pose2d_targets),
                     (jsd.make_pose2d_targets_coco18, tsd.make_pose2d_targets_coco18)):
        ref, out = jfn(jnp.asarray(j2d), 23), tfn(t(j2d), 23)
        for a, b in zip(out, ref):
            close(a, b, tol=1e-6)
    b25 = rng.uniform(-0.9, 0.9, (3, 25, 2)).astype(np.float32)
    valid = (rng.rand(3, 25) > 0.3).astype(np.float32)
    b25[valid == 0] = np.nan  # decoders emit NaN at invalid joints
    ref = jsd.make_pose2d_targets_b25(jnp.asarray(b25), jnp.asarray(valid), 23)
    out = tsd.make_pose2d_targets_b25(t(b25), t(valid), 23)
    for a, b in zip(out, ref):
        assert np.isfinite(n(a)).all()
        close(a, b, tol=1e-6)
    out, valid = tsd.body25_from_cocoplus(t(j2d))
    ref, jvalid = jsd.body25_from_cocoplus(jnp.asarray(j2d))
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(n(out), np.asarray(ref))


# --- the JAX package's property tests (tests/test_tools/test_synth_data.py), on
# --- the port's own draws


def _draws(seed):
    return tsd.Draws(torch.Generator().manual_seed(seed), "cpu")


def test_compose_scene_labels_consistent(bodies):
    tm, ta = bodies[2:]
    sb = tsd.compose_scene(_draws(0), tm, ta, batch=2, size=64, photo=False)
    assert sb.img.shape == (2, 64, 64, 3) and sb.alpha.shape == (2, 64, 64, 1)
    assert sb.theta.shape == (2, 85) and sb.j2d.shape == (2, 19, 2)
    assert float((torch.abs(sb.img - sb.bg) * (1 - sb.alpha)).mean()) < 0.1
    assert 0.02 < float(sb.mask.mean()) < 0.6
    for f in sb._fields:
        assert torch.isfinite(getattr(sb, f)).all(), f


def test_compose_scene_photo_domain(bodies):
    tm, ta = bodies[2:]
    sb = tsd.compose_scene(_draws(0), tm, ta, batch=2, size=64, studio_frac=0.5,
                           garment_frac=0.5, natural_frac=0.65)
    assert float(sb.img.abs().max()) <= 1.0 + 1e-5
    assert 0.02 < float(sb.mask.mean()) < 0.6
    for f in sb._fields:
        assert torch.isfinite(getattr(sb, f)).all(), f


def test_make_theta_yaw_distribution():
    mags = n(tsd.make_theta(_draws(1), 64)[:, 3:6]).astype(np.float64)
    mags = np.linalg.norm(mags, axis=1)
    assert mags.max() > 2.0 and mags.std() > 0.5


def test_pose2d_target_peaks_and_weights():
    hm, paf, hm_w, paf_w = tsd.make_pose2d_targets(torch.zeros((1, 19, 2)), 16)
    assert hm.shape == (1, 16, 16, 26) and paf.shape == (1, 16, 16, 52)
    iy, ix = np.unravel_index(n(hm[0, :, :, 0]).argmax(), (16, 16))
    assert abs(iy - 8) <= 1 and abs(ix - 8) <= 1
    assert hm_w[19:25].sum() == 0.0 and hm_w[:19].sum() == 19.0


def test_random_holes_coverage():
    holes = tsd.random_holes(_draws(3), 4, 64)
    assert holes.shape == (4, 64, 64, 1)
    m = n(holes).mean(axis=(1, 2, 3))
    assert (m > 0.0).all() and (m < 0.9).all()


def test_draws_shapes_and_ranges():
    d = _draws(5)
    u = d.uniform((1000,), -2.0, 3.0)
    assert u.shape == (1000,) and float(u.min()) >= -2.0 and float(u.max()) < 3.0
    assert d.bernoulli(0.3, (4, 1)).dtype == torch.bool
    r = d.randint((500,), 0, 3)
    assert set(r.tolist()) == {0, 1, 2}
    w = d.dirichlet([1.0, 1.0, 1.0], (7,))
    assert w.shape == (7, 3) and torch.allclose(w.sum(-1), torch.ones(7)) and float(w.min()) >= 0
    assert d.normal((2, 3)).shape == (2, 3)
    a, b = n(_draws(9).uniform((5,))), n(_draws(9).uniform((5,)))
    np.testing.assert_array_equal(a, b)
