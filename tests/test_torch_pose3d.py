"""3D pose of preprocessing: SPIN, the priors, SMPLify and the camera and SMPL
helpers they call, JAX package vs the PyTorch port on the same numpy inputs
(CPU).

SPIN runs on the published `spin.npz` (on disk, or its blob from git history
through `history_weights`) at batch 2; SMPLify on the JAX tests' small body
(`synthetic_model(nu=16, nv=14)`) for a few Adam steps. The JAX fits scan
`optax.adam` under `lax.scan`; the port loops `torch.autograd.grad` and its
own Adam, held here against optax too.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ipercore_tpu.models import smpl as jsmpl
from ipercore_tpu.ops import rotations as jrot
from ipercore_tpu.tools import pose3d as jp3
from ipercore_tpu.utils import camera as jcam
from ipercore_tpu.utils import torch_convert as jconv
from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.ops import rotations as trot
from ipercore_tpu_torch.tools import pose3d as tp3
from ipercore_tpu_torch.trainers.lwg_trainer import Adam
from ipercore_tpu_torch.utils import camera as tcam
from ipercore_tpu_torch.utils import torch_convert as tconv
from ipercore_tpu_torch.utils.checkpoint import load_flat_npz, seeded_flat_params

from tests.test_torch_common import flatten_flax, history_weights, n, small_models, t, unflatten_to_jax

GMM_NPZ = jp3.GMM_DEFAULT_WEIGHTS


@pytest.fixture(scope="module")
def models():
    return small_models(16, 14)


@pytest.fixture(scope="module")
def spin_flat(tmp_path_factory):
    """The published weights, stored in f16, cast to f32 as both packages'
    loaders cast them (JAX's `load_params(like=)`, the port's carrier): JAX
    given the f16 arrays themselves would compute its batch norms in f16."""
    flat = load_flat_npz(history_weights("spin", tmp_path_factory))
    assert all(v.dtype == np.float16 for v in flat.values())
    return {k: v.astype(np.float32) for k, v in flat.items()}


def _images(count: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, (count, 224, 224, 3)).astype(np.float32)


# --- SPIN -------------------------------------------------------------------

def test_spin_runner_on_published_weights_matches_jax(spin_flat):
    """Three crops at batch 2 (the tail padded to a whole batch) through both
    runners: theta within 1e-4. The strict carrier takes the file with no
    missing and no extra key."""
    net = tp3.SPINNet()
    assert set(tconv._finish(*tconv._mutable_like(net))) == set(spin_flat)
    runner = tp3.SPINRunner(params=spin_flat, device="cpu")
    assert runner.trained
    imgs = _images(3, 0)
    got = runner.run(imgs, batch_size=2)
    want = jp3.SPINRunner(params=unflatten_to_jax(spin_flat)).run(imgs, batch_size=2)
    assert got.shape == (3, 85)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_spin_net_forward_outputs_match_jax(spin_flat):
    """The raw (pose6d, shape, cam) heads on two ImageNet-normalized crops."""
    x = _images(2, 1) * 2.0
    want = jp3.SPINNet().apply(unflatten_to_jax(spin_flat), jnp.asarray(x))
    net = tp3.SPINNet()
    tp3.load_generator_params(net, spin_flat)
    with torch.no_grad():
        got = net(t(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-4, rtol=0)


def test_spin_runner_defaults_to_the_seeded_weights(tmp_path):
    runner = tp3.SPINRunner(weights_path=str(tmp_path / "none.npz"), device="cpu")
    assert not runner.trained
    seeded = seeded_flat_params(tp3.SPINNet(), tp3.SPIN_SEED)
    assert set(runner.params) == set(seeded)
    for k in seeded:
        np.testing.assert_array_equal(runner.params[k], seeded[k])
    # the Flax initializer's constant camera, not zeros
    np.testing.assert_array_equal(seeded["params/init_cam"], np.float32([[0.9, 0.0, 0.0]]))


def test_spin_output_to_theta_matches_jax():
    rng = np.random.RandomState(2)
    pose6d, shape, cam = (rng.randn(3, 144), rng.randn(3, 10), rng.randn(3, 3))
    pose6d = pose6d.astype(np.float32)
    want = jp3.spin_output_to_theta(jnp.asarray(pose6d), jnp.asarray(shape, jnp.float32),
                                    jnp.asarray(cam, jnp.float32))
    got = tp3.spin_output_to_theta(t(pose6d), t(shape), t(cam))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=0)


def _torchvision_spin_state_dict(flat: dict, seed: int) -> dict:
    """A SPIN `model_checkpoint.pt` layout (torchvision names, torch shapes)
    with random values, built from the flat keys by the name map's inverse."""
    rng = np.random.RandomState(seed)
    bn = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    sd = {}
    for key, arr in flat.items():
        parts = key.split("/")[1:]
        if parts[0].startswith("init_"):
            sd[parts[0]] = rng.randn(*arr.shape).astype(np.float32)
            continue
        leaf = parts[-1]
        if parts[0] == "regressor":
            name = parts[1]
            shape = arr.shape[::-1] if leaf == "kernel" else arr.shape
        else:
            mod = parts[1:-1]
            if mod[0].startswith("layer"):
                l, b = mod[0][5:].split("_")
                sub = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(mod[1], mod[1])
                name = f"layer{l}.{b}.{sub}"
            else:
                name = mod[0]
            shape = (arr.shape[3], arr.shape[2], arr.shape[0], arr.shape[1]) if leaf == "kernel" else arr.shape
        tleaf = "weight" if leaf == "kernel" else bn.get(leaf, leaf) if "bn" in name or name.endswith("downsample.1") \
            else leaf
        sd[f"{name}.{tleaf}"] = rng.randn(*shape).astype(np.float32)
    return sd


def test_convert_spin_matches_jax():
    flat = seeded_flat_params(tp3.SPINNet(), 3)
    sd = _torchvision_spin_state_dict(flat, 4)
    # entries absent or misshapen: both report them alike and keep `like` there
    for k in ("layer4.2.bn3.running_var", "deccam.bias", "fc2.weight", "init_shape"):
        sd.pop(k)
    sd["layer2.0.conv2.weight"] = sd["layer2.0.conv2.weight"][:, :, :1]
    got, rep_t = tconv.convert_spin(sd, flat)
    want, rep_j = jconv.convert_spin(sd, unflatten_to_jax(flat))
    want = flatten_flax(want)
    assert rep_t == rep_j == [
        "SHAPE backbone/layer2_0/conv2/kernel: have (3, 3, 128, 128), got (1, 3, 128, 128)",
        "ABSENT fc2", "ABSENT init_shape"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    full, rep = tconv.convert_spin(_torchvision_spin_state_dict(flat, 5), tp3.SPINNet())
    assert rep == [] and set(full) == set(flat)


# --- camera and SMPL helpers -------------------------------------------------

def test_cam_init2orig_and_cam_norm_match_jax():
    rng = np.random.RandomState(3)
    cam = np.concatenate([rng.uniform(0.5, 1.5, (4, 1)), rng.randn(4, 2) * 0.1], 1).astype(np.float32)
    scale = rng.uniform(0.1, 0.5, (4, 1)).astype(np.float32)
    start = rng.uniform(0, 300, (4, 2)).astype(np.float32)
    got = tcam.cam_init2orig(t(cam), t(scale), t(start))
    want = jcam.cam_init2orig(cam, scale, start)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(tcam.cam_norm(got, 512)), np.asarray(jcam.cam_norm(want, 512)),
                               rtol=1e-6, atol=1e-6)


def test_pad_theta_with_hands_and_lbs_from_rot_match_jax():
    jm = jsmpl.synthetic_model(n_joints=52, nu=12, nv=10)
    tm = tsmpl.synthetic_model(n_joints=52, nu=12, nv=10, device="cpu")
    rng = np.random.RandomState(4)
    theta = (rng.randn(3, 85) * 0.2).astype(np.float32)
    padded = tsmpl.pad_theta_with_hands(t(theta), tm)
    assert padded.shape == (3, tsmpl.THETA_DIM_HAND) and tsmpl.THETA_DIM == 85
    np.testing.assert_allclose(n(padded), np.asarray(jsmpl.pad_theta_with_hands(jnp.asarray(theta), jm)),
                               atol=1e-5, rtol=0)
    pose = n(padded)[:, 3:-10]
    shape = theta[:, 75:]
    rot = np.asarray(jrot.rodrigues(jnp.asarray(pose.reshape(3, 52, 3))))
    want = jax.vmap(lambda s, r: jsmpl.lbs_from_rot(jm, s, r))(jnp.asarray(shape), jnp.asarray(rot))
    got = tsmpl.lbs_from_rot(tm, t(shape), t(rot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-5, rtol=0)


def test_get_details_with_shared_offsets_matches_jax(models):
    """The (V, 3) offsets the silhouette fit passes, shared by every frame."""
    jm, tm = models
    rng = np.random.RandomState(5)
    theta = np.concatenate([np.full((3, 1), 1.2), rng.randn(3, 84) * 0.1], 1).astype(np.float32)
    off = (rng.randn(tm.v_template.shape[0], 3) * 0.02).astype(np.float32)
    want = jsmpl.get_details(jm, jnp.asarray(theta), offsets=jnp.asarray(off))
    got = tsmpl.get_details(tm, t(theta), offsets=t(off))
    for k in ("verts", "j3d", "j2d"):
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), atol=1e-5, rtol=0)


# --- rotations: the gradient SMPLify takes through identity rotations ---------

@pytest.mark.parametrize("case", ["zero", "generic", "near_pi"])
def test_rotmat_to_axis_angle_gradient_matches_jax(case):
    """d(sum w . aa)/dR at rotations of angle 0, a generic angle and within
    1e-3 of pi (the three branches): finite, and within 1e-5 of JAX's."""
    rng = np.random.RandomState(6)
    axis = rng.randn(4, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = {"zero": np.zeros(4), "generic": rng.uniform(0.3, 2.5, 4),
             "near_pi": np.pi - rng.uniform(1e-4, 9e-4, 4)}[case]
    R = np.asarray(jrot.rodrigues(jnp.asarray((axis * angle[:, None]).astype(np.float32))))
    w = rng.randn(4, 3).astype(np.float32)
    want = np.asarray(jax.grad(lambda r: jnp.sum(jrot.rotmat_to_axis_angle(r) * w))(jnp.asarray(R)))
    Rt = t(R).requires_grad_(True)
    (got,) = torch.autograd.grad((trot.rotmat_to_axis_angle(Rt) * t(w)).sum(), [Rt])
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(n(got), want, atol=1e-5, rtol=1e-5)


# --- the priors ----------------------------------------------------------------

def test_gmof_angle_prior_and_gmm_nll_match_jax():
    rng = np.random.RandomState(7)
    x = (rng.randn(5, 19, 2) * 50).astype(np.float32)
    np.testing.assert_allclose(n(tp3.gmof(t(x))), np.asarray(jp3.gmof(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(tp3.gmof(t(x), 3.0)), np.asarray(jp3.gmof(jnp.asarray(x), 3.0)),
                               rtol=1e-5, atol=1e-5)
    pose = (rng.randn(5, 72) * 0.5).astype(np.float32)
    np.testing.assert_allclose(n(tp3.angle_prior(t(pose))), np.asarray(jp3.angle_prior(jnp.asarray(pose))),
                               rtol=1e-5, atol=1e-5)
    jprior = jp3.load_gmm_prior(GMM_NPZ)
    tprior = tp3.load_gmm_prior(GMM_NPZ, device="cpu")
    body = (rng.randn(5, 69) * 0.3).astype(np.float32)
    np.testing.assert_allclose(n(tp3.gmm_prior_nll(tprior, t(body))),
                               np.asarray(jp3.gmm_prior_nll(jprior, jnp.asarray(body))), rtol=1e-5, atol=1e-4)


def test_load_gmm_prior_and_fit_gmm_raw_equal_jax():
    jprior = jp3.load_gmm_prior(GMM_NPZ)
    tprior = tp3.load_gmm_prior(GMM_NPZ, device="cpu")
    for a, b in zip(tprior, jprior):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    assert tp3.load_gmm_prior("/nonexistent/gmm.npz", device="cpu") is None
    samples = np.random.RandomState(8).randn(60, 69) * 0.2
    for a, b in zip(tp3.fit_gmm_raw(samples, k=4, seed=3), jp3.fit_gmm_raw(samples, k=4, seed=3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tp3.fit_gmm_prior(samples, k=4, seed=3, device="cpu"), jp3.fit_gmm_prior(samples, k=4, seed=3)):
        np.testing.assert_array_equal(n(a), np.asarray(b))


# --- SMPLify --------------------------------------------------------------------

def _scene(jm, count=2, seed=0):
    """`test_pose3d_multi._gt_scene`: temporally coherent thetas near the
    natural stance, their keypoints, and a 10 % share of zero confidences."""
    rng = np.random.RandomState(seed)
    base = jp3.natural_stance_aa() + 0.08 * rng.randn(72).astype(np.float32)
    pose = np.tile(base[None], (count, 1)) + 0.01 * rng.randn(count, 72).astype(np.float32)
    cam = np.stack([np.full(count, 1.4 + 0.2 * rng.rand()), np.full(count, 0.1 * rng.randn()),
                    np.full(count, 0.1 * rng.randn())], axis=1)
    shape = np.tile(0.3 * rng.randn(10)[None], (count, 1))
    theta = np.concatenate([cam, pose, shape], axis=1).astype(np.float32)
    j2d = np.asarray(jsmpl.get_details(jm, jnp.asarray(theta))["j2d"])
    j2d = (j2d + 0.01 * rng.randn(*j2d.shape)).astype(np.float32)
    conf = np.ones(j2d.shape[:2], np.float32)
    conf[rng.rand(*conf.shape) < 0.1] = 0.0
    return theta, j2d, conf


def _bad_init(theta):
    bad = theta.copy()
    bad[:, 3:75] = 0.0
    bad[:, 0] = 0.5
    bad[:, 1:3] += 0.8
    return bad


def test_natural_stance_matches_jax():
    np.testing.assert_array_equal(tp3.natural_stance_aa(), jp3.natural_stance_aa())


def test_keypoint_cam_init_and_reprojection_error_match_jax(models):
    jm, tm = models
    theta, j2d, conf = _scene(jm, 3, seed=1)
    want = jp3.keypoint_cam_init(jm, jnp.asarray(j2d), jnp.asarray(conf))
    got = tp3.keypoint_cam_init(tm, t(j2d), t(conf))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=0)
    pose = (np.random.RandomState(2).randn(72) * 0.1).astype(np.float32)
    np.testing.assert_allclose(n(tp3.keypoint_cam_init(tm, t(j2d), t(conf), pose_aa=pose)),
                               np.asarray(jp3.keypoint_cam_init(jm, jnp.asarray(j2d), jnp.asarray(conf), pose)),
                               atol=1e-5, rtol=0)
    for th in (theta, _bad_init(theta)):
        np.testing.assert_allclose(
            n(tp3.reprojection_error(tm, t(th), t(j2d), t(conf))),
            np.asarray(jp3.reprojection_error(jm, jnp.asarray(th), jnp.asarray(j2d), jnp.asarray(conf))),
            atol=1e-5, rtol=0)


def test_smplify_loss_gradient_matches_jax(models):
    """The gradient of the fit's objective at the bad init, with the GMM
    prior, against `jax.grad` of the same objective (JAX's `loss_fn`, spelled
    out here as `smplify_refine` closes over it): within 1e-4 relative."""
    jm, tm = models
    theta, j2d, conf = _scene(jm, 3, seed=2)
    bad = _bad_init(theta)
    cfg = jp3.SMPLifyConfig()
    jprior = jp3.load_gmm_prior(GMM_NPZ)
    nfr = bad.shape[0]
    pose0 = jrot.axis_angle_to_rot6d(jnp.asarray(bad[:, 3:75]).reshape(nfr, 24, 3)).reshape(nfr, 144)
    params = (pose0 + 0.05, jnp.asarray(bad[:, 75:]) + 0.1, jnp.asarray(bad[:, :3]))

    def loss_fn(p):
        pose6d, shape, cam = p
        aa = jrot.rotmat_to_axis_angle(jrot.rot6d_to_rotmat(pose6d.reshape(nfr, 24, 6))).reshape(nfr, 72)
        th = jnp.concatenate([cam, aa, shape], axis=-1)
        d = jsmpl.get_details(jm, th)
        j2, j3 = d["j2d"], d["j3d"]
        kp, kc = jnp.asarray(j2d), jnp.asarray(conf)
        total = (cfg.w_reproj * jnp.sum(kc[..., None] * jp3.gmof(j2 - kp, cfg.kp_sigma))
                 + jnp.sum(jp3.gmm_prior_nll(jprior, th[:, 6:75]) * cfg.w_gmm)
                 + cfg.w_shape_reg * jnp.sum(shape ** 2) + cfg.w_angle * jnp.sum(jp3.angle_prior(th[:, 3:75])))
        temporal = cfg.w_temporal * jnp.sum((pose6d[1:] - pose6d[:-1]) ** 2)
        temporal += cfg.w_smooth_j2d * jnp.sum(kc[1:] ** 2 * jnp.sum(jnp.abs(j2[1:] - j2[:-1]), axis=-1))
        temporal += cfg.w_smooth_j3d * jnp.sum((j3[1:] - j3[:-1]) ** 2)
        return total + temporal

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    tparams = {k: t(np.asarray(v)).requires_grad_(True) for k, v in zip(("pose", "shape", "cam"), params)}
    loss = tp3.smplify_loss(tm, tparams, t(np.asarray(pose0)), t(j2d), t(conf), tp3.SMPLifyConfig(),
                            tp3.load_gmm_prior(GMM_NPZ, device="cpu"))
    got = torch.autograd.grad(loss, list(tparams.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all() and torch.isfinite(g).all()
        np.testing.assert_allclose(n(g), w, atol=1e-4 * np.abs(w).max(), rtol=1e-4)


def test_adam_matches_plain_optax_adam():
    """`Adam(lr, grad_clip=0, b1=0.9, skip_nonfinite=False)` is `optax.adam`:
    three steps on two leaves, one gradient NaN on the third (applied, as
    optax applies it)."""
    rng = np.random.RandomState(9)
    p = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()} for _ in range(3)]
    grads[2]["b"][1] = np.nan
    tx = optax.adam(0.02)
    jparams = {k: jnp.asarray(v) for k, v in p.items()}
    jstate = tx.init(jparams)
    opt = Adam(0.02, grad_clip=0.0, b1=0.9, skip_nonfinite=False)
    tparams = {k: t(v) for k, v in p.items()}
    tstate = opt.init(tparams)
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tparams, tstate = opt.apply({k: t(v) for k, v in g.items()}, tstate, tparams)
    for k in p:
        np.testing.assert_allclose(n(tparams[k]), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7)
    assert int(tstate.count) == 3 and np.isnan(n(tparams["b"])[1])


@pytest.mark.parametrize("with_prior", [False, True])
def test_smplify_refine_matches_jax(models, with_prior):
    """Five Adam steps from the bad init, with the L2 pose term or the GMM
    prior: theta within 1e-4."""
    jm, tm = models
    theta, j2d, conf = _scene(jm, 2, seed=3)
    bad = _bad_init(theta)
    jcfg = jp3.SMPLifyConfig(n_iters=5)
    want = jp3.smplify_refine(jm, jnp.asarray(bad), jnp.asarray(j2d), jnp.asarray(conf), jcfg,
                              jp3.load_gmm_prior(GMM_NPZ) if with_prior else None)
    got = tp3.smplify_refine(tm, t(bad), t(j2d), t(conf), tp3.SMPLifyConfig(n_iters=5),
                             tp3.load_gmm_prior(GMM_NPZ, device="cpu") if with_prior else None)
    assert np.isfinite(np.asarray(want)).all()
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4, rtol=0)


def test_smplify_refine_multi_matches_jax(models):
    """Both hypotheses, the per-frame selection and the final pass at a few
    steps (n_iters 6: final pass 10): the same frames take the natural-stance
    hypothesis and keep the final pass, and theta agrees within 1e-4."""
    jm, tm = models
    theta, j2d, conf = _scene(jm, 2, seed=4)
    bad = _bad_init(theta)
    bad[1, 3:75] = theta[1, 3:75] + 0.02  # one frame starts close: its SPIN hypothesis can win
    prior_j = jp3.load_gmm_prior(GMM_NPZ)
    prior_t = tp3.load_gmm_prior(GMM_NPZ, device="cpu")
    args_j = (jnp.asarray(j2d), jnp.asarray(conf))
    args_t = (t(j2d), t(conf))
    cfg_j, cfg_t = jp3.SMPLifyConfig(n_iters=6), tp3.SMPLifyConfig(n_iters=6)

    want = jp3.smplify_refine_multi(jm, jnp.asarray(bad), *args_j, cfg_j, prior_j)
    got = tp3.smplify_refine_multi(tm, t(bad), *args_t, cfg_t, prior_t)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4, rtol=0)

    def selections(mod, model, init, args, cfg, prior, to_np):
        h0 = mod.smplify_refine(model, init, *args, cfg, prior)
        h1 = mod.smplify_refine(model, mod.keypoint_cam_init(model, *args), *args, cfg, prior)
        e0, e1 = (to_np(mod.reprojection_error(model, h, *args)) for h in (h0, h1))
        return e1 < e0, e0, e1

    sel_j, e0j, e1j = selections(jp3, jm, jnp.asarray(bad), args_j, cfg_j, prior_j, np.asarray)
    sel_t, e0t, e1t = selections(tp3, tm, t(bad), args_t, cfg_t, prior_t, n)
    np.testing.assert_array_equal(sel_t, sel_j)
    np.testing.assert_allclose(e0t, e0j, atol=1e-5)
    np.testing.assert_allclose(e1t, e1j, atol=1e-5)


def test_keypoint_camera_is_stationary_for_a_middle_frame(models):
    """Why the multi-hypothesis fit is held at 2 frames: at the keypoint-fit
    camera the reprojection term is at its least-squares optimum in (tx, ty),
    and for a middle frame of a monotonic 3-frame track the temporal 2D terms
    cancel too, so that frame's tx gradient is float noise (about 1e-8 here)
    in both packages. Adam's first step moves a coordinate by lr * g / (|g| +
    1e-8), so the noise becomes a move of up to lr there, different in each
    package. Pinned on both: the gradient is that small in JAX and in the port."""
    jm, tm = models
    theta, j2d, conf = _scene(jm, 3, seed=4)
    nat = np.asarray(jp3.keypoint_cam_init(jm, jnp.asarray(j2d), jnp.asarray(conf)))
    pose0 = np.asarray(jrot.axis_angle_to_rot6d(jnp.asarray(nat[:, 3:75]).reshape(3, 24, 3))).reshape(3, 144)
    params = {"pose": t(pose0).requires_grad_(True), "shape": t(nat[:, 75:]).requires_grad_(True),
              "cam": t(nat[:, :3]).requires_grad_(True)}
    loss = tp3.smplify_loss(tm, params, t(pose0), t(j2d), t(conf), tp3.SMPLifyConfig(),
                            tp3.load_gmm_prior(GMM_NPZ, device="cpu"))
    (g_cam,) = torch.autograd.grad(loss, [params["cam"]])
    g_cam = n(g_cam)
    one_step = np.asarray(jp3.smplify_refine(jm, jnp.asarray(nat), jnp.asarray(j2d), jnp.asarray(conf),
                                             jp3.SMPLifyConfig(n_iters=1), jp3.load_gmm_prior(GMM_NPZ)))
    assert abs(g_cam[1, 1]) < 1e-6 and np.abs(g_cam[[0, 2], 1]).min() > 1e-3
    # JAX's first step there moved tx by a sizeable fraction of lr (0.02) on noise alone
    assert 1e-3 < abs(one_step[1, 1] - nat[1, 1]) <= 0.02 + 1e-6
