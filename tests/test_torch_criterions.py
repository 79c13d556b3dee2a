"""Discriminators, loss networks and loss functions of the port against their
JAX twins: the same numpy inputs, the same weights (the JAX init carried over
by `flax_params_to_torch`), forward values and gradients (with respect to the
input and every parameter). Tolerances: outputs and gradients within 1e-4 of
the JAX value's largest magnitude (plus 1e-6; a parameter gradient also plus
1e-4 of the network's largest parameter gradient), the f32 rounding of another
summation order; the loss functions within 1e-6. Also: the seeded init has the
JAX init's keys and shapes, and the shipped VGG and face checkpoints (restored
from git history, never written into `assets/`) load strictly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipercore_tpu.models.networks import blocks as jblocks
from ipercore_tpu.models.networks import criterions as JC
from ipercore_tpu.models.networks import discriminators as JD
from ipercore_tpu_torch.models.networks import blocks as tblocks
from ipercore_tpu_torch.models.networks import criterions as TC
from ipercore_tpu_torch.models.networks import discriminators as TD
from ipercore_tpu_torch.utils import checkpoint as tckpt

from tests.test_torch_common import flatten_flax, history_weights, n, t

DIS_CFG = {"ndf": 8, "n_layers": 2, "max_nf_mult": 8, "use_sigmoid": False}
NARROW_VGG = ((4,), (8,), (8,), (8,), (8,))


def close(a, b, rel=1e-4, atol=1e-6):
    a, b = n(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    tol = rel * float(np.abs(b).max()) + atol
    assert float(np.abs(a - b).max()) <= tol, (float(np.abs(a - b).max()), tol)


def carry(module, params):
    """Load a JAX init into the torch module strictly; returns the module."""
    tckpt.load_generator_params(module, flatten_flax(params))
    return module


def grads_match(jfn, jparams, tmod, tfn, x, rel=1e-4):
    """`jfn(params, x)` and `tfn(x)` return one scalar each; their gradients
    with respect to x and every parameter agree."""
    jg_p, jg_x = jax.jit(jax.grad(jfn, argnums=(0, 1)))(jparams, jnp.asarray(x))
    tx = t(x).requires_grad_()
    params = dict(tmod.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    out = tfn(tx)
    got = torch.autograd.grad(out, [tx] + list(params.values()))
    close(got[0], jg_x, rel)
    want = tckpt.flax_params_to_torch(flatten_flax(jg_p), like=tmod.state_dict())
    # a bias that an instance norm cancels has a gradient of rounding noise:
    # every parameter gradient is held within `rel` of the largest one too
    scale = max(float(v.abs().max()) for v in want.values())
    for (k, _), g in zip(params.items(), got[1:]):
        close(g, n(want[k]), rel, atol=rel * scale)


def _weights(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --- discriminators ----------------------------------------------------------

@pytest.mark.parametrize("n_layers,sigmoid", [(2, False), (3, True)])
def test_patch_discriminator_matches_jax(n_layers, sigmoid):
    x = np.random.RandomState(0).uniform(-1, 1, (2, 64, 64, 6)).astype(np.float32)
    jd = JD.PatchDiscriminator(ndf=8, n_layers=n_layers, use_sigmoid=sigmoid)
    params = jax.jit(jd.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    td = carry(TD.PatchDiscriminator(ndf=8, n_layers=n_layers, use_sigmoid=sigmoid), params)
    want = jax.jit(jd.apply)(params, jnp.asarray(x))
    got = td(t(x))
    close(got, want)
    w = _weights(want.shape)
    grads_match(lambda p, a: jnp.sum(jd.apply(p, a) * w), params, td,
                lambda a: (td(a) * t(w)).sum(), x)


def _boxes(count, seed):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(-0.9, -0.1, (count, 2))
    hi = lo + rng.uniform(0.3, 0.9, (count, 2))
    return np.concatenate([lo, np.minimum(hi, 1.0)], 1).astype(np.float32)


@pytest.mark.parametrize("name,aug", [("patch", False), ("patch_global", True),
                                      ("patch_global_local", True),
                                      ("patch_global_body_head", False),
                                      ("patch_global_body_head", True), ("multi_scale", False)])
def test_discriminator_registry_matches_jax(name, aug):
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (2, 64, 64, 6)).astype(np.float32)
    bg = rng.uniform(-1, 1, (2, 64, 64, 4)).astype(np.float32)
    body, head = _boxes(2, 2), _boxes(2, 3)
    jd = JD.build_discriminator(name, DIS_CFG, use_aug_bg=aug)
    bg_j = jnp.asarray(bg) if aug else None
    params = jax.jit(jd.init)(jax.random.PRNGKey(0), jnp.asarray(x), bg_j, jnp.asarray(body),
                              jnp.asarray(head))
    # the aug-bg head takes the 4-channel background + mask (`bg_cond_nc`)
    td = carry(TD.build_discriminator(name, DIS_CFG, use_aug_bg=aug, device="cpu"), params)
    args_j = (bg_j, jnp.asarray(body), jnp.asarray(head))
    args_t = (t(bg) if aug else None, t(body), t(head))
    want = jax.jit(jd.apply)(params, jnp.asarray(x), *args_j)
    got = td(t(x), *args_t)
    heads = {"patch": 1, "patch_global": 2, "patch_global_local": 3, "multi_scale": 2}
    assert len(got) == len(want) == heads.get(name, 3 + aug)
    for a, b in zip(got, want):
        close(a, b)
    ws = [_weights(o.shape, seed=10 + i) for i, o in enumerate(want)]
    grads_match(lambda p, a: sum(jnp.sum(o * w) for o, w in zip(jd.apply(p, a, *args_j), ws)),
                params, td, lambda a: sum((o * t(w)).sum() for o, w in zip(td(a, *args_t), ws)), x)


def test_unknown_discriminator_raises():
    with pytest.raises(KeyError, match="unknown discriminator"):
        TD.build_discriminator("nope", DIS_CFG, device="cpu")


def test_crop_by_bbox_matches_jax():
    img = np.random.RandomState(4).uniform(-1, 1, (3, 40, 56, 5)).astype(np.float32)
    boxes = _boxes(3, 5)
    boxes[2] = [-1.2, -0.3, 0.4, 1.3]  # beyond the image: zero padding
    for hw in ((112, 96), (7, 3)):
        close(TD.crop_by_bbox(t(img), t(boxes), hw), JD.crop_by_bbox(jnp.asarray(img), jnp.asarray(boxes), hw))
    w = _weights((3, 112, 96, 5))
    jg = jax.jit(jax.grad(lambda a: jnp.sum(JD.crop_by_bbox(a, jnp.asarray(boxes), (112, 96)) * w)))(
        jnp.asarray(img))
    ti = t(img).requires_grad_()
    (TD.crop_by_bbox(ti, t(boxes), (112, 96)) * t(w)).sum().backward()
    close(ti.grad, jg)


# --- VGG -----------------------------------------------------------------------

def test_vgg_features_and_perceptual_loss_match_jax():
    rng = np.random.RandomState(6)
    pred = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jv = JC.VGGFeatures(slices=NARROW_VGG)
    params = jax.jit(jv.init)(jax.random.PRNGKey(1), jnp.asarray(pred))
    tv = carry(TC.VGGFeatures(slices=NARROW_VGG), params)
    for a, b in zip(tv(t(pred)), jax.jit(jv.apply)(params, jnp.asarray(pred))):
        close(a.permute(0, 2, 3, 1), b)  # the port's maps are NCHW
    want = jax.jit(lambda p, a, b: JC.perceptual_loss(p, jv.apply, a, b))(
        params, jnp.asarray(pred), jnp.asarray(target))
    close(TC.perceptual_loss(tv, t(pred), t(target)), want)
    grads_match(lambda p, a: JC.perceptual_loss(p, jv.apply, a, jnp.asarray(target)), params, tv,
                lambda a: TC.perceptual_loss(tv, a, t(target)), pred)


@pytest.mark.parametrize("vgg_type", ["VGG19", "VGG16", "VGG11"])
def test_build_vgg_and_seeded_init_have_the_jax_layout(vgg_type):
    jv = JC.build_vgg(vgg_type)
    shapes = jax.eval_shape(jv.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    want = {k: tuple(v.shape) for k, v in flatten_flax_shapes(shapes).items()}
    tv = TC.build_vgg(vgg_type, device="cpu")
    flat = tckpt.seeded_flat_params(tv, 2)
    assert {k: v.shape for k, v in flat.items()} == want
    assert not any(p.requires_grad for p in tv.parameters())
    TC.init_vgg_params(tv, seed=2)  # no shipped weights for VGG16/11: seeded
    if vgg_type != "VGG19":
        np.testing.assert_array_equal(n(tv.conv0_0.weight), flat["params/conv0_0/kernel"].transpose(3, 2, 0, 1))


def flatten_flax_shapes(tree, prefix=""):
    out = {}
    if hasattr(tree, "keys"):
        for k in tree.keys():
            out.update(flatten_flax_shapes(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def test_shipped_vgg_weights_load_strictly(tmp_path_factory):
    path = history_weights("vgg_perceptual", tmp_path_factory)
    tv = TC.init_vgg_params(TC.build_vgg(device="cpu"), weights_path=path)
    jv = JC.VGGFeatures()
    like = jax.eval_shape(jv.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    from ipercore_tpu.utils.checkpoint import load_params as jload

    jparams = jload(path, like=like)
    x = np.random.RandomState(8).uniform(-1, 1, (1, 48, 48, 3)).astype(np.float32)
    for a, b in zip(tv(t(x)), jax.jit(jv.apply)(jparams, jnp.asarray(x))):
        close(a.permute(0, 2, 3, 1), b, rel=2e-4)


def test_explicit_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        TC.init_vgg_params(TC.build_vgg(device="cpu"), weights_path=str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError):
        TC.init_face_params(str(tmp_path / "none.npz"), device="cpu")


# --- face nets -------------------------------------------------------------------

@pytest.fixture(scope="module")
def sphere():
    jf = JC.SphereFaceFeatures()
    params = jax.jit(jf.init)(jax.random.PRNGKey(2), jnp.zeros((1, 112, 96, 3)))
    tf, hw = TC.build_face_net("sphere20a", device="cpu")
    assert hw == (112, 96)
    return jf, params, carry(tf, params)


def test_sphereface_matches_jax(sphere):
    jf, params, tf = sphere
    x = np.random.RandomState(9).uniform(-1, 1, (2, 112, 96, 3)).astype(np.float32)
    got, want = tf(t(x)), jax.jit(jf.apply)(params, jnp.asarray(x))
    assert len(got) == len(want) == 5 and got[-1].shape == (2, 512)
    for a, b in zip(got, want):
        close(a, b)
    w = [_weights(o.shape, seed=20 + i) for i, o in enumerate(want)]
    grads_match(lambda p, a: sum(jnp.sum(o * v) for o, v in zip(jf.apply(p, a), w)), params, tf,
                lambda a: sum((o * t(v)).sum() for o, v in zip(tf(a), w)), x)


@pytest.mark.parametrize("with_boxes", [True, False])
def test_face_loss_matches_jax(sphere, with_boxes):
    jf, params, tf = sphere
    rng = np.random.RandomState(10)
    pred = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    box = _boxes(2, 11) if with_boxes else None
    jb = jnp.asarray(box) if with_boxes else None
    tb = t(box) if with_boxes else None
    loss = lambda a: JC.face_loss(params, jf.apply, a, jnp.asarray(target), jb, jb)
    close(TC.face_loss(tf, t(pred), t(target), tb, tb), jax.jit(loss)(jnp.asarray(pred)))
    # un-jitted: XLA's fusions under jit move the gradient by up to 4e-6 here,
    # against 2e-9 between the eager JAX gradient and the port's
    jg = jax.grad(loss)(jnp.asarray(pred))
    tp = t(pred).requires_grad_()
    TC.face_loss(tf, tp, t(target), tb, tb).backward()
    close(tp.grad, jg)


def test_senet_matches_jax():
    x = np.random.RandomState(12).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    jf, hw = JC.build_face_net("/w/senet50_ft.npz")
    assert hw == (224, 224)
    params = jax.jit(jf.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    # non-trivial frozen batch norms
    flat = flatten_flax(params)
    rng = np.random.RandomState(13)
    for k in flat:
        if k.endswith(("/scale", "/var")):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
        elif k.endswith("/mean"):
            flat[k] = rng.uniform(-0.1, 0.1, flat[k].shape).astype(np.float32)
    from tests.test_torch_common import unflatten_to_jax

    params = unflatten_to_jax(flat)
    tf, thw = TC.build_face_net("/w/senet50_ft.npz", device="cpu")
    assert thw == hw
    tckpt.load_generator_params(tf, flat)
    got, want = tf(t(x)), jax.jit(jf.apply)(params, jnp.asarray(x))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        close(a, b, rel=2e-4)
    seeded = tckpt.seeded_flat_params(tf, 3)
    assert {k: v.shape for k, v in seeded.items()} == {k: v.shape for k, v in flat.items()}
    assert (seeded["params/bn1/scale"] == 1).all() and (seeded["params/layer1_0/bn3/var"] == 1).all()
    assert (seeded["params/bn1/mean"] == 0).all()


def test_shipped_face_weights_load_strictly(tmp_path_factory, sphere):
    jf, jinit, _ = sphere
    path = history_weights("faceloss", tmp_path_factory)
    tf, hw = TC.init_face_params(path, device="cpu")
    from ipercore_tpu.utils.checkpoint import load_params as jload

    jparams = jload(path, like=jinit)
    x = np.random.RandomState(14).uniform(-1, 1, (1, 112, 96, 3)).astype(np.float32)
    for a, b in zip(tf(t(x)), jax.jit(jf.apply)(jparams, jnp.asarray(x))):
        close(a, b, rel=2e-4)


def test_seeded_face_init_matches_the_jax_layout(sphere):
    _, params, _ = sphere
    tf, _ = TC.init_face_params("random", seed=3, device="cpu")
    flat = tckpt.seeded_flat_params(tf, 3)
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in flatten_flax(params).items()}
    assert (flat["params/relu3_5/weight"] == 0.25).all() and (flat["params/fc5/bias"] == 0).all()
    np.testing.assert_array_equal(n(tf.fc5.weight), flat["params/fc5/kernel"].T)
    again = TC.init_face_params("random", seed=3, device="cpu")[0]
    assert torch.equal(again.conv2_1.weight, tf.conv2_1.weight)


def test_frozen_batch_norm_matches_jax():
    rng = np.random.RandomState(15)
    x = rng.randn(2, 5, 4, 6).astype(np.float32)
    vals = {k: rng.uniform(0.5, 1.5, 6).astype(np.float32) for k in ("scale", "bias", "mean", "var")}
    want = jblocks.FrozenBatchNorm(6).apply({"params": vals}, jnp.asarray(x))
    bn = tblocks.FrozenBatchNorm(6)
    tckpt.load_generator_params(bn, {f"params/{k}": v for k, v in vals.items()})
    close(bn(t(x)), want)


# --- loss functions -------------------------------------------------------------

def test_gan_and_regularization_losses_match_jax():
    rng = np.random.RandomState(16)
    outs = [rng.randn(2, 5, 5, 1).astype(np.float32), rng.randn(2, 3, 2, 1).astype(np.float32),
            np.zeros((2, 0, 0, 1), np.float32)]  # a crop that collapsed
    for target in (0.0, 1.0, -1.0):
        close(TC.lsgan_loss([t(o) for o in outs], target),
              JC.lsgan_loss([jnp.asarray(o) for o in outs], target), rel=1e-6)
    mask = rng.rand(3, 8, 7, 1).astype(np.float32)
    frames = rng.randn(2, 4, 6, 5, 3).astype(np.float32)
    a, b = rng.randn(4, 9).astype(np.float32), rng.randn(4, 9).astype(np.float32)
    close(TC.tv_loss(t(mask)), JC.tv_loss(jnp.asarray(mask)), rel=1e-6)
    close(TC.temporal_smooth_loss(t(frames)), JC.temporal_smooth_loss(jnp.asarray(frames)), rel=1e-6)
    close(TC.l1_loss(t(a), t(b)), JC.l1_loss(jnp.asarray(a), jnp.asarray(b)), rel=1e-6)
    jg = jax.grad(lambda m: JC.tv_loss(m))(jnp.asarray(mask))
    tm = t(mask).requires_grad_()
    TC.tv_loss(tm).backward()
    close(tm.grad, jg, rel=1e-6)


def test_mask_bce_matches_jax_at_the_clip_bounds():
    """Values exactly at the bounds of the clip get half the gradient in both."""
    rng = np.random.RandomState(17)
    pred = rng.rand(2, 6, 5, 1).astype(np.float32)
    pred[0, 0, :3, 0] = [np.float32(1e-6), np.float32(1.0 - 1e-6), 0.0]
    pred[1, 2, :2, 0] = [1.0, 0.5]
    target = (rng.rand(2, 6, 5, 1) > 0.5).astype(np.float32)
    want = JC.mask_bce_loss(jnp.asarray(pred), jnp.asarray(target))
    close(TC.mask_bce_loss(t(pred), t(target)), want, rel=1e-6)
    jg = np.asarray(jax.grad(lambda p: JC.mask_bce_loss(p, jnp.asarray(target)))(jnp.asarray(pred)))
    tp = t(pred).requires_grad_()
    TC.mask_bce_loss(tp, t(target)).backward()
    close(tp.grad, jg, rel=1e-6)
    assert jg[0, 0, 0, 0] != 0 and jg[0, 0, 2, 0] == 0  # the tie passes half, the clipped none
