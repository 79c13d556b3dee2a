"""Networks and the weight carrier: a generator initialised by JAX, its
weights carried across by `flax_params_to_torch`, the same numpy inputs through
both packages (CPU)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from ipercore_tpu.models.networks import blocks as jblocks
from ipercore_tpu.models.networks import build_generator as jbuild
from ipercore_tpu_torch.models.networks import blocks as tblocks
from ipercore_tpu_torch.models.networks import build_generator as tbuild
from ipercore_tpu_torch.utils import checkpoint as tckpt

from tests.test_torch_common import (
    FULL_CFG,
    NARROW_CFG,
    flatten_flax,
    n,
    pretrained_generator_npz,
    t,
    unflatten_to_jax,
)


def _init_jax(cfg, S=32, ns=2, stride=1):
    gen = jbuild("AttLWB-SPADE", cfg, feat_warp_stride=stride)
    params = jax.jit(lambda r: gen.init(
        r, jnp.zeros((1, 1, S, S, 4)), jnp.zeros((1, ns, S, S, 6)),
        jnp.zeros((1, 1, S, S, 6)), jnp.zeros((1, 1, ns, S, S, 2)), None, False))(jax.random.PRNGKey(0))
    return gen, params


@pytest.fixture(scope="module")
def narrow():
    """(jax generator, jax params, torch generator with the same weights)."""
    jgen, params = _init_jax(NARROW_CFG)
    # make biases non-zero so that a dropped bias cannot go unnoticed
    flat = flatten_flax(params)
    rng = np.random.RandomState(0)
    flat = {k: (v + rng.randn(*v.shape).astype(np.float32) * 0.05 if k.endswith("bias") else v)
            for k, v in flat.items()}
    tgen = tbuild("AttLWB-SPADE", NARROW_CFG, device="cpu")
    tckpt.load_generator_params(tgen, flat)
    return jgen, unflatten_to_jax(flat), tgen


def _inputs(seed, S=32, ns=2, T=2):
    rng = np.random.RandomState(seed)
    return {
        "bg": rng.uniform(-1, 1, (1, 1, S, S, 4)).astype(np.float32),
        "src": rng.uniform(-1, 1, (1, ns, S, S, 6)).astype(np.float32),
        "tsf": rng.uniform(-1, 1, (T, S, S, 6)).astype(np.float32),
        "Tst": rng.uniform(-1.1, 1.1, (T, ns, S, S, 2)).astype(np.float32),
    }


def test_forward_bg(narrow):
    jgen, params, tgen = narrow
    x = _inputs(1)["bg"]
    ref = np.asarray(jgen.apply(params, jnp.asarray(x), method=jgen.forward_bg))
    with torch.no_grad():
        out = n(tgen.forward_bg(t(x)))
    assert out.shape == ref.shape == (1, 1, 32, 32, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_forward_src(narrow):
    jgen, params, tgen = narrow
    x = _inputs(2)["src"]
    enc_r, res_r, img_r, mask_r = jgen.apply(params, jnp.asarray(x), False, method=jgen.forward_src)
    with torch.no_grad():
        enc, res, img, mask = tgen.forward_src(t(x), only_enc=False)
    assert len(enc) == len(enc_r) == 3 and len(res) == len(res_r) == 2
    for a, b in zip(list(enc) + list(res) + [img, mask], list(enc_r) + list(res_r) + [img_r, mask_r]):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-4, rtol=0)


@pytest.mark.parametrize("Sf", [32, 16])
def test_forward_tsf(narrow, Sf):
    """Stride-1 feature warps; Tst at full and at half resolution."""
    jgen, params, tgen = narrow
    d = _inputs(3)
    Tst = d["Tst"][:, :, ::32 // Sf, ::32 // Sf]
    src = np.broadcast_to(d["src"], (2,) + d["src"].shape[1:])
    enc_r, res_r = jgen.apply(params, jnp.asarray(src), True, method=jgen.forward_src)
    img_r, mask_r = jgen.apply(params, jnp.asarray(d["tsf"]), enc_r, res_r, jnp.asarray(Tst),
                               method=jgen.forward_tsf)
    with torch.no_grad():
        enc, res = tgen.forward_src(t(src))
        img, mask = tgen.forward_tsf(t(d["tsf"]), enc, res, t(Tst))
    np.testing.assert_allclose(n(img), np.asarray(img_r), atol=1e-4, rtol=0)
    np.testing.assert_allclose(n(mask), np.asarray(mask_r), atol=1e-4, rtol=0)
    assert n(mask).min() >= 0 and n(mask).max() <= 1


def test_feat_warp_stride_knob_runs_and_is_off_by_default(narrow):
    _, _, tgen = narrow
    assert tgen.feat_warp_stride == 1
    g2 = tbuild("AttLWB-SPADE", NARROW_CFG, feat_warp_stride=2, device="cpu")
    g2.load_state_dict(tgen.state_dict())
    rng = np.random.RandomState(4)
    S = 128  # the strided warp is active only where h // 2 >= 32
    src = t(rng.uniform(-1, 1, (1, 1, S, S, 6)))
    tsf = t(rng.uniform(-1, 1, (1, S, S, 6)))
    Tst = t(rng.uniform(-1, 1, (1, 1, S, S, 2)))
    with torch.no_grad():
        enc, res = tgen.forward_src(src)
        a, _ = tgen.forward_tsf(tsf, enc, res, Tst)
        b, _ = g2.forward_tsf(tsf, enc, res, Tst)
    assert a.shape == b.shape and torch.isfinite(b).all()
    assert (a - b).abs().max() > 0  # the knob changes the result: no parity claimed


def test_conv_transpose_alone():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 7, 4).astype(np.float32)
    layer = nn.ConvTranspose(6, (4, 4), strides=(2, 2), padding="SAME")
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(layer.apply(params, jnp.asarray(x)))
    flat = {"params/ConvTranspose_0/kernel": np.asarray(params["params"]["kernel"]),
            "params/ConvTranspose_0/bias": rng.randn(6).astype(np.float32)}
    ref = ref + flat["params/ConvTranspose_0/bias"]
    sd = tckpt.flax_params_to_torch(flat)
    conv = tblocks._deconv(4, 6)
    conv.load_state_dict({"weight": sd["ConvTranspose_0.weight"], "bias": sd["ConvTranspose_0.bias"]})
    with torch.no_grad():
        out = n(tblocks.conv_nhwc(conv, t(x)))
    assert out.shape == ref.shape == (2, 10, 14, 6)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_instance_norm_and_attention_fuse():
    rng = np.random.RandomState(6)
    x = (rng.randn(2, 9, 11, 5) * 3 + 1).astype(np.float32)
    np.testing.assert_allclose(n(tblocks.instance_norm(t(x))),
                               np.asarray(jblocks.instance_norm(jnp.asarray(x))), atol=1e-5, rtol=0)
    q = rng.randn(2, 6, 6, 8).astype(np.float32)
    k = rng.randn(2, 3, 6, 6, 8).astype(np.float32)
    v = rng.randn(2, 3, 6, 6, 8).astype(np.float32)
    ref = np.asarray(jblocks.attention_fuse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(n(tblocks.attention_fuse(t(q), t(k), t(v))), ref, atol=1e-5, rtol=0)


def test_spade_and_warp():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    cond = rng.randn(2, 8, 8, 4).astype(np.float32)
    layer = jblocks.SPADE(norm_nc=6, nhidden=16)
    params = layer.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(cond))
    ref = np.asarray(layer.apply(params, jnp.asarray(x), jnp.asarray(cond)))
    spade = tblocks.SPADE(norm_nc=6, cond_nc=4, nhidden=16)
    spade.load_state_dict(tckpt.flax_params_to_torch(flatten_flax(params), like=spade.state_dict()))
    with torch.no_grad():
        np.testing.assert_allclose(n(spade(t(x), t(cond))), ref, atol=1e-5, rtol=0)
    flow = rng.uniform(-1.1, 1.1, (2, 16, 16, 2)).astype(np.float32)
    np.testing.assert_allclose(n(tblocks.warp(t(x), t(flow))),
                               np.asarray(jblocks.warp(jnp.asarray(x), jnp.asarray(flow))),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("norm,act,stride", [(True, True, 1), (False, False, 2)])
def test_conv_in(norm, act, stride):
    rng = np.random.RandomState(10)
    x = rng.randn(2, 12, 12, 3).astype(np.float32)
    layer = jblocks.ConvIN(5, kernel=3, stride=stride, norm=norm, act=act)
    params = layer.init(jax.random.PRNGKey(3), jnp.asarray(x))
    ref = np.asarray(layer.apply(params, jnp.asarray(x)))
    mod = tblocks.ConvIN(3, 5, kernel=3, stride=stride, norm=norm, act=act)
    mod.load_state_dict(tckpt.flax_params_to_torch(flatten_flax(params), like=mod.state_dict()))
    with torch.no_grad():
        np.testing.assert_allclose(n(mod(t(x))), ref, atol=1e-5, rtol=0)


def test_self_attention_lwb_unwarped_path(narrow):
    """pre_warped=False (raw features + flows) equals warping by hand."""
    _, _, tgen = narrow
    lwb = tgen.enc_fusion_0
    rng = np.random.RandomState(8)
    tsf_x = t(rng.randn(1, 16, 16, 8))
    src_x = t(rng.randn(1, 2, 16, 16, 8))
    Tst = t(rng.uniform(-1, 1, (1, 2, 32, 32, 2)))
    with torch.no_grad():
        a = lwb(tsf_x, src_x, Tst, pre_warped=False)
        warped = tblocks.warp(src_x[0], Tst[0])[None]
        b = lwb(tsf_x, warped, pre_warped=True)
    np.testing.assert_allclose(n(a), n(b), atol=1e-6, rtol=0)


# --- full width -------------------------------------------------------------

@pytest.fixture(scope="module")
def full_flat():
    return tckpt.seeded_flat_params(FULL_CFG, seed=0)


def test_seeded_params_have_the_keys_and_shapes_of_a_full_width_init(full_flat):
    gen = jbuild("AttLWB-SPADE", FULL_CFG)
    S = 16
    shapes = jax.eval_shape(
        lambda r: gen.init(r, jnp.zeros((1, 1, S, S, 4)), jnp.zeros((1, 1, S, S, 6)),
                           jnp.zeros((1, 1, S, S, 6)), jnp.zeros((1, 1, 1, S, S, 2)), None, False),
        jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in _flatten_shapes(shapes).items()}
    got = {k: v.shape for k, v in full_flat.items()}
    assert len(got) == 221 and got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 36_276_992
    again = tckpt.seeded_flat_params(FULL_CFG, seed=0)
    assert all(np.array_equal(full_flat[k], again[k]) for k in full_flat)
    other = tckpt.seeded_flat_params(FULL_CFG, seed=1)
    assert not np.array_equal(full_flat["params/tsf_enc_0/kernel"], other["params/tsf_enc_0/kernel"])


def _flatten_shapes(tree, prefix=""):
    out = {}
    if hasattr(tree, "keys"):
        for k in tree.keys():
            out.update(_flatten_shapes(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def test_carrier_is_strict(full_flat):
    like = tbuild("AttLWB-SPADE", FULL_CFG, device="meta").state_dict()
    bad = dict(full_flat)
    bad["params/tsf_enc_0/kernel"] = np.zeros((3, 3, 6, 63), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.flax_params_to_torch(bad, like=like)
    missing = {k: v for k, v in full_flat.items() if k != "params/tsf_heads/Conv_1/kernel"}
    with pytest.raises(ValueError, match="tsf_heads.Conv_1.weight"):
        tckpt.flax_params_to_torch(missing, like=like)
    extra = dict(full_flat, **{"params/extra/kernel": np.zeros((1, 1, 2, 2), np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        tckpt.flax_params_to_torch(extra, like=like)


def test_full_width_forward_tsf_with_seeded_weights(full_flat):
    """Full-width AttLWB-SPADE, 64^2, T = 1, ns = 1, the seeded weights in both
    packages. 1e-3: about 60 convolutions deep in f32 with different
    summation orders."""
    jgen = jbuild("AttLWB-SPADE", FULL_CFG)
    params = unflatten_to_jax(full_flat)
    tgen = tbuild("AttLWB-SPADE", FULL_CFG, device="cpu")
    tckpt.load_generator_params(tgen, full_flat)
    d = _inputs(9, S=64, ns=1, T=1)
    enc_r, res_r = jgen.apply(params, jnp.asarray(d["src"]), True, method=jgen.forward_src)
    img_r, mask_r = jgen.apply(params, jnp.asarray(d["tsf"]), enc_r, res_r, jnp.asarray(d["Tst"]),
                               method=jgen.forward_tsf)
    with torch.no_grad():
        enc, res = tgen.forward_src(t(d["src"]))
        img, mask = tgen.forward_tsf(t(d["tsf"]), enc, res, t(d["Tst"]))
    np.testing.assert_allclose(n(img), np.asarray(img_r), atol=1e-3, rtol=0)
    np.testing.assert_allclose(n(mask), np.asarray(mask_r), atol=1e-3, rtol=0)
    assert n(img).std() > 0.05  # the seeded net is not degenerate


@pytest.fixture(scope="module")
def pretrained_flat(tmp_path_factory):
    """The published generator weights (on disk, or restored from git history)."""
    return tckpt.load_flat_npz(pretrained_generator_npz(tmp_path_factory))


def test_pretrained_npz_loads_strictly(pretrained_flat):
    flat = pretrained_flat
    gen = tbuild("AttLWB-SPADE", FULL_CFG, device="cpu")
    tckpt.load_generator_params(gen, flat)
    assert len(flat) == 221
    w = gen.state_dict()["bg_net.Conv_0.weight"]
    np.testing.assert_array_equal(n(w), flat["params/bg_net/Conv_0/kernel"].transpose(3, 2, 0, 1))


def test_full_width_forward_tsf_with_pretrained_weights(pretrained_flat):
    """The published weights through `forward_src` + `forward_tsf` in both
    packages, on the inputs of the seeded test above (64^2, T = 1, ns = 1),
    at its tolerance of 1e-3."""
    jgen = jbuild("AttLWB-SPADE", FULL_CFG)
    params = unflatten_to_jax(pretrained_flat)
    tgen = tbuild("AttLWB-SPADE", FULL_CFG, device="cpu")
    tckpt.load_generator_params(tgen, pretrained_flat)
    d = _inputs(9, S=64, ns=1, T=1)
    enc_r, res_r = jgen.apply(params, jnp.asarray(d["src"]), True, method=jgen.forward_src)
    img_r, mask_r = jgen.apply(params, jnp.asarray(d["tsf"]), enc_r, res_r, jnp.asarray(d["Tst"]),
                               method=jgen.forward_tsf)
    with torch.no_grad():
        enc, res = tgen.forward_src(t(d["src"]))
        img, mask = tgen.forward_tsf(t(d["tsf"]), enc, res, t(d["Tst"]))
    np.testing.assert_allclose(n(img), np.asarray(img_r), atol=1e-3, rtol=0)
    np.testing.assert_allclose(n(mask), np.asarray(mask_r), atol=1e-3, rtol=0)
    assert n(img).std() > 0.05


OTHER_GENERATORS = ["AttLWB-AdaIN", "AddLWB", "InputConcat", "TextureWarping", "AttLWB-Front", "AvgLWB",
                    "SoftGateAddLWB", "SoftGateAvgLWB"]


def _jax_shapes(gen, S, ns, nt=1, temporal=False):
    """{flat key: shape} of the Flax tree `gen.init` makes for ns sources."""
    Ttt = jnp.zeros((1, max(nt - 1, 1), S, S, 2)) if temporal else None
    tree = jax.eval_shape(
        lambda r: gen.init(r, jnp.zeros((1, 1, S, S, 4)), jnp.zeros((1, ns, S, S, 6)), jnp.zeros((1, nt, S, S, 6)),
                           jnp.zeros((1, nt, ns, S, S, 2)), Ttt, False), jax.random.PRNGKey(0))
    return {k: tuple(v.shape) for k, v in _flatten_shapes(tree).items()}


@pytest.mark.parametrize("name", OTHER_GENERATORS)
def test_other_generators_match_jax(name):
    """Every generator name besides AttLWB-SPADE against JAX at narrow widths
    (32², nt = 2) with ns = 1 and 2, from the port's seeded flat weights
    loaded strictly in both packages (their
    keys and shapes are the Flax tree's): the LWB family's `forward_src` /
    `forward_tsf` (T = 2) and training forward (`only_tsf=False`; temporal for
    AdaIN), the baselines' training call. 1e-3, as the SPADE case."""
    S, nt = 32, 2
    temporal = name == "AttLWB-AdaIN"
    baseline = name in ("InputConcat", "TextureWarping")
    jgen = jbuild(name, NARROW_CFG, temporal=temporal)
    for ns in (1, 2):
        tgen = tbuild(name, NARROW_CFG, temporal=temporal, num_source=ns, device="cpu")
        flat = tckpt.seeded_flat_params(tgen, seed=ns)
        if ns == 2 or name == "InputConcat":  # only InputConcat's tree depends on ns
            assert {k: v.shape for k, v in flat.items()} == _jax_shapes(jgen, S, ns, nt, temporal)
        # non-zero biases, so that a dropped bias cannot go unnoticed
        rng = np.random.RandomState(ns)
        flat = {k: v + rng.randn(*v.shape).astype(np.float32) * 0.05 if k.endswith("bias") else v
                for k, v in flat.items()}
        tckpt.load_generator_params(tgen, flat)
        params = unflatten_to_jax(flat)
        d = _inputs(20 + ns, S=S, ns=ns, T=nt)
        tsf_seq, Tst_seq = d["tsf"][None], d["Tst"][None]
        Ttt = np.random.RandomState(ns).uniform(-1, 1, (1, nt - 1, S, S, 2)).astype(np.float32) \
            if temporal else None
        bg = None if name == "AttLWB-Front" else d["bg"]
        call_args = (bg, d["src"], tsf_seq, Tst_seq, Ttt)
        want = jgen.apply(params, *(None if a is None else jnp.asarray(a) for a in call_args), False)
        with torch.no_grad():
            got = tgen(*(None if a is None else t(a) for a in call_args), only_tsf=False)
        assert len(got) == len(want) == (3 if baseline else 5)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
                continue
            np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-3, rtol=0, err_msg=f"{name} ns={ns}")
        if baseline:
            assert not hasattr(tgen, "forward_tsf") and not hasattr(jgen, "forward_tsf")
            continue
        enc_r, res_r = jgen.apply(params, jnp.asarray(d["src"]), True, method=jgen.forward_src)
        rep = lambda x: jnp.broadcast_to(x, (nt,) + x.shape[1:])
        img_r, mask_r = jgen.apply(params, jnp.asarray(d["tsf"]), [rep(e) for e in enc_r],
                                   [rep(r) for r in res_r], jnp.asarray(d["Tst"]), method=jgen.forward_tsf)
        with torch.no_grad():
            enc, res = tgen.forward_src(t(d["src"]))
            exp = lambda x: x.expand((nt,) + tuple(x.shape[1:]))
            img, mask = tgen.forward_tsf(t(d["tsf"]), [exp(e) for e in enc], [exp(r) for r in res], t(d["Tst"]))
        for a, b in zip(list(enc) + list(res), list(enc_r) + list(res_r)):
            np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-4, rtol=0)
        np.testing.assert_allclose(n(img), np.asarray(img_r), atol=1e-3, rtol=0, err_msg=f"{name} ns={ns}")
        np.testing.assert_allclose(n(mask), np.asarray(mask_r), atol=1e-3, rtol=0, err_msg=f"{name} ns={ns}")
        assert n(img).std() > 0.01


def test_front_generator_has_no_background_net():
    """AttLWB-Front: `forward_bg` raises AttributeError in both packages (the
    background must be given), and its parameters are AttLWB-SPADE's without
    `bg_net`."""
    jgen = jbuild("AttLWB-Front", NARROW_CFG)
    tgen = tbuild("AttLWB-Front", NARROW_CFG, device="cpu")
    flat = tckpt.seeded_flat_params(tgen, 0)
    spade = tckpt.seeded_flat_params(NARROW_CFG, 0)
    assert set(flat) == {k for k in spade if not k.startswith("params/bg_net/")}
    tckpt.load_generator_params(tgen, flat)
    x = np.zeros((1, 1, 16, 16, 4), np.float32)
    with pytest.raises(AttributeError, match="bg_net"):
        jgen.apply(unflatten_to_jax(flat), jnp.asarray(x), method=jgen.forward_bg)
    with pytest.raises(AttributeError, match="bg_net"):
        tgen.forward_bg(t(x))


def test_unknown_generator_raises_key_error():
    with pytest.raises(KeyError):
        tbuild("NoSuchNet", NARROW_CFG, device="cpu")
    with pytest.raises(KeyError):  # also when temporal (a port of its own since slice 2)
        tbuild("NoSuchNet", NARROW_CFG, temporal=True, device="cpu")
