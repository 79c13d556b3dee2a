"""Parity of the port's SCHP parser (`tools/parsers.py`), the SCHP cloth
links (`deformers.find_cloth_links_schp`) and the SCHP / ESRGAN converters
with the JAX package, on the same inputs and parameters.

Tolerances: the resize and pooling matrices within 1e-6; a thin seeded
SchpNet within 1e-4 of its largest logit, the published `schp.npz` at full
depth within 1e-4 of its largest logit (101 layers of f32 convolutions); the
labels (an argmax, where a near-tie may flip) equal on >= 99.5 % of pixels;
the clean-up, the run's selection and the converters exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_common import flatten_flax, history_weights, small_models, unflatten_to_jax
from ipercore_tpu.tools import deformers as jdef
from ipercore_tpu.tools import parsers as jps
from ipercore_tpu.tools.inpaintors import RRDBNet as JaxRRDBNet
from ipercore_tpu.utils import torch_convert as jconv
from ipercore_tpu_torch.tools import deformers as tdef
from ipercore_tpu_torch.tools import parsers as tps
from ipercore_tpu_torch.tools.inpaintors import RRDBNet
from ipercore_tpu_torch.utils import torch_convert as tconv
from ipercore_tpu_torch.utils.checkpoint import load_flat_npz, load_generator_params, seeded_flat_params


def _perturbed(net, seed):
    flat = seeded_flat_params(net, seed)
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in flat.items():
        if k.endswith("/var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("kernel"):
            out[k] = v
        else:
            out[k] = v + 0.1 * rng.randn(*v.shape).astype(np.float32)
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("shape,size", [((2, 7, 9, 3), (13, 5)), ((1, 30, 30, 4), (119, 119)),
                                        ((1, 5, 5, 2), (1, 1))])
def test_resize_bilinear_ac_matches_jax(shape, size):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got = tps.resize_bilinear_ac(torch.tensor(x), *size).numpy()
    np.testing.assert_allclose(got, np.asarray(jps.resize_bilinear_ac(jnp.asarray(x), *size)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 6])
def test_adaptive_avg_pool_matches_jax_and_torch(k):
    x = np.random.RandomState(k).randn(2, 7, 9, 5).astype(np.float32)
    got = tps.adaptive_avg_pool(torch.tensor(x), k).numpy()
    np.testing.assert_allclose(got, np.asarray(jps.adaptive_avg_pool(jnp.asarray(x), k)), rtol=0, atol=1e-6)
    ref = torch.nn.functional.adaptive_avg_pool2d(torch.tensor(x).permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-6)


def test_thin_schp_net_matches_jax():
    net = tps.SchpNet(layers=(1, 1, 1, 1)).eval()
    flat = _perturbed(net, 9)
    load_generator_params(net, flat)
    x = np.random.RandomState(1).randn(2, 65, 71, 3).astype(np.float32)
    with torch.no_grad():
        got = net(torch.tensor(x)).numpy()
    want = np.asarray(jps.SchpNet(layers=(1, 1, 1, 1)).apply(unflatten_to_jax(flat), jnp.asarray(x)))
    assert got.shape == want.shape == (2, 17, 18, 20)
    assert _rel(got, want) <= 1e-4


@pytest.fixture(scope="module")
def schp_flat(tmp_path_factory):
    flat = load_flat_npz(history_weights("schp", tmp_path_factory))
    return {k: np.asarray(v, np.float32) for k, v in flat.items()}


def test_published_schp_at_full_depth_matches_jax(schp_flat):
    """`schp.npz` (603 f16 arrays) loads strictly into the ResNet-101 SchpNet;
    97^2 (JAX's own test size: the stride-16 7^2 grid is not divisible by the
    PSP's 2, 3 and 6 pools)."""
    assert len(schp_flat) == 603
    net = tps.SchpNet().eval()
    load_generator_params(net, schp_flat)
    x = np.random.RandomState(2).randn(1, 97, 97, 3).astype(np.float32)
    with torch.no_grad():
        got = net(torch.tensor(x)).numpy()
    want = np.asarray(jps.SchpNet().apply(unflatten_to_jax(schp_flat), jnp.asarray(x)))
    assert got.shape == want.shape == (1, 25, 25, 20)
    assert _rel(got, want) <= 1e-4


def test_schp_parser_labels_match_jax(schp_flat):
    """The runner (normalisation, resizes, argmax) at input size 97 on two
    48x40 frames: logits within 1e-4 of the largest, labels >= 99.5 % equal."""
    imgs = np.random.RandomState(4).uniform(-1, 1, (2, 48, 40, 3)).astype(np.float32)
    tp = tps.SchpParser(params=schp_flat, input_size=97, device="cpu")
    jp = jps.SchpParser(params=unflatten_to_jax(schp_flat), input_size=97)
    got = tp.logits(imgs).numpy()
    want = np.asarray(jp._forward(jp.params, jnp.asarray(imgs)))
    assert _rel(got, want) <= 1e-4
    agree = (tp.parse(imgs) == jp.parse(imgs)).mean()
    assert agree >= 0.995, agree
    assert tp.trained and not tps.SchpParser(input_size=97, device="cpu").trained


def _label_maps():
    """Two 40x48 label maps: a body with a skirt (class 12) whose hem ends at
    row 29, a stray dress blob (class 6), and background; then one with a few
    skirt pixels only."""
    lab = np.zeros((2, 40, 48), np.int64)
    lab[0, 4:30, 14:30] = 5
    lab[0, 18:30, 12:32] = 12
    lab[0, 2:4, 40:44] = 6
    lab[0, 30:38, 16:28] = 16
    lab[1, 10:30, 10:30] = 13
    lab[1, 5:8, 5:8] = 12
    return lab


@pytest.mark.parametrize("target", ["body", "skirt+dress", "background"])
def test_schp_parser_run_selects_as_jax(target, monkeypatch):
    lab = _label_maps()
    tp = tps.SchpParser(input_size=97, device="cpu")
    jp = jps.SchpParser.__new__(jps.SchpParser)
    jp.net = jps.SchpNet()
    monkeypatch.setattr(tp, "parse", lambda images: lab[:len(images)])
    monkeypatch.setattr(jp, "parse", lambda images: lab[:len(images)], raising=False)
    imgs = np.zeros((2, 40, 48, 3), np.float32)
    found_t, masks_t = tp.run(imgs, target=target)
    found_j, masks_j = jp.run(imgs, target=target)
    assert found_t == found_j and len(masks_t) == len(masks_j)
    for a, b in zip(masks_t, masks_j):
        np.testing.assert_array_equal(a, b)
    if target == "skirt+dress":  # the second frame has 9 skirt pixels: the bail-out
        assert not found_t and len(masks_t) == 1
        assert masks_t[0][2:4, 40:44].sum() == 0  # the stray blob is not the largest component


def test_find_largest_connected_mask_matches_jax():
    rng = np.random.RandomState(5)
    for m in ((rng.rand(40, 50) > 0.55).astype(np.uint8), np.zeros((8, 8), np.uint8),
              np.pad(np.ones((10, 12), np.uint8), 1)):
        np.testing.assert_array_equal(tps.find_largest_connected_mask(m), jps.find_largest_connected_mask(m))


def test_find_cloth_links_schp_matches_jax(monkeypatch):
    """The hem of the skirt mask (row 29 of 40) through `smpl_link` on the
    small synthetic body, legs split by x; and no links without a skirt."""
    jm, tm = small_models()
    v = np.asarray(jm.v_template)
    low = v[:, 1] > 0.0
    legs = (np.nonzero(low & (v[:, 0] > 0.02))[0].astype(np.int64),
            np.nonzero(low & (v[:, 0] < -0.02))[0].astype(np.int64))
    monkeypatch.setattr(tdef, "load_leg_vertex_ids", lambda: legs)
    monkeypatch.setattr(jdef, "load_leg_vertex_ids", lambda: legs)
    lab = _label_maps()
    tp = tps.SchpParser(input_size=97, device="cpu")
    jp = jps.SchpParser.__new__(jps.SchpParser)
    jp.net = jps.SchpNet()
    theta = np.zeros((85,), np.float32)
    theta[0] = 1.0
    for frame, want_found in ((0, True), (1, False)):
        monkeypatch.setattr(tp, "parse", lambda images, f=frame: lab[f:f + 1])
        monkeypatch.setattr(jp, "parse", lambda images, f=frame: lab[f:f + 1], raising=False)
        img = np.zeros((40, 48, 3), np.float32)
        found_t, links_t = tdef.find_cloth_links_schp(tp, img, theta, tm)
        found_j, links_j = jdef.find_cloth_links_schp(jp, img, theta, jm)
        assert found_t == found_j == want_found
        assert links_t.shape == links_j.shape and links_t.dtype == np.int32
        np.testing.assert_array_equal(links_t[:, [0, 2]], links_j[:, [0, 2]])


def _schp_state_dict(flat: dict, seed: int, nested_abn: bool) -> dict:
    """A reference `exp-schp-lip.pth` layout (torch names and shapes) with
    random values, built from the flat keys by the converter's name map's
    inverse; the ABN statistics nested under `.bn` or not."""
    rng = np.random.RandomState(seed)
    bn = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    modules = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1",
               "bottleneck_conv": "bottleneck.0", "bottleneck_abn": "bottleneck.1",
               "conv1_conv": "conv1.0", "conv1_abn": "conv1.1", "conv2_conv": "conv2.0", "conv2_abn": "conv2.1",
               "conv3_conv": "conv3.0", "conv3_abn": "conv3.1", "conv3a_conv": "conv3.0",
               "conv3a_abn": "conv3.1", "conv3b_conv": "conv3.2", "conv3b_abn": "conv3.3",
               "fushion_conv": "fushion.0", "fushion_abn": "fushion.1", "fushion_head": "fushion.3"}
    sd = {}
    for key, arr in flat.items():
        parts = key.split("/")[1:]
        leaf, mods = parts[-1], parts[:-1]
        if mods[-1] == "bn":  # an ABN's statistics
            mods = mods[:-1] + (["bn"] if nested_abn else [])
        names = []
        for m in mods:
            if m.startswith("layer") and "_" in m:
                names.append(m.replace("_", "."))
            elif m.startswith("stage"):
                names.append(f"stages.{m[5]}.{1 if m.endswith('conv') else 2}")
            else:
                names.append(modules.get(m, m))
        name = ".".join(names)
        is_bn = "/".join(["params"] + parts[:-1] + ["scale"]) in flat
        if leaf == "kernel":
            sd[name + ".weight"] = rng.randn(arr.shape[3], arr.shape[2], arr.shape[0], arr.shape[1]).astype(np.float32)
        else:
            sd[f"{name}.{bn[leaf] if is_bn else leaf}"] = rng.randn(*arr.shape).astype(np.float32)
    return sd


@pytest.mark.parametrize("nested_abn", [True, False])
def test_convert_schp_matches_jax(nested_abn):
    like = seeded_flat_params(tps.SchpNet(), 9)
    sd = _schp_state_dict(like, 3, nested_abn)
    got, rep_t = tconv.convert_schp(sd, like)
    want, rep_j = jconv.convert_schp(sd, unflatten_to_jax(like))
    want = flatten_flax(want)
    assert rep_t == rep_j == []
    assert set(got) == set(want) == set(like)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _esrgan_state_dict(n_blocks: int, seed: int, original: bool) -> dict:
    """An ESRGAN state dict with random values: the original repository's
    names (`RRDB_trunk.{i}.RDB{j}.conv{k}.0`, `trunk_conv`, `upconv1`, ...) or
    BasicSR's under `generator.` with a `generator_ema.` copy."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, cin, cout):
        sd[name + ".weight"] = rng.randn(cout, cin, 3, 3).astype(np.float32)
        sd[name + ".bias"] = rng.randn(cout).astype(np.float32)

    for i in range(n_blocks):
        for j in (1, 2, 3):
            for c in range(1, 6):
                cin, cout = 64 + (c - 1) * 32, 32 if c < 5 else 64
                conv(f"RRDB_trunk.{i}.RDB{j}.conv{c}.0" if original else f"generator.body.{i}.rdb{j}.conv{c}",
                     cin, cout)
    names = (("conv_first", "conv_first"), ("trunk_conv", "conv_body"), ("upconv1", "conv_up1"),
             ("upconv2", "conv_up2"), ("HRconv", "conv_hr"), ("conv_last", "conv_last"))
    for orig, new in names:
        cin = 3 if new == "conv_first" else 64
        cout = 3 if new == "conv_last" else 64
        conv(orig if original else f"generator.{new}", cin, cout)
    if not original:
        sd["generator_ema.conv_first.weight"] = np.zeros((64, 3, 3, 3), np.float32)
    return sd


@pytest.mark.parametrize("original", [True, False])
def test_convert_esrgan_matches_jax(original):
    net = RRDBNet(n_blocks=2)
    like = seeded_flat_params(net, 12)
    sd = _esrgan_state_dict(2, 4, original)
    got, rep_t = tconv.convert_esrgan(sd, like)
    want, rep_j = jconv.convert_esrgan(sd, unflatten_to_jax(like))
    want = flatten_flax(want)
    assert rep_t == rep_j == []
    assert set(got) == set(want) == set(like)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # a checkpoint with fewer blocks than the net: both report it
    _, rep_t = tconv.convert_esrgan(_esrgan_state_dict(1, 4, original), like)
    _, rep_j = jconv.convert_esrgan(_esrgan_state_dict(1, 4, original),
                                    unflatten_to_jax(seeded_flat_params(RRDBNet(n_blocks=2), 12)))
    assert rep_t == rep_j == ["BLOCKS: params have 2, checkpoint has 1"]
    # the converted weights give JAX's output
    load_generator_params(net, got)
    x = np.random.RandomState(0).rand(1, 6, 5, 3).astype(np.float32)
    with torch.no_grad():
        out = net(torch.tensor(x)).numpy()
    ref = np.asarray(JaxRRDBNet(n_blocks=2).apply(unflatten_to_jax(got), jnp.asarray(x)))
    assert _rel(out, ref) <= 1e-5
