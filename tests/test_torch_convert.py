"""`ipercore_tpu_torch/utils/torch_convert.py` against the JAX package's
`utils/torch_convert.py`: every ported converter on the same synthetic state
dict in the reference's (torch) layout, built from each network's parameter
names with random values. The converted flat parameters must be equal bit
for bit and the reports equal: empty on a full state dict, and the same
`ABSENT` / `SHAPE` / `UNFILLED` / `SCALING MISMATCH` entries on one with a
layer taken out and a shape broken.
"""
import numpy as np
import pytest
import torch

from ipercore_tpu.utils import torch_convert as JTC
from ipercore_tpu_torch.models.networks import build_discriminator
from ipercore_tpu_torch.models.networks import criterions as C
from ipercore_tpu_torch.models.networks.inception import InceptionV3Features
from ipercore_tpu_torch.utils import checkpoint as tckpt
from ipercore_tpu_torch.utils import torch_convert as TTC

from tests.test_torch_common import NARROW_CFG, flatten_flax, reference_generator_state_dict, unflatten_to_jax

_VGG_IDS = {"VGG19": TTC._VGG19_CONV_IDS, "VGG16": TTC._VGG16_CONV_IDS, "VGG11": TTC._VGG11_CONV_IDS}
# Flax leaf -> torch leaf (a batch norm's four, Inception's conv-held ones)
_LEAF = {"kernel": "weight", "bias": "bias", "weight": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var", "bn_scale": "bn.weight", "bn_bias": "bn.bias", "bn_mean": "bn.running_mean",
         "bn_var": "bn.running_var"}


def _torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    return a.T if a.ndim == 2 else a


def _state_dict(flat: dict, prefix_of, seed: int) -> dict:
    """A torch-layout state dict for `flat` (Flax keys): module path ->
    torch prefix by `prefix_of`, leaves by `_LEAF`, random values."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, v in sorted(flat.items()):
        parts = key.split("/")[1:]
        leaf = parts[-1]
        module = parts[:-2] if parts[-2:] == ["conv", "kernel"] else parts[:-1]
        tleaf = "conv.weight" if parts[-2:] == ["conv", "kernel"] else _LEAF[leaf]
        shape = _torch_layout(np.zeros(v.shape, np.int8)).shape
        sd[f"{prefix_of(module)}.{tleaf}"] = (rng.randn(*shape) * 0.05).astype(np.float32)
    return sd


def _vgg_prefix(vgg_type):
    slices = C._VGG_SLICES_BY_TYPE[vgg_type]
    flat_index = {f"conv{si}_{wi}": i for i, (si, wi) in enumerate(
        (si, wi) for si, widths in enumerate(slices) for wi in range(len(widths)))}
    return lambda m: f"features.{_VGG_IDS[vgg_type][flat_index[m[0]]]}"


def _senet_prefix(m):
    if len(m) == 1:
        return m[0]
    layer, block = m[0][len("layer"):].split("_")
    sub = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(m[1], m[1])
    return f"layer{layer}.{block}.{sub}"


def _lpips_prefix(m):
    if m[0] == "vgg":
        si, wi = (int(x) for x in m[1][len("conv"):].split("_"))
        starts = (0, 4, 9, 16, 23)
        local = TTC._VGG16_CONV_IDS[sum(len(w) for w in C._VGG16_SLICES[:si]) + wi] - starts[si]
        return f"net.slice{si + 1}.{local}"
    return f"{m[0]}.model.1"


def _disc_prefix(m):
    return f"{m[0]}.model.{3 * int(m[1].split('_')[1])}"


def _case(name):
    """(port converter, JAX converter, like (flat), state dict)."""
    if name == "generator":
        like = tckpt.seeded_flat_params(NARROW_CFG, 0)
        return TTC.convert_generator, JTC.convert_generator, like, reference_generator_state_dict(like, 1)
    if name == "discriminator":
        like = tckpt.seeded_flat_params(build_discriminator("patch_global_body_head", {"ndf": 8, "n_layers": 2},
                                                            device="meta"), 0)
        return TTC.convert_discriminator, JTC.convert_discriminator, like, _state_dict(like, _disc_prefix, 2)
    if name.startswith("vgg"):
        vgg_type = name.upper()
        like = tckpt.seeded_flat_params(C.VGGFeatures(slices=C._VGG_SLICES_BY_TYPE[vgg_type]), 0)
        sd = _state_dict(like, _vgg_prefix(vgg_type), 3)
        if vgg_type == "VGG19":  # a wrapped export
            sd = {"vgg." + k: v for k, v in sd.items()}
        return getattr(TTC, f"convert_{name}"), getattr(JTC, f"convert_{name}"), like, sd
    if name == "sphereface":
        like = tckpt.seeded_flat_params(C.SphereFaceFeatures(), 0)
        sd = _state_dict(like, lambda m: m[0], 4)
        sd["fc6.weight"] = np.zeros((10, 512), np.float32)  # the classifier, not converted
        return TTC.convert_sphereface, JTC.convert_sphereface, like, sd
    if name == "senet50":
        like = tckpt.seeded_flat_params(C.SENetFaceFeatures(), 0)
        sd = {"net." + k: v for k, v in _state_dict(like, _senet_prefix, 5).items()}
        return TTC.convert_senet50, JTC.convert_senet50, like, sd
    if name == "inception":
        like = tckpt.seeded_flat_params(InceptionV3Features(), 0)
        sd = _state_dict(like, ".".join, 6)
        sd["AuxLogits.conv0.conv.weight"] = np.zeros((128, 768, 1, 1), np.float32)
        sd["fc.weight"] = np.zeros((1000, 2048), np.float32)
        return TTC.convert_inception, JTC.convert_inception, like, sd
    like = tckpt.seeded_flat_params(C.LPIPSLin(), 0)
    sd = _state_dict(like, _lpips_prefix, 7)
    sd["scaling_layer.shift"] = np.array([-0.030, -0.088, -0.188], np.float32).reshape(1, 3, 1, 1)
    sd["scaling_layer.scale"] = np.array([0.458, 0.448, 0.450], np.float32).reshape(1, 3, 1, 1)
    return TTC.convert_lpips, JTC.convert_lpips, like, sd


CASES = ["generator", "discriminator", "vgg19", "vgg16", "vgg11", "sphereface", "senet50", "inception", "lpips"]


def _both(port, jax_fn, sd, like):
    got, got_report = port({k: torch.as_tensor(v) for k, v in sd.items()}, like)
    want, want_report = jax_fn(dict(sd), unflatten_to_jax(like))
    want = flatten_flax(want)
    assert got.keys() == want.keys() == like.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_report == want_report
    return got, got_report


@pytest.mark.parametrize("name", CASES)
def test_full_state_dict_converts_as_jax(name):
    port, jax_fn, like, sd = _case(name)
    got, report = _both(port, jax_fn, sd, like)
    assert report == []
    changed = [k for k in like if not np.array_equal(got[k], like[k])]
    assert len(changed) == len(like), sorted(set(like) - set(changed))[:5]


@pytest.mark.parametrize("name", CASES)
def test_broken_state_dict_reports_as_jax(name):
    """Half the keys under `module.`, one conv layer taken out and one weight
    of another shape (LPIPS: a scaling layer that is not ImageNet's): the
    same non-empty report in both, and the same parameters (the targets not
    converted keep `like`'s values)."""
    port, jax_fn, like, sd = _case(name)
    convs = sorted(k for k, v in sd.items() if k.endswith("weight") and np.ndim(v) == 4)
    gone = convs[0][: -len(".weight")]
    sd = {k: v for k, v in sd.items() if not k.startswith(gone + ".")}
    broken = convs[len(convs) // 2]
    sd[broken] = np.zeros(sd[broken].shape[:-1] + (sd[broken].shape[-1] + 1,), np.float32)
    if name == "lpips":
        sd["scaling_layer.scale"] = np.ones((1, 3, 1, 1), np.float32)
    sd = {("module." + k if i % 2 else k): v for i, (k, v) in enumerate(sorted(sd.items()))}
    _, report = _both(port, jax_fn, sd, like)
    assert any(r.startswith("SHAPE") for r in report), report
