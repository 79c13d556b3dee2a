"""Reference torch checkpoints -> flat parameters in the Flax `.npz` layout.

The port's copy of `ipercore_tpu/utils/torch_convert.py` for the networks the
port has: the generator (`convert_generator`, the reference's
`AttLWB-SPADE_id_G_*.pth` layout), the discriminators, the VGG19 / VGG16 /
VGG11 perceptual nets, Sphere20a and SENet-50 face nets, InceptionV3 (FID)
and LPIPS(lin). Each takes a state dict (torch tensors or numpy arrays,
`module.` prefixes allowed) and `like`, the flat parameters to fill
(`{flax key: array}`, e.g. `seeded_flat_params(net)`, or a network of the
port, whose own parameters are then the starting values). It returns
`(flat, report)`: `like` with every converted entry replaced, keyed as the
JAX package's flat `.npz` (`params/a/b/kernel`), so the existing carrier
(`checkpoint.load_generator_params`) loads it; and the list of entries that
did not convert (empty = full coverage), in the JAX package's words:
`ABSENT <torch key>` for an entry the checkpoint lacks, `MISSING <path>` for a
target the parameters lack, `SHAPE <path>: ...` for a shape that does not fit.
Unconverted targets keep their values from `like`.

Kernels go from torch's layout to Flax's: a Conv2d weight (O, I, kH, kW) to
(kH, kW, I, O); a ConvTranspose2d weight (I, O, kH, kW) to (kH, kW, I, O)
flipped spatially; a Linear weight (O, I) to (I, O).
"""
from __future__ import annotations

import re
from typing import Mapping, Union

import numpy as np
import torch.nn as nn

Like = Union[Mapping[str, np.ndarray], nn.Module]


def torch_conv_to_flax(w: np.ndarray, transpose: bool = False) -> np.ndarray:
    """A torch Conv2d kernel (O, I, kH, kW) -> Flax (kH, kW, I, O); with
    `transpose` a ConvTranspose2d kernel (I, O, kH, kW) -> Flax (kH, kW, I, O),
    flipped spatially."""
    if transpose:
        return np.flip(w.transpose(2, 3, 0, 1), axis=(0, 1)).copy()
    return w.transpose(2, 3, 1, 0).copy()


def _assign(tree: dict, path: list[str], value: np.ndarray, report: list[str]):
    node = tree
    for p in path[:-1]:
        if p not in node:
            report.append("MISSING " + "/".join(path))
            return
        node = node[p]
    leaf = path[-1]
    if leaf not in node:
        report.append("MISSING " + "/".join(path))
        return
    if tuple(node[leaf].shape) != tuple(value.shape):
        report.append(f"SHAPE {'/'.join(path)}: have {node[leaf].shape}, got {value.shape}")
        return
    node[leaf] = value


def _conv(sd, key, transpose=False):
    out = {"kernel": torch_conv_to_flax(np.asarray(sd[key + ".weight"]), transpose=transpose)}
    if key + ".bias" in sd:
        out["bias"] = np.asarray(sd[key + ".bias"])
    return out


def _normalize_sd(sd: Mapping) -> dict:
    """Strip `module.` prefixes; tensors become numpy arrays."""
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
            for k, v in sd.items()}


def _mutable_like(like: Like) -> tuple[dict, dict]:
    """`like` as a nested tree of numpy arrays: (tree, its `params` subtree)."""
    if isinstance(like, nn.Module):
        from ipercore_tpu_torch.utils.checkpoint import torch_params_to_flax

        like = torch_params_to_flax(like)
    tree: dict = {}
    for key, val in like.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)
    return tree, tree["params"] if "params" in tree else tree


def _finish(tree: dict, params: dict) -> dict[str, np.ndarray]:
    """The filled tree as flat '/'-joined keys."""
    out: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[prefix + k] = v

    walk({"params": params} if "params" in tree else params, "")
    return out


def _put_conv(sd, params, torch_key, flax_path, report, transpose=False):
    if torch_key + ".weight" not in sd:
        report.append("ABSENT " + torch_key)
        return
    _assign(params, flax_path + ["kernel"],
            torch_conv_to_flax(sd[torch_key + ".weight"], transpose=transpose), report)
    if torch_key + ".bias" in sd:
        _assign(params, flax_path + ["bias"], sd[torch_key + ".bias"], report)


def _put_dense(sd, params, torch_key, flax_path, report):
    if torch_key + ".weight" not in sd:
        report.append("ABSENT " + torch_key)
        return
    _assign(params, flax_path + ["kernel"], sd[torch_key + ".weight"].T.copy(), report)
    if torch_key + ".bias" in sd:
        _assign(params, flax_path + ["bias"], sd[torch_key + ".bias"], report)


def _put_bn(sd, params, torch_key, flax_path, report):
    """BatchNorm2d -> FrozenBatchNorm {scale, bias, mean, var}."""
    pairs = [("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var")]
    if torch_key + ".weight" not in sd:
        report.append("ABSENT " + torch_key)
        return
    for tk, fk in pairs:
        if torch_key + "." + tk in sd:
            _assign(params, flax_path + [fk], sd[torch_key + "." + tk], report)


def _put_basicconv(sd, params, torch_prefix, flax_path, report):
    """torchvision `BasicConv2d` (conv without bias + BatchNorm2d) -> the
    Inception `BasicConv2d` {conv/kernel, bn_scale, bn_bias, bn_mean, bn_var}."""
    if torch_prefix + ".conv.weight" not in sd:
        report.append("ABSENT " + torch_prefix)
        return
    _assign(params, flax_path + ["conv", "kernel"], torch_conv_to_flax(sd[torch_prefix + ".conv.weight"]), report)
    for tk, fk in (("bn.weight", "bn_scale"), ("bn.bias", "bn_bias"),
                   ("bn.running_mean", "bn_mean"), ("bn.running_var", "bn_var")):
        key = torch_prefix + "." + tk
        if key in sd:
            _assign(params, flax_path + [fk], sd[key], report)
        else:
            report.append("ABSENT " + key)


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------

def convert_generator(sd: Mapping, like: Like) -> tuple[dict[str, np.ndarray], list[str]]:
    """An AttLWB-SPADE torch state dict -> the generator's flat parameters.

    Name map (torch -> Flax):
      bg_net.main.{i} -> bg_net/* (conv7 at 0, [conv3 IN relu] at 3, 6, 9,
        residual blocks `.main.{0,3}` from 12, deconvs every 3 after them, the
        last conv7);
      src_net.encoders.layers.{i}.0 -> src_net/encoders/Conv_{i};
      src_net.res_blocks.{i}.main.{0|2} -> src_net/res_blocks_{i}/Conv_{0|1};
      src_net.decoders.layers.{i}.0 -> src_net/decoders/ConvTranspose_{i};
      src_net.img_reg.0 / att_reg.0 -> src_net/heads/Conv_{0|1};
      tsf_net_enc.layers.{i}.0 -> tsf_enc_{i};
      {enc,res}_attlwbs.{i}.{fq|fk|fv} -> {enc,res}_fusion_{i}/{fq|fk|fv};
      {enc,res}_attlwbs.{i}.spade.mlp_{shared.0|gamma|beta} ->
        {enc,res}_fusion_{i}/SPADE_0/Conv_{0|1|2};
      res_blocks.{i}.main.{0|2} -> tsf_res_blocks_{i}/Conv_{0|1};
      tsf_net_dec.upconvs.{i}.0 / skippers.{i}.0 -> tsf_net_dec/ConvTranspose_{i} / Conv_{i};
      tsf_img_reg.0 / tsf_att_reg.0 -> tsf_heads/Conv_{0|1}.
    """
    sd = _normalize_sd(sd)
    tree, params = _mutable_like(like)
    report: list[str] = []

    def put(path, key, transpose=False):
        if key + ".weight" not in sd:
            report.append("ABSENT " + key)
            return
        for leaf, val in _conv(sd, key, transpose).items():
            _assign(params, path + [leaf], val, report)

    # BGNet's Sequential (n_down = 3): the residual blocks are the entries
    # `bg_net.main.<i>.main.0.weight` (the outer first conv is `bg_net.main.0`)
    if "bg_net.main.0.weight" in sd:
        n_down = 3
        n_res = sum(1 for k in sd if re.fullmatch(r"bg_net\.main\.\d+\.main\.0\.weight", k))
        put(["bg_net", "Conv_0"], "bg_net.main.0")
        for i in range(n_down):
            put(["bg_net", f"Conv_{i + 1}"], f"bg_net.main.{3 * (i + 1)}")
        res_base = 3 * n_down + 3
        for i in range(n_res):
            put(["bg_net", f"ResidualBlockIN_{i}", "Conv_0"], f"bg_net.main.{res_base + i}.main.0")
            put(["bg_net", f"ResidualBlockIN_{i}", "Conv_1"], f"bg_net.main.{res_base + i}.main.3")
        dec_base = res_base + n_res
        for i in range(n_down):
            put(["bg_net", f"ConvTranspose_{i}"], f"bg_net.main.{dec_base + 3 * i}", transpose=True)
        put(["bg_net", f"Conv_{n_down + 1}"], f"bg_net.main.{dec_base + 3 * n_down}")

    # SIDNet
    for i in range(8):
        key = f"src_net.encoders.layers.{i}.0"
        if key + ".weight" in sd:
            put(["src_net", "encoders", f"Conv_{i}"], key)
    for i in range(16):
        a, b = f"src_net.res_blocks.{i}.main.0", f"src_net.res_blocks.{i}.main.2"
        if a + ".weight" in sd:
            put(["src_net", f"res_blocks_{i}", "Conv_0"], a)
            put(["src_net", f"res_blocks_{i}", "Conv_1"], b)
    for i in range(8):
        key = f"src_net.decoders.layers.{i}.0"
        if key + ".weight" in sd:
            put(["src_net", "decoders", f"ConvTranspose_{i}"], key, transpose=True)
    if "src_net.img_reg.0.weight" in sd:
        put(["src_net", "heads", "Conv_0"], "src_net.img_reg.0")
        put(["src_net", "heads", "Conv_1"], "src_net.att_reg.0")

    # TSF encoder convs
    for i in range(8):
        key = f"tsf_net_enc.layers.{i}.0"
        if key + ".weight" in sd:
            put([f"tsf_enc_{i}"], key)

    # attention fusions
    for group, prefix in (("enc_fusion", "enc_attlwbs"), ("res_fusion", "res_attlwbs")):
        for i in range(16):
            base = f"{prefix}.{i}"
            if f"{base}.fq.weight" not in sd:
                continue
            for head in ("fq", "fk", "fv"):
                put([f"{group}_{i}", head], f"{base}.{head}")
            put([f"{group}_{i}", "SPADE_0", "Conv_0"], f"{base}.spade.mlp_shared.0")
            put([f"{group}_{i}", "SPADE_0", "Conv_1"], f"{base}.spade.mlp_gamma")
            put([f"{group}_{i}", "SPADE_0", "Conv_2"], f"{base}.spade.mlp_beta")

    # TSF res blocks
    for i in range(16):
        a = f"res_blocks.{i}.main.0"
        if a + ".weight" in sd:
            put([f"tsf_res_blocks_{i}", "Conv_0"], a)
            put([f"tsf_res_blocks_{i}", "Conv_1"], f"res_blocks.{i}.main.2")

    # skip decoder + heads
    for i in range(8):
        up = f"tsf_net_dec.upconvs.{i}.0"
        if up + ".weight" in sd:
            put(["tsf_net_dec", f"ConvTranspose_{i}"], up, transpose=True)
        sk = f"tsf_net_dec.skippers.{i}.0"
        if sk + ".weight" in sd:
            put(["tsf_net_dec", f"Conv_{i}"], sk)
    if "tsf_img_reg.0.weight" in sd:
        put(["tsf_heads", "Conv_0"], "tsf_img_reg.0")
        put(["tsf_heads", "Conv_1"], "tsf_att_reg.0")
    return _finish(tree, params), report


def convert_discriminator(sd: Mapping, like: Like) -> tuple[dict[str, np.ndarray], list[str]]:
    """A reference discriminator checkpoint -> the discriminator's flat
    parameters: a bare patch D (`model.{i}`), the global / body / head (/ bg)
    family (`{global,body,head,bg}_model.model.{i}`) and the multi-scale
    pyramid (`scale_models.{s}.model.{i}`). Instance norm has no parameters,
    so only conv kernels and biases map, torch's conv indices in order onto
    `Conv_{j}`."""
    sd = _normalize_sd(sd)
    tree, params = _mutable_like(like)
    report: list[str] = []
    # conv keys grouped by their submodule prefix (everything before ".model.")
    groups: dict[str, list[int]] = {}
    for k in sd:
        if ".weight" not in k or ".model." not in k and not k.startswith("model."):
            continue
        if k.startswith("model."):
            prefix, idx = "", k.split(".")[1]
        else:
            prefix = k.split(".model.")[0]
            idx = k.split(".model.")[1].split(".")[0]
        if not idx.isdigit():
            continue
        groups.setdefault(prefix, []).append(int(idx))

    for prefix, idxs in sorted(groups.items()):
        if prefix == "":
            dest = params
        elif prefix.startswith("scale_models."):
            dest = params.get("scale_models_" + prefix.split(".")[1])
        else:
            dest = params.get(prefix)
        if dest is None:
            report.append("NO DEST " + (prefix or "<root>"))
            continue
        for j, idx in enumerate(sorted(set(idxs))):
            key = f"{prefix}.model.{idx}" if prefix else f"model.{idx}"
            for leaf, val in _conv(sd, key).items():
                _assign(dest, [f"Conv_{j}", leaf], val, report)
    return _finish(tree, params), report


# ---------------------------------------------------------------------------
# Loss and metric networks
# ---------------------------------------------------------------------------

def convert_sphereface(sd: Mapping, like: Like) -> tuple[dict[str, np.ndarray], list[str]]:
    """A sphere20a checkpoint -> `criterions.SphereFaceFeatures`: conv{s}_{i},
    relu{s}_{i} (PReLU `weight`), fc5 (the classification head is ignored).
    fc5 reads the NCHW-flattened stage-4 map in both, so its weight is a plain
    transpose."""
    sd = _normalize_sd(sd)
    tree, params = _mutable_like(like)
    report: list[str] = []
    stages = {1: (1, 2, 3), 2: (1, 2, 3, 4, 5), 3: tuple(range(1, 10)), 4: (1, 2, 3)}
    for s, ids in stages.items():
        for i in ids:
            _put_conv(sd, params, f"conv{s}_{i}", [f"conv{s}_{i}"], report)
            key = f"relu{s}_{i}.weight"
            if key in sd:
                _assign(params, [f"relu{s}_{i}", "weight"], sd[key], report)
            else:
                report.append("ABSENT " + key)
    _put_dense(sd, params, "fc5", ["fc5"], report)
    return _finish(tree, params), report


# torchvision vgg19 / vgg16 / vgg11 `.features` conv indices, in order (relu
# and pool layers carry no parameters): conv{si}_{wi} of `VGGFeatures`
_VGG19_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)
_VGG16_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG11_CONV_IDS = (0, 3, 6, 8, 11, 13, 16, 18)


def _convert_vgg(sd: Mapping, like: Like, conv_ids, slices) -> tuple[dict[str, np.ndarray], list[str]]:
    sd = _normalize_sd(sd)
    sd = {k[len("vgg."):] if k.startswith("vgg.") else k: v for k, v in sd.items()}
    tree, params = _mutable_like(like)
    report: list[str] = []
    flat = 0
    for si, widths in enumerate(slices):
        for wi in range(len(widths)):
            _put_conv(sd, params, f"features.{conv_ids[flat]}", [f"conv{si}_{wi}"], report)
            flat += 1
    return _finish(tree, params), report


def convert_vgg19(sd: Mapping, like: Like) -> tuple[dict[str, np.ndarray], list[str]]:
    """A torchvision `vgg19` state dict (bare `features.<i>` or under `vgg.`)
    -> `criterions.VGGFeatures`."""
    from ipercore_tpu_torch.models.networks.criterions import _VGG19_SLICES

    return _convert_vgg(sd, like, _VGG19_CONV_IDS, _VGG19_SLICES)


def convert_vgg16(sd: Mapping, like: Like) -> tuple[dict[str, np.ndarray], list[str]]:
    """A torchvision `vgg16` state dict -> `criterions.build_vgg("VGG16")`."""
    from ipercore_tpu_torch.models.networks.criterions import _VGG16_SLICES

    return _convert_vgg(sd, like, _VGG16_CONV_IDS, _VGG16_SLICES)


def convert_vgg11(sd: Mapping, like: Like) -> tuple[dict[str, np.ndarray], list[str]]:
    """A torchvision `vgg11` state dict -> `criterions.build_vgg("VGG11")`."""
    from ipercore_tpu_torch.models.networks.criterions import _VGG11_SLICES

    return _convert_vgg(sd, like, _VGG11_CONV_IDS, _VGG11_SLICES)


def convert_senet50(sd: Mapping, like: Like) -> tuple[dict[str, np.ndarray], list[str]]:
    """A VGGFace2 SENet-50 state dict -> `criterions.SENetFaceFeatures`:
    conv1 / bn1 stem; layer{L}.{i}.conv{1..5} (conv4 / conv5 the SE gate,
    biased) + bn{1..3} + optional downsample.{0,1}; an optional `net.`
    prefix."""
    sd = _normalize_sd(sd)
    sd = {k[len("net."):] if k.startswith("net.") else k: v for k, v in sd.items()}
    tree, params = _mutable_like(like)
    report: list[str] = []
    _put_conv(sd, params, "conv1", ["conv1"], report)
    _put_bn(sd, params, "bn1", ["bn1"], report)
    for li, blocks in enumerate((3, 4, 6, 3), start=1):
        for bi in range(blocks):
            t, f = f"layer{li}.{bi}", [f"layer{li}_{bi}"]
            for j in (1, 2, 3, 4, 5):
                _put_conv(sd, params, f"{t}.conv{j}", f + [f"conv{j}"], report)
            for j in (1, 2, 3):
                _put_bn(sd, params, f"{t}.bn{j}", f + [f"bn{j}"], report)
            if f"{t}.downsample.0.weight" in sd:
                _put_conv(sd, params, f"{t}.downsample.0", f + ["downsample_conv"], report)
                _put_bn(sd, params, f"{t}.downsample.1", f + ["downsample_bn"], report)
    return _finish(tree, params), report


def convert_inception(sd: Mapping, like: Like) -> tuple[dict[str, np.ndarray], list[str]]:
    """A torchvision `inception_v3` state dict -> `inception.InceptionV3Features`.
    The aux classifier (`AuxLogits.*`) and `fc.*` are ignored (FID reads the
    pool3 features); every BasicConv2d maps by its torchvision name, and a
    target the checkpoint never named is reported `UNFILLED`."""
    sd = _normalize_sd(sd)
    tree, params = _mutable_like(like)
    report: list[str] = []
    prefixes = {k[: -len(".conv.weight")] for k in sd
                if not k.startswith(("AuxLogits.", "fc.")) and k.endswith(".conv.weight")}
    for p in sorted(prefixes):
        _put_basicconv(sd, params, p, p.split("."), report)
    named = {tuple(p.split(".")) for p in prefixes}

    def walk(node, path):
        if "conv" in node and "bn_scale" in node:
            if path not in named:
                report.append("UNFILLED " + "/".join(path))
            return
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))

    walk(params, ())
    return _finish(tree, params), report


def convert_lpips(sd: Mapping, like: Like) -> tuple[dict[str, np.ndarray], list[str]]:
    """An official `lpips.LPIPS(net='vgg')` state dict -> `criterions.LPIPSLin`:
    `[net.]slice{1..5}.{i}` (VGG16 convs at the slices' local indices) and
    `lin{k}.model.1` or `lins.{k}.model.1` (the 1x1 bias-free metric convs).
    The scaling layer's buffers are the ImageNet normalization of [-1, 1]
    inputs that `VGGFeatures` applies: checked, not copied."""
    sd = _normalize_sd(sd)
    tree, params = _mutable_like(like)
    report: list[str] = []
    vgg = params.get("vgg")
    if vgg is None:
        report.append("NO DEST vgg")
        return _finish(tree, params), report
    slice_convs = {1: (0, 2), 2: (5, 7), 3: (10, 12, 14), 4: (17, 19, 21), 5: (24, 26, 28)}
    starts = {1: 0, 2: 4, 3: 9, 4: 16, 5: 23}
    for si in range(1, 6):
        for wi, idx in enumerate(slice_convs[si]):
            key = f"net.slice{si}.{idx - starts[si]}"
            if key + ".weight" not in sd:
                key = f"slice{si}.{idx - starts[si]}"
            _put_conv(sd, vgg, key, [f"conv{si - 1}_{wi}"], report)
    for k in range(5):
        key = f"lin{k}.model.1"
        if key + ".weight" not in sd:
            key = f"lins.{k}.model.1"
        _put_conv(sd, params, key, [f"lin{k}"], report)
    want = {"scaling_layer.shift": np.array([-0.030, -0.088, -0.188]),
            "scaling_layer.scale": np.array([0.458, 0.448, 0.450])}
    for name, w in want.items():
        got = sd.get(name)
        if got is not None:
            got = np.asarray(got).reshape(-1)
            if got.shape != (3,) or not np.allclose(got, w, atol=1e-3):
                report.append(f"SCALING MISMATCH {name}: {got.tolist()}")
    return _finish(tree, params), report
