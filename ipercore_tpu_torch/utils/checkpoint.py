"""Flat-npz parameters and the weight carrier between the Flax layout and
torch modules.

Twin of `save_params` / `load_params` of `ipercore_tpu/utils/checkpoint.py`.
The JAX package stores a Flax parameter tree as a flat npz keyed by
'/'-joined paths (`params/bg_net/Conv_0/kernel`). The port's modules carry
the Flax module names, so the carrier is mechanical:

  * key `params/a/b/kernel` -> `a.b.weight`, any other `params/a/b/x` -> `a.b.x`;
  * Conv kernel (kH, kW, I, O) -> (O, I, kH, kW);
  * Flax `ConvTranspose(4x4, stride 2, "SAME")` kernel (kH, kW, I, O) ->
    flipped spatially, (I, O, kH, kW), run as
    `conv_transpose2d(stride=2, padding=1)`;
  * Dense kernel (I, O) -> Linear weight (O, I).

`torch_params_to_flax` is its inverse, so a checkpoint the port writes is one
the JAX package reads, and the reverse. `seeded_flat_params` makes a full set
of random weights in the Flax layout from a numpy seed, so that a run that has
no weight file goes through the same carrier as real weights.

The training checkpoints (`save_train_ckpt` / `load_train_ckpt`,
`find_latest_iter`) are the JAX package's files: `net_iter_<it>_id_{G,D}.npz`
through the carrier, and `opt_iter_<it>_id_{G,D}.npz` holding an `AdamState`
as the leaves of optax's state (`adam_state_to_leaves`), so a run started by
one package resumes in the other.
"""
from __future__ import annotations

import os
import re
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

# the repository's weight files (`assets/WEIGHTS.md`), where the JAX package
# looks for them too
WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "assets")


def load_flat_npz(path: str) -> dict[str, np.ndarray]:
    """Read a flat-npz parameter file into {key: array}."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _torch_key(flax_key: str) -> tuple[str, bool]:
    """Flax flat key -> (state-dict key, is_kernel)."""
    parts = flax_key.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    is_kernel = parts[-1] == "kernel"
    if is_kernel:
        parts[-1] = "weight"
    return ".".join(parts), is_kernel


def _is_transpose(key: str) -> bool:
    return "ConvTranspose_" in key


def flax_params_to_torch(flat: dict[str, np.ndarray], like: dict | None = None) -> dict[str, torch.Tensor]:
    """Carry a flat Flax parameter dict into a torch state dict.

    Args:
        flat: {flax key: array} in the Flax layout.
        like: optional state dict (e.g. `generator.state_dict()`) to check
            against. With it the conversion is strict: a ValueError lists
            missing keys, unexpected keys and shape mismatches, and the
            tensors take `like`'s dtypes.

    Returns:
        {state-dict key: tensor} on the CPU.
    """
    out: dict[str, torch.Tensor] = {}
    for fk, arr in flat.items():
        tk, is_kernel = _torch_key(fk)
        a = np.asarray(arr)
        if is_kernel and a.ndim == 4:
            if _is_transpose(fk):
                a = np.flip(a, axis=(0, 1)).transpose(2, 3, 0, 1)
            else:
                a = a.transpose(3, 2, 0, 1)
        elif is_kernel and a.ndim == 2:
            a = a.T
        out[tk] = torch.from_numpy(np.array(a, order="C"))  # a writable, dense copy
    if like is not None:
        missing = sorted(set(like) - set(out))
        unexpected = sorted(set(out) - set(like))
        mismatched = sorted(
            f"{k}: checkpoint {tuple(out[k].shape)} vs model {tuple(like[k].shape)}"
            for k in set(out) & set(like) if tuple(out[k].shape) != tuple(like[k].shape))
        if missing or unexpected or mismatched:
            raise ValueError(
                f"checkpoint does not fit the model: {len(missing)} missing {missing[:8]}; "
                f"{len(unexpected)} unexpected {unexpected[:8]}; "
                f"{len(mismatched)} shape mismatches {mismatched[:8]}")
        out = {k: v.to(like[k].dtype) for k, v in out.items()}
    return out


def load_generator_params(module: torch.nn.Module, flat: dict[str, np.ndarray]) -> None:
    """Strictly load a flat Flax parameter dict into `module` (a generator or
    any other network of the port) in place."""
    module.load_state_dict(flax_params_to_torch(flat, like=module.state_dict()), strict=True)


def _kernel_kind(module: nn.Module, torch_key: str) -> str | None:
    """'conv', 'deconv' or 'dense' when `torch_key` is the weight of such a
    layer of `module` (its Flax name is `kernel`), else None."""
    owner, _, leaf = torch_key.rpartition(".")
    if leaf != "weight":
        return None
    layer = module.get_submodule(owner) if owner else module
    if isinstance(layer, nn.ConvTranspose2d):
        return "deconv"
    if isinstance(layer, nn.Conv2d):
        return "conv"
    if isinstance(layer, nn.Linear):
        return "dense"
    return None


def _flax_entry(module: nn.Module, torch_key: str) -> tuple[str, str | None]:
    kind = _kernel_kind(module, torch_key)
    parts = torch_key.split(".")
    if kind is not None:
        parts[-1] = "kernel"
    return "params/" + "/".join(parts), kind


def _flax_shape(shape: tuple[int, ...], kind: str | None) -> tuple[int, ...]:
    if kind == "conv":
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    if kind == "deconv":
        i, o, kh, kw = shape
        return (kh, kw, i, o)
    if kind == "dense":
        return shape[::-1]
    return shape


def _to_flax_layout(a: np.ndarray, kind: str | None) -> np.ndarray:
    if kind == "conv":
        return a.transpose(2, 3, 1, 0)
    if kind == "deconv":
        return np.flip(a.transpose(2, 3, 0, 1), axis=(0, 1))
    if kind == "dense":
        return a.T
    return a


def torch_params_to_flax(module: nn.Module,
                         params: Mapping[str, torch.Tensor] | None = None) -> dict[str, np.ndarray]:
    """The inverse carrier: `params` (state-dict keys; default the module's own
    state dict) -> {flax key: float32 array in the Flax layout}."""
    params = module.state_dict() if params is None else params
    out = {}
    for k, v in params.items():
        key, kind = _flax_entry(module, k)
        a = v.detach().to("cpu", torch.float32).numpy()
        out[key] = np.ascontiguousarray(_to_flax_layout(a, kind))
    return out


def save_params(path: str, flat: Mapping[str, np.ndarray]) -> None:
    """Write a flat Flax parameter dict as a compressed npz (through a
    temporary file and a rename, as the JAX package writes it)."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, path)


def load_params(path: str, like: nn.Module) -> dict[str, torch.Tensor]:
    """Read a flat-npz checkpoint as a state dict of `like`, strictly: a
    ValueError lists missing keys, unexpected keys and shape mismatches."""
    return flax_params_to_torch(load_flat_npz(path), like=like.state_dict())


def seeded_flat_params(model, seed: int = 0) -> dict[str, np.ndarray]:
    """Random weights in the Flax layout, from a numpy seed.

    `model` is a network of the port, or a generator config (then the keys
    and shapes are those of the AttLWB-SPADE generator it describes: 221
    arrays at full width). Kernels are N(0, 1) / sqrt(fan_in), which is about
    0.02 for the 3x3x256 convolutions that make up most of the generator and
    keeps activations at unit scale through its depth; biases are zero; PReLU
    slopes are 0.25; a frozen batch norm starts at scale 1, mean 0, variance
    1. Only kernels draw from `np.random.default_rng(seed)`, in sorted key
    order.
    """
    if not isinstance(model, nn.Module):
        from ipercore_tpu_torch.models.networks.generators import LWBGenerator

        with torch.device("meta"):
            model = LWBGenerator(model)
    from ipercore_tpu_torch.models.networks.blocks import FrozenBatchNorm
    from ipercore_tpu_torch.models.networks.criterions import ChannelPReLU

    fill = {}
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, ChannelPReLU):
            fill[pre + "weight"] = 0.25
        elif isinstance(m, FrozenBatchNorm):
            fill[pre + "scale"] = fill[pre + "var"] = 1.0
        for leaf in ("bn_scale", "bn_var"):  # a batch norm held by its conv (Inception)
            if hasattr(m, leaf):
                fill[pre + leaf] = 1.0
    rng = np.random.default_rng(seed)
    entries = []
    for k, v in model.state_dict().items():
        key, kind = _flax_entry(model, k)
        entries.append((key, _flax_shape(tuple(v.shape), kind), kind, fill.get(k, 0.0)))
    flat: dict[str, np.ndarray] = {}
    for key, shape, kind, value in sorted(entries):
        if kind is not None:
            fan_in = int(np.prod(shape[:-1]))
            flat[key] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        else:
            flat[key] = np.full(shape, value, np.float32)
    return flat


# --- training checkpoints: parameters and both optimizer states ----------------

def find_latest_iter(ckpt_dir: str, net_id: str = "G") -> tuple[int, str | None]:
    """The latest `net_iter_<it>_id_<net_id>.npz` in `ckpt_dir`: (iteration,
    path), or (-1, None) when there is none."""
    best, best_path = -1, None
    if not os.path.isdir(ckpt_dir):
        return best, best_path
    pat = re.compile(rf"net_iter_(\d+)_id_{net_id}\.npz$")
    for f in os.listdir(ckpt_dir):
        m = pat.match(f)
        if m and int(m.group(1)) > best:
            best, best_path = int(m.group(1)), os.path.join(ckpt_dir, f)
    return best, best_path


def _flax_order(module: nn.Module, params: Mapping[str, torch.Tensor]) -> list[tuple[str, str]]:
    """(state-dict key, flax key) of every parameter in the order of the Flax
    tree's leaves: sorted by path, level by level."""
    keys = [(k, _flax_entry(module, k)[0]) for k in params]
    return sorted(keys, key=lambda kv: kv[1].split("/"))


def adam_state_to_leaves(module: nn.Module, state, scheduled: bool) -> list[np.ndarray]:
    """An `AdamState` as the leaves of the JAX package's optax state of
    apply_if_finite(chain(clip_by_global_norm, adam)): notfinite_count (i32),
    last_finite (bool), total_notfinite (i32), the Adam count (i32), the first
    moments, then the second, each in the Flax tree's order and layout, and
    with a learning-rate schedule (`scheduled`) the schedule's count, which
    optax advances with the Adam count."""
    mu = torch_params_to_flax(module, state.mu)
    nu = torch_params_to_flax(module, state.nu)
    order = [fk for _, fk in _flax_order(module, state.mu)]
    scalar = lambda t, dt: np.asarray(t.detach().cpu().numpy(), dt)
    count = scalar(state.count, np.int32)
    leaves = [scalar(state.notfinite_count, np.int32), scalar(state.last_finite, np.bool_),
              scalar(state.total_notfinite, np.int32), count]
    leaves += [mu[k] for k in order] + [nu[k] for k in order]
    if scheduled:
        leaves.append(count.copy())
    return leaves


def adam_state_from_leaves(module: nn.Module, leaves: list[np.ndarray], like, scheduled: bool,
                           what: str = "optimizer state"):
    """The inverse of `adam_state_to_leaves`: an `AdamState` like `like`
    (device, dtypes, keys). A leaf count that does not fit raises, naming
    `what`."""
    order = _flax_order(module, like.mu)
    want = 4 + 2 * len(order) + int(scheduled)
    if len(leaves) != want:
        raise ValueError(f"{what}: {len(leaves)} saved leaves vs {want} expected "
                         "— optimizer/config structure changed since the checkpoint")
    n = len(order)

    def moments(arrays):
        flat = {fk: a for (_, fk), a in zip(order, arrays)}
        tensors = flax_params_to_torch(flat, like={k: like.mu[k] for k, _ in order})
        return {k: tensors[k].to(like.mu[k].device) for k in like.mu}

    def scalar(a, ref):
        return torch.as_tensor(np.asarray(a), dtype=ref.dtype, device=ref.device)

    return type(like)(
        count=scalar(leaves[3], like.count), mu=moments(leaves[4:4 + n]), nu=moments(leaves[4 + n:4 + 2 * n]),
        notfinite_count=scalar(leaves[0], like.notfinite_count), last_finite=scalar(leaves[1], like.last_finite),
        total_notfinite=scalar(leaves[2], like.total_notfinite))


def save_leaves(path: str, leaves: list[np.ndarray]) -> None:
    """Write arrays as the npz entries `leaf_00000`, `leaf_00001`, ... (the
    JAX package's `save_pytree` file), through a temporary file."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **{f"leaf_{i:05d}": a for i, a in enumerate(leaves)})
    os.replace(tmp, path)


def load_leaves(path: str) -> list[np.ndarray]:
    """The arrays of a `save_leaves` (or `save_pytree`) file, in order."""
    with np.load(path) as z:
        return [z[k] for k in sorted(z.files)]


def train_ckpt_paths(ckpt_dir: str, step: int) -> dict[str, str]:
    """The four files of a training checkpoint at `step`: {"net_G", "net_D",
    "opt_G", "opt_D"} -> `<ckpt_dir>/<kind>_iter_<step>_id_<net>.npz`."""
    return {f"{kind}_{net}": os.path.join(ckpt_dir, f"{kind}_iter_{step}_id_{net}.npz")
            for kind in ("net", "opt") for net in ("G", "D")}


def save_train_ckpt(ckpt_dir: str, step: int, state, generator: nn.Module, discriminator: nn.Module,
                    scheduled: bool = False) -> None:
    """`net_iter_<step>_id_{G,D}.npz` (parameters in the Flax layout) and
    `opt_iter_<step>_id_{G,D}.npz` (both optimizer states as optax's leaves)
    of a `LWGTrainState`, the files the JAX package's `save_train_ckpt` writes.
    `scheduled`: the learning rate follows a schedule (`niters_decay > 0`)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    paths = train_ckpt_paths(ckpt_dir, step)
    for net, module, params, opt in (("G", generator, state.params_G, state.opt_G),
                                     ("D", discriminator, state.params_D, state.opt_D)):
        save_params(paths[f"net_{net}"], torch_params_to_flax(module, params))
        save_leaves(paths[f"opt_{net}"], adam_state_to_leaves(module, opt, scheduled))


def load_train_ckpt(ckpt_dir: str, step: int, like_state, generator: nn.Module, discriminator: nn.Module,
                    scheduled: bool = False):
    """Restore what `save_train_ckpt` (of either package) wrote at `step` into
    a fresh `LWGTrainState` like `like_state`, with its step count set to
    `step`. G's parameters must exist; a missing D file or optimizer file
    keeps the fresh state."""
    def params(path, module, like):
        loaded = flax_params_to_torch(load_flat_npz(path), like=module.state_dict())
        return {k: loaded[k].to(like[k].device) for k in like}

    paths = train_ckpt_paths(ckpt_dir, step)
    params_G = params(paths["net_G"], generator, like_state.params_G)
    params_D = (params(paths["net_D"], discriminator, like_state.params_D) if os.path.exists(paths["net_D"])
                else like_state.params_D)
    opts = {}
    for net, module, like in (("G", generator, like_state.opt_G), ("D", discriminator, like_state.opt_D)):
        path = paths[f"opt_{net}"]
        opts[net] = (adam_state_from_leaves(module, load_leaves(path), like, scheduled, what=path)
                     if os.path.exists(path) else like)
    return like_state._replace(params_G=params_G, params_D=params_D, opt_G=opts["G"], opt_D=opts["D"],
                               step=torch.as_tensor(step, dtype=torch.int32, device=like_state.step.device))
