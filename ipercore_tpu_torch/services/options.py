"""Config engine: layered TOML + dotted-key CLI overrides.

Rebuilds `iPERCore/services/options/options_setup.py` (recursive_update_item:12,
update_extra_args:68, load_cfg:98, load_meta_data:140, save_cfg:226, setup:236)
and `options_base.py`. EasyDict is replaced by a small attribute-dict;
tomllib (stdlib) replaces the toml package for reading; saving uses a minimal
TOML writer (only the subset the configs use).

The port's own copy of `ipercore_tpu/services/options.py`, which imports no JAX;
the two read and write the same files.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Iterable, Mapping, Optional

try:  # py3.11+
    import tomllib
except ImportError:  # pragma: no cover
    tomllib = None


class AttrDict(dict):
    """dict with attribute access (EasyDict stand-in), recursive."""

    def __init__(self, d: Optional[Mapping] = None, **kw):
        super().__init__()
        d = dict(d or {}, **kw)
        for k, v in d.items():
            self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, Mapping) and not isinstance(v, AttrDict):
            v = AttrDict(v)
        elif isinstance(v, (list, tuple)):
            v = type(v)(AttrDict(x) if isinstance(x, Mapping) else x for x in v)
        super().__setitem__(k, v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


def load_toml(path: str) -> AttrDict:
    with open(path, "rb") as f:
        return AttrDict(tomllib.load(f))


def recursive_update_item(cfg: Mapping, key: str, value: Any) -> bool:
    """Set a dotted key (e.g. `Preprocess.Cropper.src_crop_factor`) anywhere in
    the nested config — `options_setup.py:12-47`. Returns True if set."""
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        if isinstance(node, Mapping) and p in node:
            node = node[p]
        else:
            return False
    leaf = parts[-1]
    if isinstance(node, Mapping) and leaf in node:
        old = node[leaf]
        node[leaf] = _coerce_like(old, value)
        return True
    # fall back: search one level deep for the dotted tail (reference semantics:
    # unique nested keys can be set without the full path)
    if len(parts) == 1:
        for v in cfg.values():
            if isinstance(v, Mapping) and recursive_update_item(v, key, value):
                return True
    return False


def _coerce_like(old: Any, value: Any) -> Any:
    if isinstance(value, str):
        if isinstance(old, bool):
            return value.lower() in ("1", "true", "yes")
        if isinstance(old, int) and not isinstance(old, bool):
            return int(value)
        if isinstance(old, float):
            return float(value)
    return value


def update_extra_args(cfg: Mapping, extra_args: Iterable[str]) -> Mapping:
    """Apply `--Dotted.Key value` pairs — `options_setup.py:68-95`."""
    args = list(extra_args)
    i = 0
    while i < len(args):
        tok = args[i]
        if tok.startswith("--"):
            key = tok[2:]
            if i + 1 < len(args) and not args[i + 1].startswith("--"):
                value = args[i + 1]
                i += 2
            else:
                value = "true"
                i += 1
            if not recursive_update_item(cfg, key, value):
                cfg[key.split(".")[-1]] = value  # new key at top level
        else:
            i += 1
    return cfg


def _toml_repr(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_repr(x) for x in v) + "]"
    raise TypeError(f"cannot TOML-serialize {type(v)}")


def save_cfg(cfg: Mapping, path: str) -> None:
    """Persist the merged config as TOML — `options_setup.py:226-233`."""
    lines = []

    def emit(d: Mapping, prefix: str):
        scalars = {k: v for k, v in d.items() if not isinstance(v, Mapping)}
        tables = {k: v for k, v in d.items() if isinstance(v, Mapping)}
        if prefix and scalars:
            lines.append(f"[{prefix}]")
        for k, v in scalars.items():
            try:
                lines.append(f"{k} = {_toml_repr(v)}")
            except TypeError:
                pass
        for k, v in tables.items():
            lines.append("")
            emit(v, f"{prefix}.{k}" if prefix else k)

    emit(cfg, "")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


DEFAULT_CFG = AttrDict(
    image_size=512,
    num_source=2,
    time_step=1,
    share_bg=True,
    bg_ks=11,
    ft_ks=1,
    only_vis=False,
    temporal=False,
    conf_erode_ks=3,
    out_dilate_ks=51,
    cam_strategy="smooth",
    gen_name="AttLWB-SPADE",
    dis_name="patch_global",
    train_name="LWGTrainer",
    batch_size=1,
    output_dir="./results",
    model_id="model",
    Train=AttrDict(
        lambda_rec=10.0, lambda_tsf=10.0, lambda_face=5.0,
        lambda_mask=5.0, lambda_mask_smooth=1.0, lambda_D_prob=1.0,
        lr_G=1e-4, lr_D=1e-4, use_face=True,
        # "sphere20a" auto-loads assets/faceloss.npz when shipped;
        # "random" forces random-projection features (A/B arm);
        # a path to an .npz loads that checkpoint (`faceloss.py:291-299`)
        face_loss_path="sphere20a",
        niters_or_epochs_no_decay=100, niters_or_epochs_decay=0,
    ),
    Generator=AttrDict(
        BGNet=AttrDict(num_filters=[64, 128, 128, 256], n_res_block=6, cond_nc=4),
        SIDNet=AttrDict(num_filters=[64, 128, 256], n_res_block=6, cond_nc=6),
        TSFNet=AttrDict(num_filters=[64, 128, 256], n_res_block=6, cond_nc=6),
    ),
    Discriminator=AttrDict(
        name="patch_global", cond_nc=6, bg_cond_nc=4, ndf=64, n_layers=4,
        max_nf_mult=8, use_sigmoid=False,
    ),
)


def setup(cfg_path: Optional[str] = None, extra_args: Iterable[str] = ()) -> AttrDict:
    """Load base TOML (or defaults), apply dotted overrides — `setup:236`."""
    import copy

    cfg = load_toml(cfg_path) if cfg_path else AttrDict(copy.deepcopy(dict(DEFAULT_CFG)))

    def fill_defaults(dst, src):
        """Recursive default merge: a user config with a partial [Train]
        table must still inherit the remaining Train defaults (a shallow
        merge silently dropped them — found driving the CLI)."""
        for k, v in src.items():
            if k not in dst:
                dst[k] = copy.deepcopy(v)
            elif isinstance(v, Mapping) and isinstance(dst[k], Mapping):
                fill_defaults(dst[k], v)

    fill_defaults(cfg, DEFAULT_CFG)
    update_extra_args(cfg, extra_args)
    return cfg


def base_parser() -> argparse.ArgumentParser:
    """CLI flags parity with `options_base.py:8-57` + inference options."""
    p = argparse.ArgumentParser(add_help=True)
    p.add_argument("--cfg_path", type=str, default=None)
    p.add_argument("--gpu_ids", type=str, default="0")  # accepted, unused: the caller picks the device
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--num_source", type=int, default=2)
    p.add_argument("--time_step", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--output_dir", type=str, default="./results")
    p.add_argument("--model_id", type=str, default="model")
    p.add_argument("--src_path", type=str, default="")
    p.add_argument("--ref_path", type=str, default="")
    p.add_argument("--T_pose", action="store_true")
    return p


def parse_args(argv: Optional[list[str]] = None) -> AttrDict:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = base_parser()
    known, extra = p.parse_known_args(argv)
    cfg = setup(known.cfg_path, extra)
    for k, v in vars(known).items():
        if k != "cfg_path":
            cfg[k] = v
    return cfg
