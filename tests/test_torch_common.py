"""Shared helpers for the parity tests of the PyTorch port (holds no test).

Inputs are made with numpy from a seed and handed to both packages as numpy
arrays; the JAX package runs on the CPU, its Pallas kernels in interpret mode.
"""
import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# the published weight files in this repository's history (assets/WEIGHTS.md)
WEIGHTS_COMMIT = "1448015"
_restored: dict[str, str] = {}

NARROW_CFG = {
    "BGNet": {"num_filters": [8, 16, 16, 32], "n_res_block": 2},
    "SIDNet": {"num_filters": [8, 16, 32], "n_res_block": 2},
    "TSFNet": {"num_filters": [8, 16, 32], "n_res_block": 2},
}
FULL_CFG = {
    "BGNet": {"num_filters": [64, 128, 128, 256], "n_res_block": 6},
    "SIDNet": {"num_filters": [64, 128, 256], "n_res_block": 6},
    "TSFNet": {"num_filters": [64, 128, 256], "n_res_block": 6},
}


def history_weights(name: str, tmp_path_factory) -> str:
    """Path of `assets/<name>.npz`: the file when it is on disk, else its blob
    from git history, written once per test session into the session's
    temporary directory (never into `assets/`, and nothing is staged). Skips
    only outside a git work tree or when the object is missing."""
    on_disk = os.path.join(ROOT, "assets", f"{name}.npz")
    if os.path.exists(on_disk):
        return on_disk
    if name not in _restored:
        def git(*args, **kw):
            return subprocess.run(["git", *args], cwd=ROOT, **kw)

        blob = f"{WEIGHTS_COMMIT}:assets/{name}.npz"
        inside = git("rev-parse", "--is-inside-work-tree", capture_output=True, text=True)
        if inside.returncode != 0 or inside.stdout.strip() != "true":
            pytest.skip(f"{name}.npz is not on disk and this is no git work tree")
        if git("cat-file", "-e", blob, capture_output=True).returncode != 0:
            pytest.skip(f"{name}.npz is not on disk and git has no {blob}")
        path = str(tmp_path_factory.mktemp("weights") / f"{name}.npz")
        with open(path, "wb") as f:
            git("cat-file", "blob", blob, stdout=f, check=True)
        _restored[name] = path
    return _restored[name]


def pretrained_generator_npz(tmp_path_factory) -> str:
    """Path of `lwg_pretrained_G.npz` (see `history_weights`)."""
    return history_weights("lwg_pretrained_G", tmp_path_factory)


def t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype)  # copy: jax arrays are read-only


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scene() -> np.ndarray:
    """The 64-triangle scene of the JAX package's own raster tests: two big
    overlapping triangles, one off-screen, one more, and 60 small random ones."""
    def tri(v0, v1, v2, z):
        return [[list(v0) + [z], list(v1) + [z], list(v2) + [z]]]

    rng = np.random.RandomState(0)
    tris = [
        tri((-0.9, -0.9), (0.9, -0.9), (0, 0.9), 1.0),
        tri((-0.5, -0.5), (0.5, -0.5), (0, 0.5), 0.5),
        tri((-5, -5), (-4, -5), (-4.5, -4), 1.0),
        tri((0.2, 0.2), (0.9, 0.3), (0.5, 0.9), 0.8),
    ]
    for _ in range(60):
        c = rng.uniform(-0.9, 0.9, 2)
        d = rng.uniform(0.02, 0.2, (3, 2))
        z = rng.uniform(0.5, 3.0)
        tris.append([[list(c + d[i]) + [z] for i in range(3)]])
    return np.concatenate(tris, axis=0).astype(np.float32)


def small_models(nu=20, nv=18):
    """The same small synthetic body in both packages: (jax model, torch model)."""
    from ipercore_tpu.models import smpl as jsmpl
    from ipercore_tpu_torch.models import smpl as tsmpl

    return jsmpl.synthetic_model(nu=nu, nv=nv), tsmpl.synthetic_model(nu=nu, nv=nv, device="cpu")


def thetas(count: int, seed: int, pose_scale: float = 0.1) -> np.ndarray:
    rng = np.random.RandomState(seed)
    th = np.zeros((count, 85), np.float32)
    th[:, 0] = 1.2
    th[:, 3:75] = rng.randn(count, 72).astype(np.float32) * pose_scale
    th[:, 75:] = rng.randn(count, 10).astype(np.float32) * 0.3
    return th


def body_face_verts(count: int, seed: int, nu=20, nv=18) -> np.ndarray:
    """(count, F, 3, 3) projected faces of the small body in random poses."""
    from ipercore_tpu.models import smpl as jsmpl
    from ipercore_tpu.ops import rasterizer as jrz

    jm, _ = small_models(nu, nv)
    d = jsmpl.get_details(jm, jnp.asarray(thetas(count, seed)))
    return np.asarray(jrz.verts_to_faces(jrz.project_verts(d["verts"], d["cam"]), jm.faces))


def flatten_flax(params, prefix="") -> dict:
    """Flax parameter tree -> flat {'a/b/kernel': array}, as the JAX
    package's checkpoint writer flattens it."""
    from ipercore_tpu.utils.checkpoint import _flatten

    return _flatten(jax_to_numpy_tree(params))


def jax_to_numpy_tree(tree):
    if hasattr(tree, "keys"):
        return {k: jax_to_numpy_tree(tree[k]) for k in tree.keys()}
    return np.asarray(tree)


def unflatten_to_jax(flat: dict) -> dict:
    from ipercore_tpu.utils.checkpoint import _unflatten

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return jnp.asarray(node)

    return conv(_unflatten(flat))


def write_train_video(root: str, name: str, n_frames: int, seed: int, size: int = 64,
                      mask_size: int | None = None, background: bool = False,
                      front_ids: tuple = ()) -> None:
    """A processed training video under `<root>/primitives/<name>/processed`:
    `n_frames` random frames at `size`², SMPLs, optionally masks (at
    `mask_size`², background = 1 outside a disc), a pseudo-background and
    front ids, from a seed (the port's writers; both packages read them)."""
    from ipercore_tpu_torch.services.meta_info import MetaProcess
    from ipercore_tpu_torch.services.process_info import ProcessInfo
    from ipercore_tpu_torch.utils import video as vid

    rng = np.random.RandomState(seed)
    info = ProcessInfo(MetaProcess(name, root).make_dirs().processed_dir, name=name)
    os.makedirs(os.path.join(info.processed_dir, "images"), exist_ok=True)
    names = [f"frame_{i:08d}.png" for i in range(n_frames)]
    for nm in names:
        vid.save_image(os.path.join(info.processed_dir, "images", nm),
                       rng.uniform(-1, 1, (size, size, 3)).astype(np.float32))
    info.meta["valid_img_names"] = names
    smpls = thetas(n_frames, seed=seed, pose_scale=0.15)
    smpls[:, 1:3] = rng.randn(n_frames, 2).astype(np.float32) * 0.03
    info.set_array("smpls", smpls)
    if mask_size:
        yy, xx = np.mgrid[:mask_size, :mask_size]
        r = mask_size / 3 * (1 + 0.2 * rng.rand(n_frames))[:, None, None]
        c = mask_size / 2
        info.set_array("masks", (((yy - c) ** 2 + (xx - c) ** 2)[None] > r ** 2).astype(np.float32))
    if background:
        vid.save_image(os.path.join(info.processed_dir, "background.png"),
                       rng.uniform(-1, 1, (size, size, 3)).astype(np.float32))
    if front_ids:
        info.set_array("ft_ids", np.asarray(front_ids, np.int64))
    info.serialize()


def reference_generator_state_dict(flat: dict, seed: int) -> dict:
    """A state dict in the reference's AttLWB-SPADE `.pth` layout (the torch
    names `utils/torch_convert.convert_generator` reads, each the name map's
    inverse) for the generator whose flat Flax parameters are `flat`, with
    random values in torch's layout: conv weights (O, I, kH, kW), transposed
    conv weights (I, O, kH, kW). Built from the name map alone: a run of
    JAX's converter over it must report nothing missing."""
    rng = np.random.RandomState(seed)
    tree: dict = {}
    for k in flat:
        parts = k.split("/")[1:]
        tree.setdefault("/".join(parts[:-1]), []).append(parts[-1])
    n_res_bg = sum(1 for m in tree if m.startswith("bg_net/ResidualBlockIN_") and m.endswith("Conv_0"))

    def torch_name(module: str) -> str:
        p = module.split("/")
        if p[0] == "bg_net":
            if p[1].startswith("ResidualBlockIN_"):
                i = int(p[1].split("_")[1])
                return f"bg_net.main.{12 + i}.main.{0 if p[2] == 'Conv_0' else 3}"
            if p[1].startswith("ConvTranspose_"):
                return f"bg_net.main.{12 + n_res_bg + 3 * int(p[1].split('_')[1])}"
            i = int(p[1].split("_")[1])
            return "bg_net.main.0" if i == 0 else (f"bg_net.main.{3 * i}" if i <= 3 else
                                                    f"bg_net.main.{12 + n_res_bg + 9}")
        if p[0] == "src_net":
            if p[1] == "encoders":
                return f"src_net.encoders.layers.{p[2].split('_')[1]}.0"
            if p[1] == "decoders":
                return f"src_net.decoders.layers.{p[2].split('_')[1]}.0"
            if p[1] == "heads":
                return "src_net.img_reg.0" if p[2] == "Conv_0" else "src_net.att_reg.0"
            return f"src_net.res_blocks.{p[1].split('_')[2]}.main.{0 if p[2] == 'Conv_0' else 2}"
        if p[0].startswith("tsf_enc_"):
            return f"tsf_net_enc.layers.{p[0].split('_')[2]}.0"
        if p[0].startswith(("enc_fusion_", "res_fusion_")):
            base = f"{p[0].split('_')[0]}_attlwbs.{p[0].split('_')[2]}"
            if p[1] in ("fq", "fk", "fv"):
                return f"{base}.{p[1]}"
            return base + {"Conv_0": ".spade.mlp_shared.0", "Conv_1": ".spade.mlp_gamma",
                           "Conv_2": ".spade.mlp_beta"}[p[2]]
        if p[0].startswith("tsf_res_blocks_"):
            return f"res_blocks.{p[0].split('_')[3]}.main.{0 if p[1] == 'Conv_0' else 2}"
        if p[0] == "tsf_net_dec":
            kind, i = p[1].split("_")
            return f"tsf_net_dec.{'upconvs' if kind == 'ConvTranspose' else 'skippers'}.{i}.0"
        return "tsf_img_reg.0" if p[1] == "Conv_0" else "tsf_att_reg.0"

    sd = {}
    for module, leaves in tree.items():
        name = torch_name(module)
        kh, kw, i, o = flat[f"params/{module}/kernel"].shape
        shape = (i, o, kh, kw) if "ConvTranspose_" in module else (o, i, kh, kw)
        sd[name + ".weight"] = rng.randn(*shape).astype(np.float32) * 0.05
        if "bias" in leaves:
            sd[name + ".bias"] = rng.randn(o).astype(np.float32) * 0.05
    return sd
