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
PRETRAINED_G = os.path.join(ROOT, "assets", "lwg_pretrained_G.npz")
# the published generator weights in this repository's history (assets/WEIGHTS.md)
PRETRAINED_G_BLOB = "1448015:assets/lwg_pretrained_G.npz"
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


def pretrained_generator_npz(tmp_path_factory) -> str:
    """Path of `lwg_pretrained_G.npz`: the file in `assets/` when it is on
    disk, else its blob from git history, written once per test session into
    the session's temporary directory (never into `assets/`, and nothing is
    staged). Skips only outside a git work tree or when the object is missing."""
    if os.path.exists(PRETRAINED_G):
        return PRETRAINED_G
    if "G" not in _restored:
        def git(*args, **kw):
            return subprocess.run(["git", *args], cwd=ROOT, **kw)

        inside = git("rev-parse", "--is-inside-work-tree", capture_output=True, text=True)
        if inside.returncode != 0 or inside.stdout.strip() != "true":
            pytest.skip("lwg_pretrained_G.npz is not on disk and this is no git work tree")
        if git("cat-file", "-e", PRETRAINED_G_BLOB, capture_output=True).returncode != 0:
            pytest.skip(f"lwg_pretrained_G.npz is not on disk and git has no {PRETRAINED_G_BLOB}")
        path = str(tmp_path_factory.mktemp("weights") / "lwg_pretrained_G.npz")
        with open(path, "wb") as f:
            git("cat-file", "blob", PRETRAINED_G_BLOB, stdout=f, check=True)
        _restored["G"] = path
    return _restored["G"]


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
