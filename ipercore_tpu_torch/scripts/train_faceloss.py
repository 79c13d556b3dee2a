"""Identity-contrastive training of the Sphere20a face-loss features.

Twin of `scripts/train_faceloss.py`. Identities are procedural textures and
body shapes; each batch renders every identity twice, as head close-ups
under two poses, cameras and photo augmentations (K1 at twice the scene
size); an NT-Xent loss on the l2-normalised fc5 embeddings of the two views'
head crops pulls an identity's views together. Ships `assets/faceloss.npz`
(f16), which `criterions.init_face_params` loads in both packages.

Randomness. The JAX driver gives both views one texture key, so they share
their texture draws. Here a batch takes two sources: `view`, a `Draws` for
the per-view draws, and `textures`, a function returning a fresh `Draws` over
one texture stream, called once per view, so both views draw the same
textures. Each view draws in the JAX driver's order, interleaving the two.

    python -m ipercore_tpu_torch.scripts.train_faceloss [--steps 1500] [--ids 12] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable

import numpy as np
import torch

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.models.imitator import reference_precision
from ipercore_tpu_torch.models.mesh import load_assets
from ipercore_tpu_torch.models.networks.criterions import SphereFaceFeatures
from ipercore_tpu_torch.ops import rasterizer as rz
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.tools import synth_data as sd
from ipercore_tpu_torch.utils.checkpoint import WEIGHTS_DIR, torch_params_to_flax

HW = (112, 96)
WEIGHTS_NAME = "faceloss.npz"
# cocoplus face joints: nose 13, ears 14 / 16, eyes 15 / 17 (neck 12); a
# slice, so that taking them copies no index to the device
FACE_J = slice(13, 18)
N_BLOBS = 8


def render_view(tex: sd.Draws, view: sd.Draws, model, assets, K: int, S: int) -> torch.Tensor:
    """One head close-up view of K identities, (K, S, S, 3) (`render_view`,
    `train_faceloss.py:82-153`): natural poses with a small yaw, the
    identity's body shape, the weak-perspective camera zoomed so the
    nose-neck distance spans 0.15 NDC around the face (with jitter), the
    identity's texture, garment and facial blob pattern (from `tex`), a
    photo-statistics background and the camera-pipeline augmentation."""
    theta = sd.make_theta(view, K, pose_std=0.15, yaw=False, natural_frac=1.0)
    yaw = view.uniform((K,), -0.4, 0.4)
    theta = theta.clone()
    theta[:, 4] = theta[:, 4] + yaw
    theta[:, 75:85] = 1.2 * tex.normal((K, 10))
    det0 = smpl_mod.get_details(model, theta)
    # the model-plane xy, undoing make_theta's camera
    raw = det0["j2d"] / theta[:, 0:1, None] - theta[:, None, 1:3]
    head_c = raw[:, FACE_J].mean(dim=1)
    head_d = torch.linalg.norm(raw[:, 13] - raw[:, 12], dim=-1)
    s = 0.15 / torch.clamp_min(head_d, 1e-3)
    jit = 0.05 * view.normal((K, 2))
    theta[:, 0] = s
    theta[:, 1:3] = -head_c + jit / s[:, None]
    details = smpl_mod.get_details(model, theta)
    fim = sd.render_fim(model, theta, S * 2, f2uvs=assets.f2uvs, details=details)
    alpha = sd._downsample2((fim >= 0).float()[..., None])
    cond = sd._downsample2(rz.encode_fim(fim, assets.map_fn))
    texture = sd.person_texture_mix(tex, cond, K, S)
    garm = sd._downsample2(sd.garment_texture(tex, fim, assets.face_parts))
    use_g = tex.bernoulli(0.5, (K, 1, 1, 1)).to(texture.dtype)
    texture = texture * (1 - use_g) + garm * use_g

    # the identity's facial pattern: blobs placed in face-local coordinates
    off = tex.uniform((K, N_BLOBS, 2), -1.0, 1.0)
    pcol = tex.uniform((K, N_BLOBS, 3), -1.0, 1.0)
    prad = tex.uniform((K, N_BLOBS), 0.06, 0.22)
    j2d = details["j2d"]
    fc = (j2d[:, FACE_J].mean(dim=1) + 1.0) * 0.5 * S  # (K, 2) pixels
    hp = torch.linalg.norm(j2d[:, 13] - j2d[:, 12], dim=-1) * 0.5 * S
    r = torch.arange(S, dtype=torch.float32, device=theta.device)
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    for m in range(N_BLOBS):
        cx = fc[:, 0] + off[:, m, 0] * hp * 1.4
        cy = fc[:, 1] + off[:, m, 1] * hp * 1.4
        r2 = (xx[None] - cx[:, None, None]) ** 2 + (yy[None] - cy[:, None, None]) ** 2
        blob = torch.exp(-r2 / torch.clamp_min((prad[:, m, None, None] * hp[:, None, None]) ** 2, 1.0))[..., None]
        blob = blob * alpha
        texture = texture * (1 - 0.8 * blob) + pcol[:, m, None, None, :] * 0.8 * blob

    bg = sd.synth_background_mix(view, K, S)
    img = texture * alpha + bg * (1 - alpha)
    return sd.photo_augment(view, img)


def head_crops(img: torch.Tensor) -> torch.Tensor:
    """(K, S, S, 3) close-ups -> (K, 112, 96, 3): the central 96:112 column
    band, resized linearly (antialiased as it shrinks)."""
    S = img.shape[1]
    crop_w = int(S * 96 / 112)
    off = (S - crop_w) // 2
    return resize_linear(img[:, :, off:off + crop_w, :], (img.shape[0], HW[0], HW[1], 3))


def make_batch(view: sd.Draws, textures: Callable[[], sd.Draws], model, assets, K: int, S: int):
    """Two views of K identities: (crops a, crops b), each (K, 112, 96, 3)."""
    return (head_crops(render_view(textures(), view, model, assets, K, S)),
            head_crops(render_view(textures(), view, model, assets, K, S)))


def embed(net: SphereFaceFeatures, crops: torch.Tensor) -> torch.Tensor:
    z = net(crops)[-1]  # fc5 (N, 512)
    return z / torch.clamp_min(torch.linalg.norm(z, dim=-1, keepdim=True), 1e-6)


def loss_fn(net: SphereFaceFeatures, batch, temp: float = 0.2):
    """Symmetric contrastive cross-entropy of the views' cosine logits / temp
    (`loss_fn`, `train_faceloss.py:178-186`): (loss, {"retrieval_acc"})."""
    a, b = batch
    za, zb = embed(net, a), embed(net, b)
    logits = za @ zb.T / temp
    labels = torch.arange(logits.shape[0], device=logits.device)
    l1 = cm.softmax_cross_entropy_with_integer_labels(logits, labels)
    l2 = cm.softmax_cross_entropy_with_integer_labels(logits.T, labels)
    acc = (logits.argmax(1) == labels).float().mean()
    return (l1.mean() + l2.mean()) * 0.5, {"retrieval_acc": acc.detach()}


def train_step(net, tx, opt_state, batch, temp: float = 0.2):
    with reference_precision():
        loss, aux = loss_fn(net, batch, temp)
        opt_state = cm.update(net, tx, opt_state, loss)
    return opt_state, loss.detach(), aux


def build(device) -> SphereFaceFeatures:
    return cm.seeded(SphereFaceFeatures(), cm.SEEDS["face"]).to(device)


def save(path: str, net: SphereFaceFeatures) -> str:
    """Every parameter, f16, in the layout `init_face_params` loads."""
    return cm.save_f16(path, torch_params_to_flax(net))


def consumer(path: str, device) -> SphereFaceFeatures:
    """The shipped file in its consumer: `init_face_params`, strictly."""
    from ipercore_tpu_torch.models.networks.criterions import init_face_params

    return init_face_params(path, device=device)[0]


def batch_draws(seed: int, device):
    """(view draws, texture-stream factory) of one batch from `seed`."""
    view = sd.Draws(torch.Generator(device=device).manual_seed(2 * seed), device)
    textures = lambda: sd.Draws(torch.Generator(device=device).manual_seed(2 * seed + 1), device)
    return view, textures


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--ids", type=int, default=12, help="identities per batch")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--scene_size", type=int, default=192)
    ap.add_argument("--temp", type=float, default=0.2)
    ap.add_argument("--out", type=str, default=os.path.join(WEIGHTS_DIR, WEIGHTS_NAME))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    args.out = cm.smoke_out(args.out, args.smoke)
    device = cm.resolve_device(args.device)
    if args.smoke:
        args.steps, args.ids, args.scene_size = 3, 3, 96
        model = smpl_mod.synthetic_model(nu=16, nv=14, device=device)
        assets = load_assets(model, device=device, synthetic=True)
    else:
        model = smpl_mod.template_model(device=device)
        assets = load_assets(model, device=device)
    K, S = args.ids, args.scene_size

    net = build(device)
    tx = cm.adam(args.lr, clip=1.0)
    opt = cm.init_state(tx, net)
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = make_batch(*batch_draws(555 + step, device), model, assets, K, S)
        opt, loss, aux = train_step(net, tx, opt, batch, args.temp)
        if step % max(args.steps // 20, 1) == 0 or step == args.steps - 1:
            cm.log({"step": step, "loss": loss, **aux}, digits=3)

    accs = []
    for i in range(4):  # retrieval on fresh identities
        batch = make_batch(*batch_draws(9000 + i, device), model, assets, K, S)
        with torch.no_grad(), reference_precision():
            accs.append(float(loss_fn(net, batch, args.temp)[1]["retrieval_acc"]))
    result = {"metric": "faceloss_holdout_retrieval", "acc": round(float(np.mean(accs)), 3),
              "chance": round(1.0 / K, 3), "steps": args.steps,
              "train_s": round(time.perf_counter() - t0, 1), "out": save(args.out, net)}
    cm.log(result)
    return result


if __name__ == "__main__":
    main()
