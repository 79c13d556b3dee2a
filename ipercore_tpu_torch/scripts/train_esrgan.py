"""Train the RRDBNet 4x super-resolution net on procedural scenes.

Twin of `scripts/train_esrgan.py`. The high-resolution image is a composited
SMPL scene (`synth_data.compose_scene`, K1 at twice the patch size) or, for
three in ten, a background plate, in [0, 1]; the low-resolution input is its
4x box-down. L1 loss on `RRDBNet` (23 RRDB blocks, PSNR-oriented). `--pool N`
renders N scenes once and flips, rolls and recolours them per step; 0 (the
default) draws fresh scenes every step. The hold-out reports the PSNR of the
net and of a bilinear upsample (`jax.image.resize`'s, `data.datasets.
resize_linear`) against the high-resolution image. Ships `assets/esrgan.npz`
(f16), which `tools.inpaintors.SuperResolutionInpaintor` loads in both
packages.

    python -m ipercore_tpu_torch.scripts.train_esrgan [--steps 1500] [--batch 4] [--size 192] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.models.imitator import reference_precision
from ipercore_tpu_torch.models.mesh import load_assets
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.tools import synth_data as sd
from ipercore_tpu_torch.tools.inpaintors import RRDBNet, SuperResolutionInpaintor
from ipercore_tpu_torch.utils.checkpoint import WEIGHTS_DIR, load_flat_npz, load_params, torch_params_to_flax

WEIGHTS_NAME = "esrgan.npz"


def render_scenes(draws: sd.Draws, model, assets, batch: int, size: int) -> torch.Tensor:
    """`compose_scene(...).img` (B, S, S, 3) in [-1, 1] (`render_scenes`, `:77`)."""
    return sd.compose_scene(draws, model, assets, batch, size).img


def pooled_scenes(draws: sd.Draws, scene_pool: torch.Tensor, batch: int, size: int) -> torch.Tensor:
    """Pool items flipped, rolled and recoloured (`get_scenes`, `:94-103`)."""
    B, S = batch, size
    img = scene_pool[draws.randint((B,), 0, scene_pool.shape[0])]
    flip = draws.bernoulli(0.5, (B, 1, 1, 1))
    img = torch.where(flip, img.flip(2), img)
    img = cm.roll_each(img, draws.randint((B, 2), -S // 6, S // 6 + 1))
    gain = draws.uniform((B, 1, 1, 3), 0.7, 1.3)
    bias = draws.uniform((B, 1, 1, 3), -0.15, 0.15)
    return torch.clamp(img * gain + bias, -1, 1)


def make_batch(draws: sd.Draws, get_scenes, batch: int, size: int):
    """(hr (B, S, S, 3) in [0, 1], lr (B, S/4, S/4, 3)) (`make_batch`, `:107-115`);
    `get_scenes(draws)` gives the scene images."""
    scenes = get_scenes(draws)
    plates = sd.synth_background(draws, batch, size)
    use_scene = draws.bernoulli(0.7, (batch, 1, 1, 1))
    hr = torch.where(use_scene, scenes, plates) * 0.5 + 0.5
    return hr, cm.box_down4(hr)


def loss_fn(net: RRDBNet, batch):
    hr, lr = batch
    return torch.mean(torch.abs(net(lr) - hr)), {}


def train_step(net: RRDBNet, tx, opt_state, batch):
    with reference_precision():
        loss, aux = loss_fn(net, batch)
        opt_state = cm.update(net, tx, opt_state, loss)
    return opt_state, loss.detach(), aux


def build(device, resume: str | None = None) -> RRDBNet:
    net = cm.seeded(RRDBNet(), cm.SEEDS["esrgan"])
    if resume:
        net.load_state_dict(load_params(resume, net), strict=True)
        print(f"resumed from {resume}", flush=True)
    return net.to(device)


def save(path: str, net: RRDBNet) -> str:
    return cm.save_f16(path, torch_params_to_flax(net))


def consumer(path: str, device) -> SuperResolutionInpaintor:
    """The shipped file in its consumer: the inpaintor's SR stage, strictly."""
    flat = {k: v.astype("float32") for k, v in load_flat_npz(path).items()}
    inp = SuperResolutionInpaintor(sr_params=flat, device=device)
    assert inp.sr_trained, path
    return inp


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(-10 * torch.log10(torch.mean((a - b) ** 2) + 1e-12))


def holdout(net: RRDBNet, batch) -> dict:
    """PSNR of the net and of the bilinear upsample against HR (`:157-170`)."""
    hr, lr = batch
    with torch.no_grad(), reference_precision():
        out = torch.clamp(net(lr), 0, 1)
    bil = resize_linear(lr, tuple(hr.shape))
    return {"psnr": round(psnr(out, hr), 2), "psnr_bilinear": round(psnr(bil, hr), 2)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--size", type=int, default=192, help="HR patch size")
    ap.add_argument("--out", type=str, default=os.path.join(WEIGHTS_DIR, WEIGHTS_NAME))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--pool", type=int, default=0,
                    help="pre-render this many HR scenes once and augment per step (flip / shift / "
                         "colour) instead of rendering every step; 0 = fresh scenes")
    ap.add_argument("--save_every", type=int, default=200, help="checkpoint cadence in steps (0 = only at the end)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    args.out = cm.smoke_out(args.out, args.smoke)
    device = cm.resolve_device(args.device)
    if args.smoke:
        args.steps, args.batch, args.size = 4, 1, 64
        model = smpl_mod.synthetic_model(nu=16, nv=14, device=device)
        assets = load_assets(model, device=device, synthetic=True)
    else:
        model = smpl_mod.template_model(device=device)
        assets = load_assets(model, device=device)
    B, S = args.batch, args.size
    draws = lambda seed: sd.Draws(torch.Generator(device=device).manual_seed(seed), device)

    if args.pool:
        scene_pool = cm.pool_chunks(lambda d: render_scenes(d, model, assets, B, S), draws(909), args.pool, B)
        print(f"scene pool ready: {tuple(scene_pool.shape)}", flush=True)
        get_scenes = lambda d: pooled_scenes(d, scene_pool, B, S)
    else:
        get_scenes = lambda d: render_scenes(d, model, assets, B, S)

    net = build(device, args.out if args.resume and os.path.exists(args.out) else None)
    tx = cm.adam(args.lr, clip=1.0)
    opt = cm.init_state(tx, net)
    d = draws(77)
    t0 = time.perf_counter()
    for step in range(args.steps):
        opt, loss, _ = train_step(net, tx, opt, make_batch(d, get_scenes, B, S))
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            cm.log({"step": step, "l1": loss}, digits=5)
        if args.save_every and step and step % args.save_every == 0:
            save(args.out, net)

    result = {"metric": "esrgan_synthetic_holdout", **holdout(net, make_batch(draws(31337), get_scenes, B, S)),
              "steps": args.steps, "train_s": round(time.perf_counter() - t0, 1)}
    save(args.out, net)
    result["out"] = args.out
    cm.log(result)
    return result


if __name__ == "__main__":
    main()
