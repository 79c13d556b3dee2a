"""Train the SCHP human / cloth parser on procedural clothed-SMPL renders.

Twin of `scripts/train_schp.py`. A pool of SMPL part maps is rendered once by
K1 (`synth_data.render_fim`: `rasterizer_cuda.raster_flows` on the card, its
plain version on a CPU tensor); every batch then flips (swapping the left /
right part ids) and rolls pool items, maps the parts to LIP classes with
per-identity clothing coin flips (pants, coat sleeves), paints a skirt or
dress panel from the hip line to a random hem on half the identities, and
colours each class from a random palette over a procedural plate with
shading and noise. SchpNet (ResNet-101) is trained with softmax
cross-entropy at the scene size; the hold-out reports the mIoU and the
skirt-detection rate. Ships `assets/schp.npz` (f16), which
`tools.parsers.build_parser` loads in both packages.

    python -m ipercore_tpu_torch.scripts.train_schp [--steps 2000] [--batch 4] [--size 256] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.models.imitator import reference_precision
from ipercore_tpu_torch.models.mesh import load_assets
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.tools import synth_data as sd
from ipercore_tpu_torch.tools.parsers import LIP_NUM_CLASSES, SchpNet, SchpParser, _resize_ac, build_parser
from ipercore_tpu_torch.utils.checkpoint import WEIGHTS_DIR, load_params, torch_params_to_flax

WEIGHTS_NAME = "schp.npz"
# the 11-part scheme (mesh.PART_IDS order: head, torso, L-leg, R-leg, L-arm,
# R-arm, L-foot, R-foot, L-hand, R-hand, facial; 11 = background) -> LIP class
PART_TO_LIP = (2, 5, 16, 17, 14, 15, 18, 19, 14, 15, 13, 0)
# the left / right pairs swapped by a horizontal flip: legs, arms, feet, hands
FLIP_PARTS = (0, 1, 3, 2, 5, 4, 7, 6, 9, 8, 10, 11)
BACKGROUND_PART = 11


def render_pmap_chunk(draws: sd.Draws, model, assets, batch: int, size: int) -> torch.Tensor:
    """`batch` random bodies -> part maps (B, S, S) int64, 11 off the body
    (`render_pmap_chunk`, `:105`): K1 at the scene size."""
    theta = sd.make_theta(draws, batch)
    fim = sd.render_fim(model, theta, size, f2uvs=assets.f2uvs)
    return torch.where(fim >= 0, assets.face_parts[torch.clamp_min(fim, 0)].long(), BACKGROUND_PART)


def render_pool(draws: sd.Draws, model, assets, pool: int, batch: int, size: int) -> torch.Tensor:
    """The part-map pool (max(pool, batch), S, S), rendered in chunks of `batch`."""
    return cm.pool_chunks(lambda d: render_pmap_chunk(d, model, assets, batch, size), draws, pool, batch)


def make_batch(draws: sd.Draws, pmap_pool: torch.Tensor, batch: int, size: int):
    """(img (B, S, S, 3), label (B, S, S) int64, skirted (B,) bool): the
    procedural clothed scenes and their exact LIP labels (`make_batch`,
    `:122-187`), drawing in the JAX driver's order."""
    B, S, dev = batch, size, pmap_pool.device
    lut = torch.tensor(PART_TO_LIP).to(dev, non_blocking=True)  # copies, no host sync
    flip_lut = torch.tensor(FLIP_PARTS).to(dev, non_blocking=True)
    pmap = pmap_pool[draws.randint((B,), 0, pmap_pool.shape[0])]
    flip = draws.bernoulli(0.5, (B, 1, 1))
    pmap = torch.where(flip, flip_lut[pmap.flip(2)], pmap)
    pmap = cm.roll_each(pmap, draws.randint((B, 2), -S // 8, S // 8 + 1))
    label = lut[pmap]
    fg = pmap < BACKGROUND_PART
    legs = (pmap == 2) | (pmap == 3)
    arms = (pmap == 4) | (pmap == 5) | (pmap == 8) | (pmap == 9)
    torso = pmap == 1

    # per-identity clothing coin flips
    pants = draws.bernoulli(0.5, (B, 1, 1))
    coat = draws.bernoulli(0.4, (B, 1, 1))
    skirted = draws.bernoulli(0.5, (B, 1, 1))
    is_dress = draws.bernoulli(0.4, (B, 1, 1))
    label = torch.where(pants & legs, 9, label)  # Pants
    label = torch.where(coat & arms, 7, label)  # Coat sleeves

    # the skirt / dress panel: rows from the hip line to a random hem, over
    # each row's column extent of legs + torso (the gap between the legs too)
    rows = torch.arange(S, device=dev)[None, :, None]
    cols = torch.arange(S, device=dev)[None, None, :]
    body = legs | torso
    hip_y = torch.where(legs, rows, S).amin(dim=(1, 2), keepdim=True)
    ank_y = torch.where(legs, rows, -1).amax(dim=(1, 2), keepdim=True)
    u = draws.uniform((B, 1, 1), 0.3, 0.75)
    hem_y = hip_y + u * torch.clamp_min(ank_y - hip_y, 0)
    band = (rows >= hip_y) & (rows <= hem_y)
    rminc = torch.where(body, cols, S).amin(dim=2, keepdim=True)
    rmaxc = torch.where(body, cols, -1).amax(dim=2, keepdim=True)
    panel = (band & (rmaxc >= 0) & (cols >= rminc - 2) & (cols <= rmaxc + 2) & skirted & (ank_y > hip_y))
    label = torch.where(panel, torch.where(is_dress, 6, 12), label)  # Dress vs Skirt
    label = torch.where(is_dress & skirted & torso, 6, label)  # the dress bodice
    fg = fg | panel

    # one random colour per (identity, LIP class), shaded and noised, over a plate
    palette = draws.uniform((B, LIP_NUM_CLASSES, 3), -1.0, 1.0)
    img = palette[torch.arange(B, device=dev)[:, None, None], label]
    bg = sd.synth_background(draws, B, S)
    img = torch.where(fg[..., None], img, bg)
    gx = draws.uniform((B, 1, 1, 1), -0.3, 0.3)
    gy = draws.uniform((B, 1, 1, 1), -0.3, 0.3)
    shade = 1.0 + gx * (cols[..., None] / S - 0.5) + gy * (rows[..., None] / S - 0.5)
    img = torch.clamp(img * shade + 0.03 * draws.normal(img.shape), -1, 1)
    return img, label, skirted[:, 0, 0]


def forward(net: SchpNet, img: torch.Tensor) -> torch.Tensor:
    """Logits at the input's size: `SchpParser`'s normalisation, the net,
    the align-corners resize (`forward`, `:196-200`; `resize_bilinear_ac`
    through the net's own cached matrices, which copies nothing to the card
    after the first step)."""
    mean = torch.tensor(SchpParser.MEAN).to(img.device, non_blocking=True)
    std = torch.tensor(SchpParser.STD).to(img.device, non_blocking=True)
    logits = net(((img + 1.0) * 0.5 - mean) / std)
    return _resize_ac(logits.permute(0, 3, 1, 2), img.shape[1], img.shape[2], net.mats).permute(0, 2, 3, 1)


def loss_fn(net: SchpNet, batch):
    """(mean softmax cross-entropy, {pix_acc}) (`loss_fn`, `:202-207`); the
    one-hot labels by comparison (`F.one_hot` checks its range with a host
    sync on the card)."""
    img, label = batch[0], batch[1]
    logits = forward(net, img)
    onehot = (label[..., None] == torch.arange(LIP_NUM_CLASSES, device=label.device)).to(logits.dtype)
    ce = cm.softmax_cross_entropy(logits, onehot).mean()
    acc = (logits.argmax(-1) == label).float().mean()
    return ce, {"pix_acc": acc.detach()}


def train_step(net: SchpNet, tx, opt_state, batch):
    with reference_precision():
        loss, aux = loss_fn(net, batch)
        opt_state = cm.update(net, tx, opt_state, loss)
    return opt_state, loss.detach(), aux


def build(device, resume: str | None = None) -> SchpNet:
    net = cm.seeded(SchpNet(), cm.SEEDS["schp"])
    if resume:
        net.load_state_dict(load_params(resume, net), strict=True)
        print(f"resumed from {resume}", flush=True)
    return net.to(device)


def save(path: str, net: SchpNet) -> str:
    return cm.save_f16(path, torch_params_to_flax(net))


def consumer(path: str, device):
    """The shipped file in its consumer: `build_parser`, strictly."""
    parser = build_parser(path, device=device)
    assert parser is not None and parser.trained, path
    return parser


def holdout(net: SchpNet, batch) -> dict:
    """mIoU over the classes present, and the skirt-detection rate: a frame
    counts as skirted when >= 100 pixels are predicted skirt or dress
    (`:231-245`)."""
    img, label, skirted = batch
    with torch.no_grad(), reference_precision():
        pred = forward(net, img).argmax(-1)
    ious = []
    for c in range(LIP_NUM_CLASSES):
        inter = float(((pred == c) & (label == c)).sum())
        union = float(((pred == c) | (label == c)).sum())
        if union > 0:
            ious.append(inter / union)
    skirt_px = ((pred == 12) | (pred == 6)).sum(dim=(1, 2)).cpu().numpy()
    hit = (skirt_px >= 100) == skirted.cpu().numpy()
    return {"miou": round(float(np.mean(ious)), 4), "skirt_detect_acc": round(float(hit.mean()), 4)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", type=str, default=os.path.join(WEIGHTS_DIR, WEIGHTS_NAME))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--pool", type=int, default=48,
                    help="pre-rendered part-map pool size (clothing flips, palette, background and "
                         "shading stay fresh per step)")
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

    pmap_pool = render_pool(draws(606), model, assets, args.pool, B, S)
    print(f"part-map pool ready: {tuple(pmap_pool.shape)}", flush=True)
    net = build(device, args.out if args.resume and os.path.exists(args.out) else None)
    tx = cm.adam(args.lr, clip=1.0)
    opt = cm.init_state(tx, net)

    d = draws(404)
    t0 = time.perf_counter()
    for step in range(args.steps):
        opt, loss, aux = train_step(net, tx, opt, make_batch(d, pmap_pool, B, S))
        if step % max(args.steps // 20, 1) == 0 or step == args.steps - 1:
            cm.log({"step": step, "ce": loss, "pix_acc": aux["pix_acc"]})
        if args.save_every and step and step % args.save_every == 0:
            save(args.out, net)

    result = {"metric": "schp_synthetic_holdout", **holdout(net, make_batch(draws(5150), pmap_pool, B, S)),
              "steps": args.steps, "train_s": round(time.perf_counter() - t0, 1)}
    save(args.out, net)
    result["out"] = args.out
    cm.log(result)
    return result


if __name__ == "__main__":
    main()
