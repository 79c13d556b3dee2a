"""Train the VGG19-topology perceptual net on procedural SMPL renders.

Twin of `scripts/train_vgg.py`. The perceptual loss's VGG pyramid learns a
part-segmentation task on labeled scenes drawn on the device
(`tools/synth_data.py`, K1 at twice the scene size): every pixel's label is
its body part (11 SMPL parts + background) from the rendered face-index map
and `assets.face_parts`. A light multi-scale head decodes the pyramid and is
thrown away; only the pyramid ships, as `assets/vgg_perceptual.npz` (f16),
which `criterions.init_vgg_params` loads in both packages.

    python -m ipercore_tpu_torch.scripts.train_vgg [--steps 2000] [--batch 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.models.imitator import reference_precision
from ipercore_tpu_torch.models.mesh import load_assets
from ipercore_tpu_torch.models.networks.criterions import VGGFeatures
from ipercore_tpu_torch.ops import rasterizer as rz
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.tools import synth_data as sd
from ipercore_tpu_torch.utils.checkpoint import WEIGHTS_DIR, load_params, torch_params_to_flax

N_CLASSES = 12  # 11 parts + background
WEIGHTS_NAME = "vgg_perceptual.npz"
HEAD_WIDTH = 32


def make_batch(draws: sd.Draws, model, assets, batch: int, size: int):
    """Labeled scenes: image (B, S, S, 3) and per-pixel part labels (B, S, S)
    int (`make_batch`, `train_vgg.py:75-90`)."""
    theta = sd.make_theta(draws, batch)
    details = smpl_mod.get_details(model, theta)
    fim = sd.render_fim(model, theta, size * 2, f2uvs=assets.f2uvs, details=details)
    parts = assets.face_parts.long()[fim.clamp(min=0).long()]
    labels = torch.where(fim >= 0, parts, torch.full_like(parts, N_CLASSES - 1))[:, ::2, ::2]
    alpha = sd._downsample2((fim >= 0).float()[..., None])
    cond = sd._downsample2(rz.encode_fim(fim, assets.map_fn))
    bg = sd.synth_background(draws, batch, size)
    M = draws.uniform((batch, 3, 3), -1, 1)
    tex = torch.tanh(torch.einsum("bhwc,bcd->bhwd", cond, M)
                     + 0.15 * draws.normal((batch, size, size, 3)))
    img = tex * alpha + bg * (1.0 - alpha)
    img = torch.clamp(img + 0.05 * draws.normal(img.shape), -1, 1)
    return img, labels


class SegVGG(nn.Module):
    """`VGGFeatures` and a light multi-scale decode head at S/4: a 1x1
    convolution to 32 channels per slice, each resized linearly to S/4
    (`jax.image.resize`, antialiased where it shrinks), summed, ReLU, a 1x1
    convolution to the classes (`SegVGG`, `train_vgg.py:92-106`)."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size
        self.VGGFeatures_0 = VGGFeatures()
        for i, widths in enumerate(self.VGGFeatures_0.slices):
            self.add_module(f"head_lat{i}", nn.Conv2d(widths[-1], HEAD_WIDTH, 1))
        self.head_out = nn.Conv2d(HEAD_WIDTH, N_CLASSES, 1)

    def forward(self, x):
        h = self.size // 4
        ups = 0.0
        for i, f in enumerate(self.VGGFeatures_0(x)):
            f = getattr(self, f"head_lat{i}")(f).permute(0, 2, 3, 1)
            ups = ups + resize_linear(f, (f.shape[0], h, h, HEAD_WIDTH))
        y = F.relu(ups)
        return self.head_out(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # (B, S/4, S/4, C)


def loss_fn(net: SegVGG, batch):
    """Part cross-entropy at S/4, background pixels weighted 0.3 (`loss_fn`,
    `train_vgg.py:123-132`): (loss, {"pix_acc"})."""
    img, labels = batch
    logits = net(img)
    lab4 = labels[:, ::4, ::4]
    ce = cm.softmax_cross_entropy_with_integer_labels(logits, lab4)
    w = torch.where(lab4 == N_CLASSES - 1, 0.3, 1.0)
    acc = (logits.argmax(-1) == lab4).float().mean()
    return (ce * w).mean(), {"pix_acc": acc.detach()}


def train_step(net: SegVGG, tx, opt_state, batch):
    """One Adam step on one batch: (opt_state, loss, aux)."""
    with reference_precision():
        loss, aux = loss_fn(net, batch)
        opt_state = cm.update(net, tx, opt_state, loss)
    return opt_state, loss.detach(), aux


def build(size: int, device, resume: str | None = None) -> SegVGG:
    """The net with seeded weights (`SEEDS["vgg"]`); the pyramid from
    `resume` when given."""
    net = cm.seeded(SegVGG(size), cm.SEEDS["vgg"]).to(device)
    if resume:
        net.VGGFeatures_0.load_state_dict(load_params(resume, net.VGGFeatures_0), strict=True)
        print(f"resumed pyramid from {resume}", flush=True)
    return net


def save(path: str, net: SegVGG) -> str:
    """The pyramid alone, f16, in the layout `init_vgg_params` loads."""
    return cm.save_f16(path, torch_params_to_flax(net.VGGFeatures_0))


def consumer(path: str, device):
    """The shipped file in its consumer: `init_vgg_params`, strictly."""
    from ipercore_tpu_torch.models.networks.criterions import build_vgg, init_vgg_params

    return init_vgg_params(build_vgg(device=device), weights_path=path)


def holdout(net: SegVGG, batch) -> dict:
    """mIoU over the classes present and person-pixel accuracy at S/4."""
    img, labels = batch
    with torch.no_grad(), reference_precision():
        pred = net(img).argmax(-1).cpu().numpy()
    lab = labels[:, ::4, ::4].cpu().numpy()
    ious = []
    for c in range(N_CLASSES):
        union = ((pred == c) | (lab == c)).sum()
        if union > 0:
            ious.append(((pred == c) & (lab == c)).sum() / union)
    person = lab != N_CLASSES - 1
    pacc = float((pred[person] == lab[person]).mean()) if person.any() else 0.0
    return {"miou": float(np.mean(ious)), "person_pix_acc": pacc}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", type=str, default=os.path.join(WEIGHTS_DIR, WEIGHTS_NAME))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    args.out = cm.smoke_out(args.out, args.smoke)
    if args.smoke:
        args.steps, args.batch = 4, 2
    device = cm.resolve_device(args.device)

    model = smpl_mod.template_model(device=device)
    assets = load_assets(model, device=device)
    B, S = args.batch, args.size
    net = build(S, device, args.out if args.resume and os.path.exists(args.out) else None)
    tx = cm.adam(args.lr)
    opt = cm.init_state(tx, net)

    t0 = time.time()
    draws = sd.Draws(torch.Generator(device=device).manual_seed(42), device)
    for i in range(args.steps):
        opt, loss, aux = train_step(net, tx, opt, make_batch(draws, model, assets, B, S))
        if i % max(args.steps // 20, 1) == 0 or i == args.steps - 1:
            cm.log({"step": i, "loss": loss, **aux})

    hold = make_batch(sd.Draws(torch.Generator(device=device).manual_seed(777), device),
                      model, assets, B, S)
    result = {"metric": "vgg_part_seg_holdout", **holdout(net, hold), "steps": args.steps,
              "train_s": round(time.time() - t0, 1), "out": save(args.out, net)}
    cm.log(result)
    return result


if __name__ == "__main__":
    main()
