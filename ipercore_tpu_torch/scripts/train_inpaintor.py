"""Train the gated-conv background inpaintor on procedural scenes.

Twin of `scripts/train_inpaintor.py`. Procedural background plates
(`synth_data.synth_background`) get person-shaped holes: half are dilated SMPL
silhouettes from a pool rendered once by K1 (`synth_data.render_fim`, then
`dilate(15)`), flipped and rolled per batch; half are random rectangles and
ellipses (`random_holes`). The loss is L1 inside the hole, half an L1
outside it and a tenth of a total-variation term.

  * `--stage 1` trains `GatedInpaintor` (`assets/inpaintor.npz`);
  * `--stage 2` trains `RefineInpaintor` on the frozen stage-1 output
    (`assets/inpaintor_refine.npz`), read from `--stage1` (default
    `assets/inpaintor.npz`, the JAX driver's fixed path). Its contextual
    attention takes the fused route on a CUDA tensor (one memory-efficient
    `scaled_dot_product_attention`, whose backward this step runs) and the
    plain two-product route on the CPU.

The stage-2 hold-out compares the masked PSNR of the diffusion fill, stage 1
and stage 2. Both files load in `tools.inpaintors.SuperResolutionInpaintor`
in both packages.

    python -m ipercore_tpu_torch.scripts.train_inpaintor [--stage 1] [--steps 2000] [--batch 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.models.imitator import reference_precision
from ipercore_tpu_torch.models.mesh import load_assets
from ipercore_tpu_torch.ops.morphology import dilate
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.tools import synth_data as sd
from ipercore_tpu_torch.tools.inpaintors import (GatedInpaintor, RefineInpaintor, SuperResolutionInpaintor,
                                                 diffusion_fill)
from ipercore_tpu_torch.utils.checkpoint import WEIGHTS_DIR, load_flat_npz, load_params, torch_params_to_flax

WEIGHTS_NAME = "inpaintor.npz"
REFINE_WEIGHTS_NAME = "inpaintor_refine.npz"


def render_sil_chunk(draws: sd.Draws, model, assets, batch: int, size: int) -> torch.Tensor:
    """`batch` random bodies -> dilated silhouettes (B, S, S, 1)
    (`render_sil_chunk`, `:85`): K1 at the control size."""
    fim = sd.render_fim(model, sd.make_theta(draws, batch), size, f2uvs=assets.f2uvs)
    return dilate((fim >= 0).float()[..., None], 15)


def render_pool(draws: sd.Draws, model, assets, pool: int, batch: int, size: int) -> torch.Tensor:
    return cm.pool_chunks(lambda d: render_sil_chunk(d, model, assets, batch, size), draws, pool, batch)


def make_batch(draws: sd.Draws, sil_pool: torch.Tensor, batch: int, size: int):
    """(bg (B, S, S, 3), hole (B, S, S, 1)) (`make_batch`, `:100-114`)."""
    B, S = batch, size
    bg = sd.synth_background(draws, B, S)
    sil = sil_pool[draws.randint((B,), 0, sil_pool.shape[0])]
    flip = draws.bernoulli(0.5, (B, 1, 1, 1))
    sil = torch.where(flip, sil.flip(2), sil)
    sil = cm.roll_each(sil, draws.randint((B, 2), -S // 8, S // 8 + 1))
    rand = sd.random_holes(draws, B, S)
    use_sil = draws.bernoulli(0.5, (B, 1, 1, 1))
    return bg, torch.where(use_sil, sil, rand)


class Nets(torch.nn.Module):
    """The trained network and, in stage 2, the frozen stage-1 net."""

    def __init__(self, stage: int = 1):
        super().__init__()
        self.stage = stage
        self.net = GatedInpaintor() if stage == 1 else RefineInpaintor()
        self.coarse = GatedInpaintor().requires_grad_(False) if stage == 2 else None


def coarse_out(coarse: GatedInpaintor, bg: torch.Tensor, hole: torch.Tensor) -> torch.Tensor:
    """The stage-1 fill composited into the known pixels (`coarse_out`)."""
    out = coarse(torch.cat([bg * (1 - hole), hole], dim=-1))
    return bg * (1 - hole) + out * hole


def predict(nets: Nets, bg: torch.Tensor, hole: torch.Tensor) -> torch.Tensor:
    """The trained net's output on a batch (stage 2: on the frozen coarse fill)."""
    if nets.stage == 2:
        with torch.no_grad():
            c = coarse_out(nets.coarse, bg, hole)
        return nets.net(torch.cat([c, hole], dim=-1), hole)
    return nets.net(torch.cat([bg * (1 - hole), hole], dim=-1))


def loss_fn(nets: Nets, batch):
    """l1_hole + 0.5 l1_keep + 0.1 tv, {l1_hole, l1_keep} (`loss_fn`, `:131-141`)."""
    bg, hole = batch
    out = predict(nets, bg, hole)
    l1_hole = torch.sum(torch.abs(out - bg) * hole) / torch.clamp_min(hole.sum() * 3, 1.0)
    l1_keep = torch.mean(torch.abs(out - bg) * (1 - hole))
    tv = (torch.mean(torch.abs(out[:, 1:] - out[:, :-1])) + torch.mean(torch.abs(out[:, :, 1:] - out[:, :, :-1])))
    return l1_hole + 0.5 * l1_keep + 0.1 * tv, {"l1_hole": l1_hole.detach(), "l1_keep": l1_keep.detach()}


def train_step(nets: Nets, tx, opt_state, batch):
    with reference_precision():
        loss, aux = loss_fn(nets, batch)
        opt_state = cm.update(nets.net, tx, opt_state, loss)
    return opt_state, loss.detach(), aux


def build(device, stage: int = 1, stage1: str | None = None, resume: str | None = None) -> Nets:
    """Seeded nets (10 for stage 1, 11 for the refinement); stage 2 loads the
    frozen stage-1 weights from `stage1` (f16 on disk -> f32), strictly."""
    nets = Nets(stage)
    cm.seeded(nets.net, cm.SEEDS["inpaintor" if stage == 1 else "inpaintor_refine"])
    if stage == 2:
        if not stage1 or not os.path.exists(stage1):
            raise FileNotFoundError(f"train stage 1 first ({stage1} missing)")
        nets.coarse.load_state_dict(load_params(stage1, nets.coarse), strict=True)
    if resume:
        nets.net.load_state_dict(load_params(resume, nets.net), strict=True)
        print(f"resumed from {resume}", flush=True)
    return nets.to(device)


def save(path: str, nets: Nets) -> str:
    return cm.save_f16(path, torch_params_to_flax(nets.net))


def consumer(path: str, device, stage: int = 1, stage1: str | None = None) -> SuperResolutionInpaintor:
    """The shipped file in its consumer, strictly: stage 1 as the gated net,
    stage 2 as the refinement beside its stage-1 file."""
    if stage == 1:
        inp = SuperResolutionInpaintor(weights_path=path, refine_weights_path=path + ".none", device=device)
        assert inp.trained and not inp.refine_trained, path
    else:
        flat = lambda p: {k: v.astype("float32") for k, v in load_flat_npz(p).items()}
        inp = SuperResolutionInpaintor(inpaint_params=flat(stage1), refine_params=flat(path), device=device)
        assert inp.trained and inp.refine_trained, path
    return inp


def masked_psnr(out: torch.Tensor, bg: torch.Tensor, hole: torch.Tensor) -> float:
    """PSNR inside the hole, images in [-1, 1] (range 2: peak 4)."""
    mse = torch.sum(((out - bg) * hole) ** 2) / torch.clamp_min(hole.sum() * 3, 1.0)
    return float(10 * torch.log10(4.0 / torch.clamp_min(mse, 1e-10)))


def holdout(nets: Nets, batch) -> dict:
    """The hold-out hole L1; in stage 2 also the masked PSNR of the diffusion
    fill, stage 1 and stage 2 (`:175-210`)."""
    bg, hole = batch
    with torch.no_grad(), reference_precision():
        _, aux = loss_fn(nets, batch)
        out = {"hole_l1": round(float(aux["l1_hole"]), 4)}
        if nets.stage == 2:
            c = coarse_out(nets.coarse, bg, hole)
            r = nets.net(torch.cat([c, hole], dim=-1), hole)
            r = bg * (1 - hole) + r * hole
            d = diffusion_fill(bg * (1 - hole), hole)
            out.update(psnr_diffusion=round(masked_psnr(d, bg, hole), 2),
                       psnr_stage1=round(masked_psnr(c, bg, hole), 2),
                       psnr_stage2=round(masked_psnr(r, bg, hole), 2))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--size", type=int, default=256, help="control size")
    ap.add_argument("--out", type=str, default=os.path.join(WEIGHTS_DIR, WEIGHTS_NAME))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--pool", type=int, default=64,
                    help="pre-rendered SMPL silhouette pool size (rendered once, augmented per step)")
    ap.add_argument("--save_every", type=int, default=200, help="checkpoint cadence in steps (0 = only at the end)")
    ap.add_argument("--stage", type=int, default=1, choices=(1, 2),
                    help="1 = coarse gated net; 2 = contextual-attention refinement (`RefineInpaintor`) "
                         "on the frozen stage-1 output")
    ap.add_argument("--stage1", type=str, default=os.path.join(WEIGHTS_DIR, WEIGHTS_NAME),
                    help="the frozen stage-1 weights of --stage 2")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = cm.resolve_device(args.device)
    if args.smoke:
        args.steps, args.batch, args.size = 4, 2, 64
        model = smpl_mod.synthetic_model(nu=16, nv=14, device=device)
        assets = load_assets(model, device=device, synthetic=True)
    else:
        model = smpl_mod.template_model(device=device)
        assets = load_assets(model, device=device)
    if args.stage == 2 and os.path.basename(args.out) == WEIGHTS_NAME:  # stage 2's default file
        args.out = os.path.join(os.path.dirname(args.out), REFINE_WEIGHTS_NAME)
    args.out = cm.smoke_out(args.out, args.smoke)
    B, S = args.batch, args.size
    draws = lambda seed: sd.Draws(torch.Generator(device=device).manual_seed(seed), device)

    sil_pool = render_pool(draws(101), model, assets, args.pool, B, S)
    print(f"silhouette pool ready: {tuple(sil_pool.shape)}", flush=True)
    nets = build(device, args.stage, args.stage1, args.out if args.resume and os.path.exists(args.out) else None)
    tx = cm.adam(args.lr, clip=1.0)
    opt = cm.init_state(tx, nets.net)

    d = draws(55)
    t0 = time.perf_counter()
    for step in range(args.steps):
        opt, loss, aux = train_step(nets, tx, opt, make_batch(d, sil_pool, B, S))
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            cm.log({"step": step, "loss": loss, **aux})
        if args.save_every and step and step % args.save_every == 0:
            save(args.out, nets)

    result = {"metric": "inpaintor_synthetic_holdout", "stage": args.stage}
    hold = holdout(nets, make_batch(draws(777), sil_pool, B, S))
    result.update(hole_l1=hold.pop("hole_l1"), steps=args.steps, train_s=round(time.perf_counter() - t0, 1), **hold)
    save(args.out, nets)
    result["out"] = args.out
    cm.log(result)
    return result


if __name__ == "__main__":
    main()
