"""Pretrain the LWG generator on procedural multi-pose identities.

Twin of `scripts/train_lwg_pretrain.py`. One identity is a fixed SMPL shape,
a pose-consistent procedural texture (smooth per-vertex colours and a part
tint, or, for 60 % of identities in recipe v2, a garment table indexed by
face id) and one background plate; its frames are that identity under
random poses and views, rendered on the device by K1 at twice the size. The
full LWGAugBG step (`trainers/lwg_trainer.train_step`: the flow composition
with K3 twice a step, G + D, every loss, the aug-bg branch) learns to read
the appearance from the source frames and warp it to the target pose.
Checkpoints go to `--ckpt_dir` (the train service's files, so `--resume`
continues in either package); the generator ships as
`assets/lwg_pretrained_G.npz` (f16), which personalization's
`load_pretrained_generator` picks up. A held-out identity's SSIM / L1 and a
panel close the run.

`--compute_dtype bfloat16` (the default, as the JAX driver's) runs G and D
under autocast over f32 weights; `float32` is the configuration the CPU
tests hold against JAX.

    python -m ipercore_tpu_torch.scripts.train_lwg_pretrain [--steps 20000] [--batch 2] [--size 256] [--resume] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from ipercore_tpu_torch.models import flow_composition as fc
from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.models.mesh import load_assets
from ipercore_tpu_torch.models.networks import build_discriminator, build_generator
from ipercore_tpu_torch.models.networks import criterions as C
from ipercore_tpu_torch.ops import rasterizer as rz
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.tools import synth_data as sd
from ipercore_tpu_torch.trainers import lwg_trainer as T
from ipercore_tpu_torch.utils.checkpoint import (WEIGHTS_DIR, find_latest_iter, load_train_ckpt,
                                                 save_train_ckpt, torch_params_to_flax)

GEN_CFG = {
    "BGNet": {"num_filters": [64, 128, 128, 256], "n_res_block": 6},
    "SIDNet": {"num_filters": [64, 128, 256], "n_res_block": 6},
    "TSFNet": {"num_filters": [64, 128, 256], "n_res_block": 6},
}
WEIGHTS_NAME = "lwg_pretrained_G.npz"
DIS_NAME, DIS_CFG = "patch_global_body_head", {"ndf": 64, "n_layers": 4, "max_nf_mult": 8}


def _per_frame_table(fim: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """`encode_fim` of each frame with its own table (N, F + 1, 3)."""
    n = tables.shape[1]
    idx = torch.where(fim < 0, torch.full_like(fim, n - 1), fim).long()
    return tables[torch.arange(fim.shape[0], device=fim.device)[:, None, None], idx]


def make_identity_batch(draws: sd.Draws, model, assets, batch: int, size: int, ns: int = 2, nt: int = 2,
                        v2: bool = True) -> dict:
    """One training batch: `batch` identities x (ns sources + nt targets)
    frames (`make_identity_batch`, `train_lwg_pretrain.py:98-178`): images
    (B, F, S, S, 3), smpls (B, F, 85), masks (B, F, S, S, 1) background = 1,
    bg (B, S, S, 3) and aug_bg (B, S, S, 3)."""
    B, S, F = batch, size, ns + nt
    theta = sd.make_theta(draws, B * F).reshape(B, F, 85).clone()
    theta[:, :, 75:85] = theta[:, 0:1, 75:85]  # one body shape per identity
    flat = theta.reshape(B * F, 85)
    details = smpl_mod.get_details(model, flat)
    fim = sd.render_fim(model, flat, S * 2, f2uvs=assets.f2uvs, details=details)
    person = (fim >= 0)[..., None]
    alpha = sd._downsample2(person.float())
    cond = sd._downsample2(rz.encode_fim(fim, assets.map_fn))

    # a pose-consistent texture: smooth per-vertex colours averaged to faces,
    # and a per-identity part tint
    vcol = draws.uniform((B, model.v_template.shape[0], 3), -1.0, 1.0)
    fcol = vcol[:, model.faces.long()].mean(dim=2)  # (B, Fc, 3)
    fcol_pf = fcol.repeat_interleave(F, dim=0)
    frames = torch.arange(B * F, device=fim.device)[:, None, None]
    fcol_hi = torch.where(person, fcol_pf[frames, fim.clamp(min=0).long()], 0.0)
    M = draws.uniform((B, 3, 3), -1, 1).repeat_interleave(F, dim=0)
    tex = torch.tanh(0.8 * torch.einsum("bhwc,bcd->bhwd", cond, M) + 1.2 * sd._downsample2(fcol_hi))

    if v2:
        # 60 % of identities wear one garment table, indexed by face id
        tables = sd.garment_tables(draws, B, assets.face_parts).repeat_interleave(F, dim=0)
        garm = sd._downsample2(torch.where(person, _per_frame_table(fim, tables), 0.0))
        shade = 1.0 + 0.15 * sd.fractal_noise(draws, B * F, S, 1)
        ramp = 1.0 - 0.2 * sd._linspace(0, 1, S, fim.device)[None, :, None, None]
        garm = torch.clamp(garm * shade * ramp, -1, 1)
        use_garm = draws.bernoulli(0.6, (B, 1, 1, 1)).float().repeat_interleave(F, dim=0)
        tex = tex * (1 - use_garm) + garm * use_garm
        # photo-statistics or studio plates, augmented per identity
        bg = sd.synth_background_mix(draws, B, S)
        studio = sd.synth_background_studio(draws, B, S)
        use_st = draws.bernoulli(0.35, (B, 1, 1, 1)).float()
        bg = bg * (1 - use_st) + studio * use_st
        bg = sd.photo_augment(draws, bg, strength=0.6)
        aug_bg = sd.photo_augment(draws, sd.synth_background_mix(draws, B, S), strength=0.6)
    else:
        bg = sd.synth_background(draws, B, S)
        aug_bg = sd.synth_background(draws, B, S)
    img = tex * alpha + bg.repeat_interleave(F, dim=0) * (1.0 - alpha)
    img = torch.clamp(img + 0.02 * draws.normal(img.shape), -1, 1)
    masks = 1.0 - (alpha > 0.5).float()
    return {"images": img.reshape(B, F, S, S, 3), "smpls": theta, "masks": masks.reshape(B, F, S, S, 1),
            "bg": bg, "aug_bg": aug_bg}


class Rig:
    """The networks and configuration of the driver (`:180-203`): the
    composer (out_dilate_ks 51), AttLWB-SPADE at published width (seed 0),
    `patch_global_body_head` D (seed 1), VGG19 (`init_vgg_params`:
    `assets/vgg_perceptual.npz` when on disk, else seed 2), a seeded
    Sphere20a (seed 3; the JAX driver also starts it from a random init),
    aug-bg on, `remat` from 512²."""

    def __init__(self, model, assets, size: int, device, compute_dtype: str = "bfloat16", dis_cfg=None):
        self.comp = fc.make_composer(model, assets, image_size=size, out_dilate_ks=51)
        self.gen = cm.seeded(build_generator("AttLWB-SPADE", GEN_CFG, device=device), cm.SEEDS["G"])
        self.dis = cm.seeded(build_discriminator(DIS_NAME, dis_cfg or DIS_CFG, device=device), cm.SEEDS["D"])
        self.vgg = C.init_vgg_params(C.build_vgg(device=device), seed=cm.SEEDS["vgg"])
        self.face, _ = C.build_face_net("sphere20a", device=device)
        cm.seeded(self.face, cm.SEEDS["face"])
        self.cfg = T.TrainConfig(aug_bg=True, compute_dtype=compute_dtype, remat=size >= 512)

    def state(self) -> T.LWGTrainState:
        return T.create_train_state(self.gen, self.dis, self.cfg)


def train_step(rig: Rig, state: T.LWGTrainState, batch: dict, ns: int = 2):
    """One G + D step (`lwg_trainer.train_step` with the driver's networks
    and configuration): (state, metrics)."""
    return T.train_step(state, batch, rig.comp, rig.gen, rig.dis, rig.vgg, rig.face, rig.cfg, ns=ns)


def save(path: str, rig: Rig, params_G: dict) -> str:
    """The generator, f16, in the layout `build_generator`'s loader takes."""
    return cm.save_f16(path, torch_params_to_flax(rig.gen, params_G))


def consumer(path: str, device):
    """The shipped file in its consumer: `build_generator` and the
    generator loader, strictly."""
    from ipercore_tpu_torch.utils.checkpoint import load_flat_npz, load_generator_params

    gen = build_generator("AttLWB-SPADE", GEN_CFG, device=device)
    load_generator_params(gen, load_flat_npz(path))
    return gen


def holdout(rig: Rig, state: T.LWGTrainState, batch: dict, ns: int, panel: str) -> dict:
    """SSIM / L1 of the synthesized first targets against the renders, the
    validation losses, and the panel (`:229-247`)."""
    from ipercore_tpu_torch.services.evaluate import ssim
    from ipercore_tpu_torch.utils.visualizer import save_train_panel

    ev, imgs = T.eval_step(state, batch, rig.comp, rig.gen, rig.dis, rig.vgg, rig.face, rig.cfg, ns=ns,
                           return_images=True)
    gt, pred = batch["images"][:, ns], imgs["fake_tsf"].float()
    save_train_panel(panel, {k: v.float().cpu().numpy() for k, v in
                             {"src": imgs["src"], "ref": gt, "fake": pred, "fake_bg": imgs["fake_bg"]}.items()})
    return {"ssim": float(ssim(pred, gt).mean()), "l1": float((pred - gt).abs().mean()),
            "val_g_total": float(ev["val_g_total"])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--ns", type=int, default=2)
    ap.add_argument("--nt", type=int, default=2)
    ap.add_argument("--save_every", type=int, default=2000)
    ap.add_argument("--ckpt_dir", type=str, default=os.path.join(cm.REPO_DIR, ".cache", "lwg_pretrain"))
    ap.add_argument("--out", type=str, default=os.path.join(WEIGHTS_DIR, WEIGHTS_NAME))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--recipe", choices=("v1", "v2"), default="v2",
                    help="v2: garment tables for 60 %% of identities, photo-statistics / studio plates "
                         "with camera-pipeline augmentation per identity; v1: the procedural recipe")
    ap.add_argument("--compute_dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        args.steps, args.batch, args.save_every = 3, 1, 10
        args.size = min(args.size, 64)
    args.out = cm.smoke_out(args.out, args.smoke)
    device = cm.resolve_device(args.device)

    B, S, ns, nt = args.batch, args.size, args.ns, args.nt
    model = smpl_mod.template_model(device=device)
    assets = load_assets(model, device=device)
    rig = Rig(model, assets, S, device, args.compute_dtype)
    state = rig.state()
    start = 0
    if args.resume:
        it, path = find_latest_iter(args.ckpt_dir, "G")
        if path is not None:
            state = load_train_ckpt(args.ckpt_dir, it, state, rig.gen, rig.dis)
            start = it
            print(f"resumed from {args.ckpt_dir} iter {it}", flush=True)

    def batch_of(seed):
        return make_identity_batch(sd.Draws(torch.Generator(device=device).manual_seed(seed), device),
                                   model, assets, B, S, ns, nt, args.recipe == "v2")

    draws = sd.Draws(torch.Generator(device=device).manual_seed(1234 + start), device)
    t0 = time.perf_counter()
    for it in range(start, args.steps):
        batch = make_identity_batch(draws, model, assets, B, S, ns, nt, args.recipe == "v2")
        state, metrics = train_step(rig, state, batch, ns)
        if it % max(args.steps // 50, 1) == 0 or it == args.steps - 1:
            cm.log({"step": it, **metrics})
        if (it + 1) % args.save_every == 0 or it == args.steps - 1:
            save_train_ckpt(args.ckpt_dir, it + 1, state, rig.gen, rig.dis)
            save(args.out, rig, state.params_G)

    panel = os.path.join(args.ckpt_dir, "holdout_panel.png")
    result = holdout(rig, state, batch_of(9999), ns, panel)
    save(args.out, rig, state.params_G)
    result = {"metric": "lwg_pretrain_holdout", **{k: round(v, 4) for k, v in result.items()},
              "steps": args.steps, "size": S, "train_s": round(time.perf_counter() - t0, 1),
              "panel": panel, "out": args.out}
    cm.log(result)
    return result


if __name__ == "__main__":
    main()
