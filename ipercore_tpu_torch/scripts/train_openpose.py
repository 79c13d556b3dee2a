"""Train the Body-25 OpenPose net (or the Mobilenet COCO-18 variant) on
procedural SMPL renders.

Twin of `scripts/train_openpose.py`. Scenes drawn on the device
(`tools/synth_data.compose_scene`, K1 at twice the scene size) are resized
to the net's input (linear, antialiased) and their projected joints give
exact heatmap and PAF targets (`make_pose2d_targets`) for the nineteen
joints the decode uses; every refinement stage is supervised. `--pool`
renders a scene pool once and augments it per step; `--pseudo` mixes
pseudo-labeled real crops into every batch. Checkpoints are chosen by PCK@0.1
(with the flip test-time augmentation) on the annotated real select images
where they exist. Ships `assets/openpose.npz` (f16, with the training input
size in `__meta__/input_size`), which `tools.pose2d.OpenPoseRunner` loads in
both packages.

    python -m ipercore_tpu_torch.scripts.train_openpose [--steps 3000] [--batch 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.models.imitator import reference_precision
from ipercore_tpu_torch.models.mesh import load_assets
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.scripts import eval_real_photos as real
from ipercore_tpu_torch.tools import synth_data as sd
from ipercore_tpu_torch.tools.pose2d import (BODY25_FLIP_JOINTS, OpenPoseBody25, OpenPoseRunner,
                                             decode_single_person)
from ipercore_tpu_torch.utils.checkpoint import META_PREFIX, WEIGHTS_DIR, load_params, torch_params_to_flax

WEIGHTS_NAME = "openpose.npz"
# Body-25 joint -> COCO-18 joint, where one exists (the Mobilenet probe)
B25_TO_C18 = {0: 0, 1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 7, 9: 8, 10: 9, 11: 10, 12: 11, 13: 12, 14: 13}


class Recipe(NamedTuple):
    """The driver's batch settings (its flags): scene and input sizes, the
    scene mix, motion blur, the pool and the Mobilenet variant."""

    scene_size: int = 256
    input_size: int = 224
    studio_frac: float = 0.35
    garment_frac: float = 0.5
    natural_frac: float = 0.65
    motion_blur: float = 0.5
    pool: int = 0
    mobile: bool = False

    @property
    def hm_size(self) -> int:
        return self.input_size // 8


def render_scene(draws: sd.Draws, model, assets, batch: int, r: Recipe):
    """(x (B, IN, IN, 3) in [-1, 1], j2d (B, 19, 2)) (`render_scene`, `:133`)."""
    sb = sd.compose_scene(draws, model, assets, batch=batch, size=r.scene_size, studio_frac=r.studio_frac,
                          garment_frac=r.garment_frac, natural_frac=r.natural_frac)
    return resize_linear(sb.img, (batch, r.input_size, r.input_size, 3)), sb.j2d


def finish_batch(draws: sd.Draws, x: torch.Tensor, j2d: torch.Tensor, r: Recipe):
    """Motion blur, the pool's augmentation (a joint-consistent shift, gain,
    bias, noise), the runner's input scaling and the targets: (x, hm_t,
    paf_t, hm_w, paf_w, j2d) (`finish_batch`, `:142-170`)."""
    nb, IN = x.shape[0], r.input_size
    if r.motion_blur > 0:
        x = sd.motion_blur(draws, x, p=r.motion_blur)
    if r.pool:
        shift = draws.randint((nb, 2), -IN // 12, IN // 12 + 1)
        x = cm.roll_each(x, shift)
        j2d = j2d + 2.0 * shift[:, None].flip(-1).float() / IN
        gain = draws.uniform((nb, 1, 1, 3), 0.7, 1.3)
        bias = draws.uniform((nb, 1, 1, 3), -0.15, 0.15)
        x = torch.clamp(x * gain + bias + 0.02 * draws.normal(x.shape), -1, 1)
    if r.mobile:  # MobilenetOpenPoseRunner's scaling: BGR, (pix - 128) / 256
        x = x.flip(-1) * 0.5
        hm_t, paf_t, hm_w, paf_w = sd.make_pose2d_targets_coco18(j2d, r.hm_size)
    else:  # OpenPoseRunner's
        x = x * 0.5
        hm_t, paf_t, hm_w, paf_w = sd.make_pose2d_targets(j2d, r.hm_size)

    def on(w):  # the weights copied to the device, with no host sync
        return torch.as_tensor(w).to(x.device, non_blocking=True)

    return x, hm_t, paf_t, on(hm_w), on(paf_w), j2d


def render_pool(draws: sd.Draws, model, assets, batch: int, r: Recipe):
    """The pre-rendered pool (`--pool`): max(pool, batch) scenes."""
    n = max(r.pool, batch)
    xs, js = zip(*[render_scene(draws, model, assets, batch, r) for _ in range(-(-n // batch))])
    return torch.cat(xs)[:n], torch.cat(js)[:n]


def make_batch_synth(draws: sd.Draws, model, assets, batch: int, r: Recipe, pool=None):
    """A synthetic batch: fresh renders, or `pool` rows drawn at random."""
    if pool is not None:
        idx = draws.randint((batch,), 0, pool[0].shape[0])
        return finish_batch(draws, pool[0][idx], pool[1][idx], r)
    x, j2d = render_scene(draws, model, assets, batch, r)
    return finish_batch(draws, x, j2d, r)


def real_batch(draws: sd.Draws, pseudo: dict, n: int, r: Recipe):
    """n pseudo-labeled real crops: a horizontal flip (joints mirrored), a
    joint-consistent shift, appearance jitter; joints that leave the crop
    are invalid; per-sample-validity targets (`real_batch`, `:191-225`)."""
    IN = r.input_size
    idx = draws.randint((n,), 0, pseudo["crops"].shape[0])
    x, kps, val = pseudo["crops"][idx], pseudo["kps"][idx], pseudo["valid"][idx]
    do = draws.bernoulli(0.5, (n,))
    jp = torch.as_tensor(BODY25_FLIP_JOINTS[:25]).to(x.device, non_blocking=True).long()
    x = torch.where(do[:, None, None, None], x.flip(2), x)
    kps = torch.where(do[:, None, None], torch.stack([-kps[..., 0], kps[..., 1]], -1)[:, jp], kps)
    val = torch.where(do[:, None], val[:, jp], val)
    shift = draws.randint((n, 2), -IN // 12, IN // 12 + 1)
    x = cm.roll_each(x, shift)
    kps = kps + 2.0 * shift[:, None].flip(-1).float() / IN
    gain = draws.uniform((n, 1, 1, 3), 0.7, 1.3)
    bias = draws.uniform((n, 1, 1, 3), -0.15, 0.15)
    x = torch.clamp(x * gain + bias + 0.02 * draws.normal(x.shape), -1, 1)
    val = val * (kps.abs() < 1.0).all(-1).float()
    hm_t, paf_t, hm_w, paf_w = sd.make_pose2d_targets_b25(kps, val, r.hm_size)
    return x * 0.5, hm_t, paf_t, hm_w, paf_w


def make_batch(draws: sd.Draws, model, assets, batch: int, r: Recipe, pool=None, pseudo=None,
               real_frac: float = 0.375):
    """The synthetic batch, or with `pseudo` synthetic rows then real rows
    with per-sample weights."""
    if pseudo is None:
        return make_batch_synth(draws, model, assets, batch, r, pool)
    n_real = min(max(int(round(real_frac * batch)), 1), batch - 1)
    xs, hm_s, paf_s, hmw_s, pafw_s, j2d = make_batch_synth(draws, model, assets, batch - n_real, r, pool)
    xr, hm_r, paf_r, hmw_r, pafw_r = real_batch(draws, pseudo, n_real, r)
    ns = batch - n_real
    hm_w = torch.cat([hmw_s.expand(ns, 1, 1, hm_r.shape[-1]), hmw_r])
    paf_w = torch.cat([pafw_s.expand(ns, 1, 1, paf_r.shape[-1]), pafw_r])
    return (torch.cat([xs, xr]), torch.cat([hm_s, hm_r]), torch.cat([paf_s, paf_r]), hm_w, paf_w, j2d)


def loss_fn(net, batch, mobile: bool = False):
    """Weighted squared error of every stage's PAFs and heatmaps, averaged
    over the stages (the last only for Mobilenet) (`loss_fn`, `:255-263`):
    (loss, {paf, hm})."""
    x, hm_t, paf_t, hm_w, paf_w = batch[:5]
    if mobile:
        hm_o, paf_o = net(x)
        pafs, hms = [paf_o], [hm_o]
    else:
        _, _, pafs, hms = net(x, return_stages=True)
    l_paf = sum(torch.mean(((p - paf_t) ** 2) * paf_w) for p in pafs) / len(pafs)
    l_hm = sum(torch.mean(((h - hm_t) ** 2) * hm_w) for h in hms) / len(hms)
    return l_paf + l_hm, {"paf": l_paf.detach(), "hm": l_hm.detach()}


def train_step(net, tx, opt_state, batch, mobile: bool = False):
    with reference_precision():
        loss, aux = loss_fn(net, batch, mobile)
        opt_state = cm.update(net, tx, opt_state, loss)
    return opt_state, loss.detach(), aux


def build(device, mobile: bool = False, resume: str | None = None):
    if mobile:
        from ipercore_tpu_torch.tools.pose2d_mobilenet import MobilenetOpenPose

        net = cm.seeded(MobilenetOpenPose(), cm.SEEDS["mobilenet"])
    else:
        net = cm.seeded(OpenPoseBody25(), cm.SEEDS["openpose"])
    if resume:
        net.load_state_dict(load_params(resume, net), strict=True)
        print(f"resumed from {resume}", flush=True)
    return net.to(device)


def save(path: str, net, input_size: int) -> str:
    """f16 parameters and the training input size (`__meta__/input_size`),
    to which the runners scale their inputs."""
    flat = torch_params_to_flax(net)
    flat[META_PREFIX + "input_size"] = np.asarray(input_size, np.int32)
    return cm.save_f16(path, flat)


def consumer(path: str, device) -> OpenPoseRunner:
    """The shipped Body-25 file in its consumer: `OpenPoseRunner`, strictly."""
    runner = OpenPoseRunner(weights_path=path, device=device)
    assert runner.trained and runner.trained_size is not None, path
    return runner


def heatmap_fn(net, mobile: bool, tta: bool):
    """Heatmaps for the probe: Mobilenet's, or Body-25's with or without the
    flip test-time augmentation."""
    if mobile:
        return lambda x: net(x)[0]
    if not tta:
        return lambda x: net(x)[1]
    flip = torch.as_tensor(BODY25_FLIP_JOINTS, dtype=torch.long)

    def tta_hm(x):
        hm = net(x)[1]
        hm_f = net(x.flip(2))[1].flip(2)
        return 0.5 * (hm + hm_f.index_select(-1, flip.to(x.device)))

    return tta_hm


def probe_inputs(device, r: Recipe) -> list:
    probes = real.probes_or_none(lambda: real.pose_probe_crops(roles=("select",)))
    for p in probes:
        c = resize_linear(torch.as_tensor(p["crop"][None], device=device), (1, r.input_size, r.input_size, 3))
        p["x"] = c.flip(-1) * 0.5 if r.mobile else c * 0.5
    return probes


def probe_pck(hm_apply, probes: list, mobile: bool) -> float:
    """Mean PCK@0.1 of the decoded joints on the probes; -1 without probes."""
    if not probes:
        return -1.0
    accs = []
    with torch.no_grad(), reference_precision():
        for p in probes:
            kps = decode_single_person(hm_apply(p["x"]), n_joints=18 if mobile else 25)[0]
            kps, ids = kps[0].cpu().numpy(), p["ids"]
            if mobile:
                keep = np.asarray([i for i, j in enumerate(ids) if int(j) in B25_TO_C18])
                sel = kps[[B25_TO_C18[int(j)] for j in ids if int(j) in B25_TO_C18]]
                gt = p["gt_ndc"][keep]
            else:
                sel, gt = kps[ids], p["gt_ndc"]
            accs.append(float((np.linalg.norm(sel - gt, axis=-1) < p["thr_ndc"]).mean()))
    return float(np.mean(accs))


def holdout(net, batch, r: Recipe) -> dict:
    """Decode error in input pixels over the supervised in-frame joints, and
    over those the net scores above 0.3."""
    x, j2d = batch[0], batch[5]
    IN = r.input_size
    with torch.no_grad(), reference_precision():
        if r.mobile:
            kps, scores, _ = decode_single_person(net(x)[0], n_joints=18)
            gt = j2d[:, torch.as_tensor(sd.COCO18_FROM_COCOPLUS).to(x.device).long()]
            valid = np.ones((18,), np.float32)
        else:
            kps, scores, _ = decode_single_person(net(x)[1])
            gt, valid = sd.body25_from_cocoplus(j2d)
    in_frame = (gt.abs() < 1.0).all(-1).float().cpu().numpy()
    err = (torch.linalg.norm(kps - gt, dim=-1) * (IN / 2)).cpu().numpy()
    m = valid[None, :] * in_frame
    conf = m * (scores.cpu().numpy() > 0.3)
    return {"decode_px_err": round(float((err * m).sum() / max(m.sum(), 1)), 2),
            "decode_px_err_conf": round(float((err * conf).sum() / max(conf.sum(), 1)), 2),
            "conf_frac": round(float(conf.sum() / max(m.sum(), 1)), 3)}


def load_pseudo(path: str, input_size: int, device) -> dict:
    with np.load(path, allow_pickle=True) as d:
        crops = torch.as_tensor(np.asarray(d["crops"], np.float32), device=device)
        pool = {"kps": torch.as_tensor(np.asarray(d["kps_ndc"], np.float32), device=device),
                "valid": torch.as_tensor(np.asarray(d["valid"], np.float32), device=device)}
    if crops.shape[1] != input_size:
        crops = resize_linear(crops, (crops.shape[0], input_size, input_size, 3))
    return {"crops": crops, **pool}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--scene_size", type=int, default=256)
    ap.add_argument("--input_size", type=int, default=224, help="net input (preprocessing feeds 224 crops)")
    ap.add_argument("--arch", choices=("body25", "mobilenet"), default="body25")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--studio_frac", type=float, default=0.35)
    ap.add_argument("--natural_frac", type=float, default=0.65)
    ap.add_argument("--garment_frac", type=float, default=0.5)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--pool", type=int, default=0,
                    help="pre-render this many scenes once and augment them per step (0: render every step)")
    ap.add_argument("--save_every", type=int, default=300, help="checkpoint cadence in steps (0: at the end)")
    ap.add_argument("--pseudo", type=str, default="", help="npz of pseudo-labeled real crops")
    ap.add_argument("--real_frac", type=float, default=0.375, help="fraction of each batch from --pseudo")
    ap.add_argument("--probe_tta", action="store_true", default=True,
                    help="score probe checkpoints with flip-TTA heatmaps")
    ap.add_argument("--motion_blur", type=float, default=0.5,
                    help="probability of motion blur on each synthetic sample (0 disables)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = cm.resolve_device(args.device)
    if args.smoke:
        args.steps, args.batch = 4, 2
        args.scene_size, args.input_size = 64, 64
        model = smpl_mod.synthetic_model(nu=16, nv=14, device=device)
        assets = load_assets(model, device=device, synthetic=True)
    else:
        model = smpl_mod.template_model(device=device)
        assets = load_assets(model, device=device)
    mobile = args.arch == "mobilenet"
    if args.out is None:
        args.out = os.path.join(WEIGHTS_DIR, "mobilenet_openpose.npz" if mobile else WEIGHTS_NAME)
    args.out = cm.smoke_out(args.out, args.smoke)
    B, IN = args.batch, args.input_size
    r = Recipe(args.scene_size, IN, args.studio_frac, args.garment_frac, args.natural_frac,
               0.0 if args.smoke else args.motion_blur, args.pool, mobile)

    pseudo = None
    if args.pseudo and not args.smoke:
        if mobile:
            raise SystemExit("--pseudo labels are Body-25; use --arch body25")
        pseudo = load_pseudo(args.pseudo, IN, device)
        n_real = min(max(int(round(args.real_frac * B)), 1), B - 1)
        print(f"pseudo pool: {pseudo['crops'].shape[0]} real crops, {B - n_real} synth + {n_real} real "
              "per batch", flush=True)
    pool = None
    if args.pool:
        pool = render_pool(sd.Draws(torch.Generator(device=device).manual_seed(808), device),
                           model, assets, B, r)
        print(f"scene pool ready: {tuple(pool[0].shape)}", flush=True)

    net = build(device, mobile, args.out if args.resume and os.path.exists(args.out) else None)
    tx = cm.adam(args.lr, clip=1.0)
    opt = cm.init_state(tx, net)
    probes = [] if args.smoke else probe_inputs(device, r)
    hm_apply = heatmap_fn(net, mobile, args.probe_tta)

    draws = sd.Draws(torch.Generator(device=device).manual_seed(321), device)
    t0 = time.perf_counter()
    best_q, best_step = -np.inf, -1
    for step in range(args.steps):
        batch = make_batch(draws, model, assets, B, r, pool, pseudo, args.real_frac)
        opt, loss, aux = train_step(net, tx, opt, batch, mobile)
        if step % max(args.steps // 20, 1) == 0 or step == args.steps - 1:
            cm.log({"step": step, "loss": loss, **aux}, digits=5)
        if args.save_every and step and step % args.save_every == 0:
            if probes:
                q = probe_pck(hm_apply, probes, mobile)
                if q >= best_q:
                    best_q, best_step = q, step
                    save(args.out, net, IN)
                cm.log({"step": step, "real_probe_pck": q, "best_step": best_step})
            else:
                save(args.out, net, IN)

    hold = make_batch_synth(sd.Draws(torch.Generator(device=device).manual_seed(777), device),
                            model, assets, B, r, pool)
    result = {"metric": "openpose_synthetic_holdout", "arch": args.arch, **holdout(net, hold, r),
              "steps": args.steps, "train_s": round(time.perf_counter() - t0, 1)}
    q_final = probe_pck(hm_apply, probes, mobile)
    if not probes or q_final >= best_q:
        best_q, best_step = q_final, args.steps - 1
        save(args.out, net, IN)
    result.update(real_probe_pck_best=round(float(best_q), 4), best_step=best_step, out=args.out)
    cm.log(result)
    return result


if __name__ == "__main__":
    main()
