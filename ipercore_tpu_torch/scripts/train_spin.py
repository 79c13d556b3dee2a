"""Train the SPIN pose regressor on procedural SMPL renders.

Twin of `scripts/train_spin.py`. Scenes drawn on the device
(`tools/synth_data.compose_scene`, K1 at twice the scene size) carry exact
theta and projected joints; the scene is resized to 224 (linear,
antialiased), ImageNet-normalised, and the loss supervises the rotations,
the shape, the camera and the joints' reprojection through the full LBS:

  L = |R_pred - R_gt|^2 + 0.2 |beta|^2 err + 5 |cam|^2 err + 2 |j2d|^2 err

The joints go through the rotation-matrix LBS entry (`lbs_from_rot`): the
axis-angle round trip's gradient is singular at 0. The batch norms run on
their frozen statistics, and the optimizer leaves `mean` / `var`
bit-unchanged. `--pseudo` mixes pseudo-labeled real crops into every batch.
Checkpoints are chosen by PCK@0.1 on the annotated real select images where
they exist. Ships `assets/spin.npz` (f16), which `tools.pose3d.SPINRunner`
loads in both packages.

    python -m ipercore_tpu_torch.scripts.train_spin [--steps 4000] [--batch 16] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.models.imitator import reference_precision
from ipercore_tpu_torch.models.mesh import load_assets
from ipercore_tpu_torch.ops.rotations import rodrigues, rot6d_to_rotmat
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.scripts import eval_real_photos as real
from ipercore_tpu_torch.tools import synth_data as sd
from ipercore_tpu_torch.tools.pose3d import HMR_IMG_SIZE, IMAGENET_MEAN, IMAGENET_STD, SPINNet, SPINRunner
from ipercore_tpu_torch.utils.checkpoint import WEIGHTS_DIR, load_params, torch_params_to_flax

W_BETA, W_CAM, W_J2D = 0.2, 5.0, 2.0
SCENE_KW = ("studio_frac", "garment_frac", "natural_frac")
WEIGHTS_NAME = "spin.npz"


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> ImageNet-normalised (`SPINRunner.run`'s preprocessing)."""
    mean = torch.tensor(IMAGENET_MEAN).to(x.device, non_blocking=True)  # a copy, no host sync
    std = torch.tensor(IMAGENET_STD).to(x.device, non_blocking=True)
    return ((x + 1.0) * 0.5 - mean) / std


def synth_batch(draws: sd.Draws, model, assets, batch: int, size: int, studio_frac: float = 0.35,
                garment_frac: float = 0.5, natural_frac: float = 0.65):
    """(x (B, 224, 224, 3) normalised, theta (B, 85), j2d (B, 19, 2))
    (`synth_batch`, `train_spin.py:112-120`)."""
    sb = sd.compose_scene(draws, model, assets, batch=batch, size=size, studio_frac=studio_frac,
                          garment_frac=garment_frac, natural_frac=natural_frac)
    x = resize_linear(sb.img, (batch, HMR_IMG_SIZE, HMR_IMG_SIZE, 3))
    return normalize(x), sb.theta, sb.j2d


def real_batch(draws: sd.Draws, model, pseudo: dict, n: int):
    """n augmented pseudo-labeled real crops and their chain thetas: a shift
    that moves the weak-perspective camera with it (t += delta / s), gain
    and bias (`real_batch`, `train_spin.py:122-142`)."""
    idx = draws.randint((n,), 0, pseudo["crops"].shape[0])
    x, th = pseudo["crops"][idx], pseudo["theta"][idx].clone()
    shift = draws.randint((n, 2), -HMR_IMG_SIZE // 14, HMR_IMG_SIZE // 14 + 1)
    x = cm.roll_each(x, shift)
    delta = 2.0 * shift.flip(-1).float() / HMR_IMG_SIZE
    th[:, 1:3] = th[:, 1:3] + delta / th[:, 0:1]
    gain = draws.uniform((n, 1, 1, 3), 0.75, 1.25)
    bias = draws.uniform((n, 1, 1, 3), -0.12, 0.12)
    x = torch.clamp(x * gain + bias, -1, 1)
    return normalize(x), th, smpl_mod.get_details(model, th)["j2d"]


def make_batch(draws: sd.Draws, model, assets, batch: int, size: int, pseudo: dict | None = None,
               real_frac: float = 0.375, **scene):
    """The synthetic batch, or with `pseudo` synthetic rows then real rows."""
    if pseudo is None:
        return synth_batch(draws, model, assets, batch, size, **scene)
    n_real = n_real_rows(batch, real_frac)
    xs, ts, js = synth_batch(draws, model, assets, batch - n_real, size, **scene)
    xr, tr, jr = real_batch(draws, model, pseudo, n_real)
    return torch.cat([xs, xr]), torch.cat([ts, tr]), torch.cat([js, jr])


def n_real_rows(batch: int, real_frac: float) -> int:
    return min(max(int(round(real_frac * batch)), 1), batch - 1)


def predict_j2d(net: SPINNet, model, x: torch.Tensor):
    """(pose6d, shape, cam, R (N, 24, 3, 3), j2d (N, 19, 2)) through the
    rotation-matrix LBS entry."""
    pose6d, shape, cam = net(x)
    R = rot6d_to_rotmat(pose6d.reshape(-1, 24, 6))
    verts, _ = smpl_mod.lbs_from_rot(model, shape, R)
    j3d = torch.einsum("kv,nvd->nkd", model.joint_regressor, verts)
    return pose6d, shape, cam, R, smpl_mod.batch_orth_proj_idrot(j3d, cam)


def loss_fn(net: SPINNet, batch, model):
    """(loss, {rot, beta, cam, j2d_px}) (`loss_fn`, `train_spin.py:176-197`)."""
    x, theta_gt, j2d_gt = batch
    n = x.shape[0]
    _, shape, cam, R_pred, j2d_pred = predict_j2d(net, model, x)
    R_gt = rodrigues(theta_gt[:, 3:75].reshape(n, 24, 3))
    l_rot = torch.mean((R_pred - R_gt) ** 2)
    l_beta = torch.mean((shape - theta_gt[:, 75:85]) ** 2)
    l_cam = torch.mean((cam - theta_gt[:, 0:3]) ** 2)
    l_j2d = torch.mean((j2d_pred - j2d_gt) ** 2)
    loss = l_rot + W_BETA * l_beta + W_CAM * l_cam + W_J2D * l_j2d
    px = torch.linalg.norm(j2d_pred - j2d_gt, dim=-1).mean() * (HMR_IMG_SIZE / 2)
    return loss, {k: v.detach() for k, v in
                  {"rot": l_rot, "beta": l_beta, "cam": l_cam, "j2d_px": px}.items()}


def frozen_stats(net: SPINNet) -> list[str]:
    """The batch norms' running statistics, which the optimizer leaves as they are."""
    return [k for k, _ in net.named_parameters() if k.rsplit(".", 1)[-1] in ("mean", "var")]


def optimizer(net: SPINNet, lr: float):
    """clip_by_global_norm(1.0) -> masked(adam(lr)), the statistics masked out."""
    return cm.adam(lr, clip=1.0, frozen=frozen_stats(net))


def train_step(net: SPINNet, tx, opt_state, batch, model):
    with reference_precision():
        loss, aux = loss_fn(net, batch, model)
        opt_state = cm.update(net, tx, opt_state, loss)
    return opt_state, loss.detach(), aux


def build(device, resume: str | None = None) -> SPINNet:
    net = cm.seeded(SPINNet(), cm.SEEDS["spin"])
    if resume:
        net.load_state_dict(load_params(resume, net), strict=True)
        print(f"resumed from {resume}", flush=True)
    return net.to(device)


def save(path: str, net: SPINNet) -> str:
    return cm.save_f16(path, torch_params_to_flax(net))


def consumer(path: str, device) -> SPINRunner:
    """The shipped file in its consumer: `SPINRunner`, strictly."""
    runner = SPINRunner(weights_path=path, device=device)
    assert runner.trained, path
    return runner


def load_pseudo(path: str, device) -> dict:
    """The chain-distilled (crop, theta) pool, crops resized to 224."""
    with np.load(path, allow_pickle=True) as d:
        crops = torch.as_tensor(np.asarray(d["crops"], np.float32), device=device)
        theta = torch.as_tensor(np.asarray(d["theta"], np.float32), device=device)
    if crops.shape[1] != HMR_IMG_SIZE:
        crops = resize_linear(crops, (crops.shape[0], HMR_IMG_SIZE, HMR_IMG_SIZE, 3))
    return {"crops": crops, "theta": theta}


def probe_inputs(device) -> list:
    """The select images' pose probes with their net inputs, or []."""
    probes = real.probes_or_none(lambda: real.pose_probe_crops(roles=("select",)))
    for p in probes:
        c = torch.as_tensor(p["crop"][None], device=device)
        p["x"] = normalize(resize_linear(c, (1, HMR_IMG_SIZE, HMR_IMG_SIZE, 3)))
    return probes


def probe_pck(net: SPINNet, model, probes: list) -> float:
    """Mean reprojection PCK@0.1 of the predicted SMPL joints as Body-25 on
    the probes; -1 without probes (`train_spin.py:268-281`)."""
    if not probes:
        return -1.0
    accs = []
    with torch.no_grad(), reference_precision():
        for p in probes:
            b25, valid = sd.body25_from_cocoplus(predict_j2d(net, model, p["x"])[-1])
            ids = p["ids"]
            vm = valid[ids] > 0
            sel = b25[0].cpu().numpy()[ids][vm]
            err = np.linalg.norm(sel - p["gt_ndc"][vm], axis=-1)
            accs.append(float((err < p["thr_ndc"]).mean()))
    return float(np.mean(accs))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--scene_size", type=int, default=256)
    ap.add_argument("--out", type=str, default=os.path.join(WEIGHTS_DIR, WEIGHTS_NAME))
    ap.add_argument("--resume", action="store_true", help="initialize from an existing --out checkpoint")
    ap.add_argument("--studio_frac", type=float, default=0.35)
    ap.add_argument("--garment_frac", type=float, default=0.5)
    ap.add_argument("--natural_frac", type=float, default=0.65)
    ap.add_argument("--save_every", type=int, default=250,
                    help="real-probe checkpoint-selection cadence in steps")
    ap.add_argument("--pseudo", type=str, default="",
                    help="npz of pseudo-labeled (crop, theta) pairs mixed into every batch")
    ap.add_argument("--real_frac", type=float, default=0.375, help="fraction of each batch from --pseudo")
    ap.add_argument("--smoke", action="store_true", help="tiny run (CI)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    args.out = cm.smoke_out(args.out, args.smoke)
    device = cm.resolve_device(args.device)
    if args.smoke:
        args.steps, args.batch, args.scene_size = 8, 2, 64
        model = smpl_mod.synthetic_model(nu=16, nv=14, device=device)
        assets = load_assets(model, device=device, synthetic=True)
    else:
        model = smpl_mod.template_model(device=device)
        assets = load_assets(model, device=device)
    B, S = args.batch, args.scene_size
    scene = {k: getattr(args, k) for k in SCENE_KW}
    pseudo = None
    if args.pseudo and not args.smoke:
        pseudo = load_pseudo(args.pseudo, device)
        n_real = n_real_rows(B, args.real_frac)
        print(f"pseudo pool: {pseudo['crops'].shape[0]} real (crop, theta) pairs; "
              f"{B - n_real} synth + {n_real} real per batch", flush=True)

    net = build(device, args.out if args.resume and os.path.exists(args.out) else None)
    tx = optimizer(net, args.lr)
    opt = cm.init_state(tx, net)
    probes = [] if args.smoke else probe_inputs(device)

    draws = sd.Draws(torch.Generator(device=device).manual_seed(123), device)
    t0 = time.perf_counter()
    best_q, best_step = -np.inf, -1
    for step in range(args.steps):
        batch = make_batch(draws, model, assets, B, S, pseudo, args.real_frac, **scene)
        opt, loss, aux = train_step(net, tx, opt, batch, model)
        if step % max(args.steps // 20, 1) == 0 or step == args.steps - 1:
            cm.log({"step": step, "loss": loss, **aux})
        if args.save_every and step and step % args.save_every == 0 and probes:
            q = probe_pck(net, model, probes)
            if q >= best_q:
                best_q, best_step = q, step
                save(args.out, net)
            cm.log({"step": step, "real_probe_pck": q, "best_step": best_step})

    hold = synth_batch(sd.Draws(torch.Generator(device=device).manual_seed(777), device),
                       model, assets, B, S, **scene)
    with torch.no_grad(), reference_precision():
        _, aux = loss_fn(net, hold, model)
    result = {"metric": "spin_synthetic_holdout", "j2d_px_224": round(float(aux["j2d_px"]), 2),
              "rot_mse": round(float(aux["rot"]), 4), "steps": args.steps,
              "train_s": round(time.perf_counter() - t0, 1)}
    # the final parameters replace the best probe checkpoint only if they beat it
    q_final = probe_pck(net, model, probes)
    if not probes or q_final >= best_q:
        best_q, best_step = q_final, args.steps - 1
        save(args.out, net)
    result.update(real_probe_pck_best=round(float(best_q), 4), best_step=best_step, out=args.out)
    cm.log(result)
    return result


if __name__ == "__main__":
    main()
