"""End-to-end check of the perception stack against exact ground truth.

Twin of `scripts/verify_perception.py`. Draws one person (fixed shape, a
pose interpolated between two random ones over `--frames` frames) on a fixed
procedural plate, rendered by K1 at twice the size (`synth_data.render_fim`)
with a random linear colouring of the part map, then runs the production
preprocessing components on the frames:

  * SPIN, then (with a trained Body-25) SMPLify against Body-25's keypoints,
    as stage 1.3 wires them; the recovered bodies re-rendered through K3
    (`rasterizer.render_fim_wim`) as the mattor's fallback silhouettes;
  * `HumanMattor` (stage 1.4), the background inpaintor (stage 1.6) on the
    median-visible plate, ESRGAN's 4x against a bilinear upsample, SCHP's
    body mask and false skirt, Mobilenet's keypoints; each gated on its
    weights being trained, as in the JAX driver.

Prints one JSON line: the joints' reprojection error before and after
SMPLify (pixels at `--size`), Body-25's and Mobilenet's keypoint error
(pixels at 224), the mask IoU, the background L1, the SR PSNRs, SCHP's body
IoU and every `*_trained` flag.

    python -m ipercore_tpu_torch.scripts.verify_perception [--frames 8] [--size 256] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.models.mesh import load_assets
from ipercore_tpu_torch.ops import rasterizer as rz
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.tools import pose3d
from ipercore_tpu_torch.tools import synth_data as sd


def sequence(draws: sd.Draws, model, assets, frames: int, size: int) -> dict:
    """The drawn clip (`:58-79`): theta_gt (T, 85), frames (T, S, S, 3),
    alpha (T, S, S, 1), the plate bg (T, S, S, 3) and j2d_gt (T, 19, 2)."""
    T, S, dev = frames, size, draws.device
    thetas = sd.make_theta(draws, 2, pose_std=0.25, yaw=False)
    a, b = thetas[0], thetas[1]
    w = sd._linspace(0.0, 1.0, T, dev)[:, None]
    theta_gt = a[None] * (1 - w) + b[None] * w
    theta_gt[:, 75:85] = a[75:85]  # one shape
    details = smpl_mod.get_details(model, theta_gt)
    fim = sd.render_fim(model, theta_gt, S * 2, f2uvs=assets.f2uvs, details=details)
    alpha = sd._downsample2((fim >= 0).float()[..., None])
    cond = sd._downsample2(rz.encode_fim(fim, assets.map_fn))
    bg = sd.synth_background(draws, 1, S).expand(T, S, S, 3)
    M = draws.uniform((1, 3, 3), -1, 1)
    tex = torch.tanh(torch.einsum("bhwc,bcd->bhwd", cond, M.expand(T, 3, 3)))
    img = tex * alpha + bg * (1.0 - alpha)
    img = torch.clamp(img + 0.05 * draws.normal(img.shape), -1, 1)
    return {"theta_gt": theta_gt, "frames": img, "alpha": alpha, "bg": bg, "j2d_gt": details["j2d"]}


def keypoint_px_224(kps: np.ndarray, b25_gt: torch.Tensor, valid: np.ndarray) -> float:
    """Mean error of the valid Body-25 slots, pixels at 224."""
    err = np.linalg.norm(kps - b25_gt.cpu().numpy(), axis=-1) * (224 / 2)
    return round(float((err * valid[None]).sum() / (valid.sum() * len(kps))), 2)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--no_smplify", action="store_true")
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = cm.resolve_device(args.device)
    from ipercore_tpu_torch.tools.inpaintors import build_background_inpaintors
    from ipercore_tpu_torch.tools.mattors import HumanMattor
    from ipercore_tpu_torch.tools.parsers import build_parser
    from ipercore_tpu_torch.tools.pose2d import OpenPoseRunner, body25_to_cocoplus
    from ipercore_tpu_torch.tools.pose2d_mobilenet import MobilenetOpenPoseRunner

    model = smpl_mod.template_model(device=device)
    assets = load_assets(model, device=device)
    T, S = args.frames, args.size
    seq = sequence(sd.Draws(torch.Generator(device=device).manual_seed(args.seed), device), model, assets, T, S)
    frames, bg = seq["frames"].cpu().numpy(), seq["bg"]
    t0 = time.perf_counter()

    # stage 1.3: SPIN (+ SMPLify)
    spin = pose3d.SPINRunner(device=device)
    spin_in = resize_linear(seq["frames"], (T, 224, 224, 3))
    theta_spin = spin.run(spin_in)

    def j2d_err(theta) -> float:
        d = smpl_mod.get_details(model, torch.as_tensor(np.asarray(theta), device=device))
        return round(float(torch.linalg.norm(d["j2d"] - seq["j2d_gt"], dim=-1).mean()) * (S / 2), 2)

    result = {"metric": "perception_stack_recovery", "frames": T, "size": S, "spin_trained": spin.trained,
              "j2d_px_256_spin": j2d_err(theta_spin)}
    b25_gt, valid25 = sd.body25_from_cocoplus(seq["j2d_gt"])
    theta_rec = theta_spin
    if not args.no_smplify:
        op = OpenPoseRunner(device=device)
        result["openpose_trained"] = op.trained
        if op.trained:
            kps, scores, valid = op.run_tracked(spin_in)
            kps19, conf19 = body25_to_cocoplus(kps, scores * valid)
            t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
            theta_rec = pose3d.smplify_refine(model, t(theta_spin), t(kps19), t(conf19)).detach().cpu().numpy()
            result["j2d_px_256"] = j2d_err(theta_rec)
            result["openpose_px_224"] = keypoint_px_224(kps, b25_gt, valid25)

    # stage 1.4: matting, the recovered bodies as the fallback silhouettes (K3)
    d_rec = smpl_mod.get_details(model, torch.as_tensor(np.asarray(theta_rec), device=device))
    _, fim_rec, _ = rz.render_fim_wim(d_rec["verts"], d_rec["cam"], model.faces, S)
    sil = (fim_rec >= 0)[..., None].float().cpu().numpy()
    mat = HumanMattor(device=device)
    result["mattor_trained"] = mat.trained
    _, m_mask = mat.run(frames, fallback_mask=sil)
    gt_mask = (seq["alpha"] > 0.5).float().cpu().numpy()
    result["mask_iou"] = round(float((m_mask * gt_mask).sum() / np.maximum(m_mask, gt_mask).sum()), 4)

    # stage 1.6: the background inpainted over the median-visible plate
    inp = build_background_inpaintors(control_size=min(S, 256), device=device)
    result["inpaintor_trained"] = inp.trained
    vis = 1.0 - m_mask
    acc = (frames * vis).sum(0) / np.maximum(vis.sum(0), 1e-5)
    hole = (vis.sum(0) < 0.5).astype(np.float32)
    bg_rec = inp.run_inpainting(acc, hole)
    result["bg_l1"] = round(float(np.abs(bg_rec - bg[0].cpu().numpy()).mean()), 4)

    # ESRGAN 4x (when trained): PSNR against a bilinear upsample on the true plate
    if inp.sr_trained:
        lo = cm.box_down4((bg[:1] + 1) * 0.5)
        with torch.no_grad():
            hi = torch.clamp(inp.sr(lo), 0, 1) * 2 - 1
        bil = resize_linear(lo * 2 - 1, tuple(bg[:1].shape))
        psnr = lambda x: round(float(-10 * torch.log10(torch.mean((x - bg[:1]) ** 2 / 4) + 1e-12)), 2)
        result["sr_psnr"], result["sr_psnr_bilinear"] = psnr(hi), psnr(bil)

    # SCHP (when trained): the LIP body mask's IoU, and no skirt in these scenes
    parser = build_parser(None, device=device)
    result["schp_trained"] = parser is not None
    if parser is not None:
        ok, body_masks = parser.run(frames[:4], "body")
        if ok and body_masks:
            bm = np.stack(body_masks)[..., None].astype(np.float32)
            gm = gt_mask[:4]
            result["schp_body_iou"] = round(float((bm * gm).sum() / np.maximum(np.maximum(bm, gm).sum(), 1)), 4)
        result["schp_false_skirt"] = bool(parser.run(frames[:4], "skirt+dress")[0])

    # Mobilenet (when trained): its keypoints' error, no toes, heels or mid-hip
    mob = MobilenetOpenPoseRunner(device=device)
    result["mobilenet_trained"] = mob.trained
    if mob.trained:
        mk, _, _ = mob.run(spin_in)
        v = valid25.copy()
        v[19:] = 0  # no toe / heel channels
        v[8] = 0  # the mid-hip is derived, not decoded
        result["mobilenet_px_224"] = keypoint_px_224(mk, b25_gt, v)

    result["wall_s"] = round(time.perf_counter() - t0, 1)
    cm.log(result)
    return result


if __name__ == "__main__":
    main()
