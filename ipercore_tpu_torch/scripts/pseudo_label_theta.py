"""Chain-distilled pseudo SMPL labels for SPIN on the real sample clip.

Twin of `scripts/pseudo_label_theta.py`. The pose pseudo-labels
(`pseudo_label_pose`'s `akun_pseudo.npz`, frames before the held-out band
only) go through the production stage-1.3 chain: the trained SPIN on the
crops resized to 224, then multi-hypothesis SMPLify (`--iters` steps, the GMM
pose prior, the temporal terms) against the labelled keypoints. A frame is
kept when its confidence-weighted reprojection error is under `--err_gate`
(crop NDC); the (crop, theta) pairs are the pool `train_spin --pseudo`
reads. `--in_npz` and `--out` default to the JAX driver's fixed paths.

    python -m ipercore_tpu_torch.scripts.pseudo_label_theta [--err_gate 0.09] [--iters 150] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.scripts import _common as cm

IN_NPZ = os.path.join(cm.REPO_DIR, ".cache", "pseudo_pose", "akun_pseudo.npz")
OUT_NPZ = os.path.join(cm.REPO_DIR, ".cache", "pseudo_pose", "akun_theta.npz")


def distill(crops: np.ndarray, kps: np.ndarray, valid: np.ndarray, iters: int, device, model=None):
    """(theta (N, 85), reprojection error (N,)) of SPIN + SMPLify on the
    labelled crops, numpy (`:66-86`)."""
    from ipercore_tpu_torch.tools.pose2d import body25_to_cocoplus
    from ipercore_tpu_torch.tools.pose3d import (GMM_DEFAULT_WEIGHTS, SMPLifyConfig, SPINRunner, load_gmm_prior,
                                                 reprojection_error, smplify_refine_multi)

    spin = SPINRunner(device=device)
    if not spin.trained:
        raise SystemExit("no trained spin weights")
    model = model or smpl_mod.template_model(device=device)
    theta0 = spin.run(resize_linear(crops, (len(crops), 224, 224, 3)))
    kps19, conf19 = body25_to_cocoplus(kps, valid)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    prior = load_gmm_prior(GMM_DEFAULT_WEIGHTS, device=device)
    theta = smplify_refine_multi(model, t(theta0), t(kps19), t(conf19),
                                 cfg=SMPLifyConfig()._replace(n_iters=iters), prior=prior)
    err = reprojection_error(model, theta, t(kps19), t(conf19))
    return theta.detach().cpu().numpy(), err.detach().cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--err_gate", type=float, default=0.09,
                    help="max confidence-weighted reprojection error (crop NDC; person height is ~1.7 NDC) "
                         "for a kept label")
    ap.add_argument("--iters", type=int, default=150, help="SMPLify iterations")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--in_npz", type=str, default=IN_NPZ, help="the pose pseudo-labels")
    ap.add_argument("--out", type=str, default=OUT_NPZ)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = cm.resolve_device(args.device)
    with np.load(args.in_npz, allow_pickle=True) as d:
        crops = np.asarray(d["crops"], np.float32)
        kps, valid, frames = d["kps_ndc"], d["valid"], d["frames"]
    N = len(crops)
    print(f"{N} pseudo-labeled crops", flush=True)
    theta, err = distill(crops, kps, valid, args.iters, device)
    keep = err < args.err_gate
    stats = {"n": int(N), "kept": int(keep.sum()), "err_mean": round(float(err.mean()), 4),
             "err_med": round(float(np.median(err)), 4), "err_gate": args.err_gate}
    print(json.dumps(stats), flush=True)
    if args.report or not keep.any():
        return stats
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, crops=crops[keep].astype(np.float16), theta=theta[keep].astype(np.float32),
                        frames=frames[keep], meta=json.dumps(stats))
    print(f"wrote {args.out}", flush=True)
    return stats


if __name__ == "__main__":
    main()
