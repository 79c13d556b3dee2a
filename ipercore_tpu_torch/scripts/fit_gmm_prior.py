"""Fit and ship the SMPLify GMM pose prior (`assets/gmm_prior.npz`).

Twin of `scripts/fit_gmm_prior.py`. Samples `--n` body poses from the
realistic pose mixture (`synth_data.natural_pose`, or, for 1 - natural_frac
of them, the isotropic prior of std `--pose_std`), fits the 8-component
max-mixture prior of SMPLify's shape to the 69-dim body pose (k-means, then
a full covariance per cluster: `tools.pose3d.fit_gmm_raw`) and writes
`means`, `covars` and `weights`. The check prints the mean NLL of held-out
natural poses, far below the T-pose's.

The default `--out` is the tracked `assets/gmm_prior.npz`; pass another
path to fit without replacing it.

    python -m ipercore_tpu_torch.scripts.fit_gmm_prior [--n 16384] [--k 8] [--out path] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.tools.pose3d import _build_gmm_prior, fit_gmm_raw, gmm_prior_nll
from ipercore_tpu_torch.tools.synth_data import Draws, natural_pose
from ipercore_tpu_torch.utils.checkpoint import WEIGHTS_DIR


def pose_samples(draws: Draws, n: int, natural_frac: float, pose_std: float) -> torch.Tensor:
    """(n, 72) poses: natural stances, or isotropic for 1 - natural_frac
    (`:41-44`)."""
    nat = natural_pose(draws, n)
    iso = draws.normal((n, 72)) * pose_std
    use = draws.bernoulli(natural_frac, (n, 1))
    return torch.where(use, nat, iso)


def check_nll(means, covs, weights, hold: torch.Tensor) -> dict:
    """Mean NLL of the held-out body poses (N, 69) and of the T-pose."""
    prior = _build_gmm_prior(means, covs, weights, device=hold.device)
    return {"nll_natural_holdout": round(float(gmm_prior_nll(prior, hold).mean()), 2),
            "nll_tpose": round(float(gmm_prior_nll(prior, torch.zeros((1, 69), device=hold.device)).mean()), 2)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--natural_frac", type=float, default=0.7)
    ap.add_argument("--pose_std", type=float, default=0.25)
    ap.add_argument("--out", type=str, default=os.path.join(WEIGHTS_DIR, "gmm_prior.npz"))
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = cm.resolve_device(args.device)
    draws = lambda seed: Draws(torch.Generator(device=device).manual_seed(seed), device)

    body = pose_samples(draws(7), args.n, args.natural_frac, args.pose_std)[:, 3:]  # no global orient
    means, covs, weights = fit_gmm_raw(body.cpu().numpy(), k=args.k)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, means=means, covars=covs, weights=weights)

    hold = natural_pose(draws(99), 256)[:, 3:]
    result = {"out": args.out, "k": args.k, "n": args.n, **check_nll(means, covs, weights, hold)}
    cm.log(result, digits=2)
    return result


if __name__ == "__main__":
    main()
