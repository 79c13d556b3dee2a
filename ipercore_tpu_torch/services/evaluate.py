"""Evaluation: SSIM / PSNR / LPIPS / FID over frame stacks, and its CLI.

Twin of `ipercore_tpu/services/evaluate.py` and of
`scripts/evaluate/eval_imitator.py`:

    python -m ipercore_tpu_torch.services.evaluate --pred_dir DIR --gt_dir DIR
        [--image_size 256] [--max_frames 500] [--device cuda]

prints one JSON line of metrics. Frames are (N, H, W, 3) in [-1, 1].

The metric keys say which feature net ran: `lpips` and `fid` only with the
published LPIPS(lin) and InceptionV3 weights (`assets/lpips_vgg.npz`,
`assets/inception_v3.npz`, converted by `utils/torch_convert`), else
`lpips_proxy` and `fid_proxy` through the repository's VGG19 pyramid
(`assets/vgg_perceptual.npz`). Without that file the proxy VGG takes
`seeded_flat_params(vgg, 2)` where the JAX package initialises Flax from
`PRNGKey(0)`, which PyTorch cannot reproduce: the proxies then differ from
the JAX package's. The networks run on `device`; the Frechet distance of the
feature statistics is host work in float64 numpy.
"""
from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ipercore_tpu_torch.utils.checkpoint import WEIGHTS_DIR

Device = Union[str, torch.device]

INCEPTION_WEIGHTS = os.path.join(WEIGHTS_DIR, "inception_v3.npz")
LPIPS_WEIGHTS = os.path.join(WEIGHTS_DIR, "lpips_vgg.npz")


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PSNR per item of [-1, 1] images (N, H, W, C)."""
    mse = torch.mean((a - b) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(4.0 / torch.clamp(mse, min=1e-10))


def ssim(a: torch.Tensor, b: torch.Tensor, window: int = 7) -> torch.Tensor:
    """Mean SSIM per item of [-1, 1] NHWC images, over a uniform
    `window` x `window` box without padding."""
    C1, C2 = (0.01 * 2) ** 2, (0.03 * 2) ** 2

    def box(x):
        return F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride=1)

    mu_a, mu_b = box(a), box(b)
    var_a = box(a * a) - mu_a ** 2
    var_b = box(b * b) - mu_b ** 2
    cov = box(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + C1) * (2 * cov + C2)) / ((mu_a ** 2 + mu_b ** 2 + C1) * (var_a + var_b + C2))
    return s.mean(dim=(1, 2, 3))


def _device_of(net: torch.nn.Module) -> torch.device:
    return next(net.parameters()).device


def _feature_stats(pooled: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return pooled.mean(0), np.cov(pooled, rowvar=False)


class PerceptualMetric:
    """LPIPS-style distance through the VGG19 pyramid: each slice's features
    normalized to unit length over channels (at least 1e-8), the mean squared
    difference averaged over the slices. `params`: flat parameters in the
    Flax layout, else `criterions.init_vgg_params` (the shipped checkpoint,
    or seed 2)."""

    def __init__(self, params: Optional[Mapping[str, np.ndarray]] = None, device: Device = "cuda"):
        from ipercore_tpu_torch.models.networks import criterions as C
        from ipercore_tpu_torch.utils.checkpoint import load_generator_params

        self.net = C.build_vgg("VGG19", device=device)
        if params is None:
            C.init_vgg_params(self.net, seed=2)
        else:
            load_generator_params(self.net, params)

    @torch.no_grad()
    def __call__(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        dev = _device_of(self.net)
        fa = self.net(torch.as_tensor(a, dtype=torch.float32, device=dev))
        fb = self.net(torch.as_tensor(b, dtype=torch.float32, device=dev))
        total = 0.0
        for x, y in zip(fa, fb):  # NCHW maps
            xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-8)
            yn = y / torch.clamp(torch.linalg.vector_norm(y, dim=1, keepdim=True), min=1e-8)
            total = total + torch.mean((xn - yn) ** 2, dim=(1, 2, 3))
        return (total / len(fa)).cpu().numpy()

    @torch.no_grad()
    def feature_stats(self, imgs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Mean (C,) and covariance (C, C) of the last slice's spatially
        pooled features (FID-style statistics)."""
        feats = self.net(torch.as_tensor(imgs, dtype=torch.float32, device=_device_of(self.net)))[-1]
        return _feature_stats(feats.mean(dim=(2, 3)).cpu().numpy())


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """Frechet distance between Gaussians (the FID formula; the trace of
    sqrt(cov1 @ cov2) from the eigenvalues of the product)."""
    diff = mu1 - mu2
    w, _ = np.linalg.eig(cov1 @ cov2)
    sqrt_trace = np.sqrt(np.maximum(w.real, 0)).sum()
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * sqrt_trace)


def _load_net(net: torch.nn.Module, path: str, params) -> bool:
    """Load `params` (flat, Flax layout) or the `.npz` at `path` into `net`
    strictly; False when there is neither."""
    from ipercore_tpu_torch.utils.checkpoint import load_flat_npz, load_generator_params

    if params is None and not os.path.exists(path):
        return False
    load_generator_params(net, load_flat_npz(path) if params is None else params)
    return True


class InceptionFID:
    """FID statistics through InceptionV3 pool3 features (the published
    metric). Weights: `params` (flat, Flax layout), else `weights_path` or
    `assets/inception_v3.npz` when it exists; `available` says whether any
    was loaded."""

    def __init__(self, weights_path: Optional[str] = None,
                 params: Optional[Mapping[str, np.ndarray]] = None, device: Device = "cuda"):
        from ipercore_tpu_torch.models.networks.inception import InceptionV3Features

        self.path = weights_path or INCEPTION_WEIGHTS
        self.net = InceptionV3Features().to(device).eval().requires_grad_(False)
        self._available = _load_net(self.net, self.path, params)

    @property
    def available(self) -> bool:
        return self._available

    @torch.no_grad()
    def features(self, imgs: np.ndarray, batch: int = 16) -> torch.Tensor:
        """imgs (N, H, W, 3) in [-1, 1], resized to 299² (linear, antialiased
        when shrinking, as `jax.image.resize`) -> (N, 2048) on the device."""
        from ipercore_tpu_torch.ops.sampling import resize_image

        x = resize_image(torch.as_tensor(imgs, dtype=torch.float32, device=_device_of(self.net)), 299, 299)
        return torch.cat([self.net(x[i:i + batch]) for i in range(0, len(x), batch)])

    def feature_stats(self, imgs: np.ndarray, batch: int = 16) -> tuple[np.ndarray, np.ndarray]:
        """imgs (N, H, W, 3) in [-1, 1] -> (mu (2048,), cov (2048, 2048))."""
        return _feature_stats(self.features(imgs, batch).cpu().numpy())


class LPIPSMetric:
    """LPIPS(lin). Weights: `params` (flat, Flax layout), else `weights_path`
    or `assets/lpips_vgg.npz` when it exists; `available` gates the metric
    key."""

    def __init__(self, weights_path: Optional[str] = None,
                 params: Optional[Mapping[str, np.ndarray]] = None, device: Device = "cuda"):
        from ipercore_tpu_torch.models.networks.criterions import LPIPSLin

        self.path = weights_path or LPIPS_WEIGHTS
        self.net = LPIPSLin().to(device).eval().requires_grad_(False)
        self._available = _load_net(self.net, self.path, params)

    @property
    def available(self) -> bool:
        return self._available

    @torch.no_grad()
    def __call__(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        dev = _device_of(self.net)
        return self.net(torch.as_tensor(a, dtype=torch.float32, device=dev),
                        torch.as_tensor(b, dtype=torch.float32, device=dev)).cpu().numpy()


@torch.no_grad()
def evaluate_frames(pred: np.ndarray, gt: np.ndarray, metric: Optional[PerceptualMetric] = None,
                    fid_net: Optional[InceptionFID] = None, lpips_net: Optional[LPIPSMetric] = None,
                    device: Device = "cuda") -> dict:
    """All metrics over (N, H, W, 3) [-1, 1] frame stacks: `ssim`, `psnr`,
    then `lpips` or `lpips_proxy`, and `fid` or `fid_proxy`, as the feature
    nets' weights allow (module note). The nets not given are built on
    `device`; the proxy VGG only when an exact net is missing."""
    a = torch.as_tensor(pred, dtype=torch.float32, device=device)
    b = torch.as_tensor(gt, dtype=torch.float32, device=device)
    out = {"ssim": float(ssim(a, b).mean()), "psnr": float(psnr(a, b).mean())}
    lpips_net = lpips_net if lpips_net is not None else LPIPSMetric(device=device)
    fid_net = fid_net if fid_net is not None else InceptionFID(device=device)

    def get_metric():
        nonlocal metric
        if metric is None:
            metric = PerceptualMetric(device=device)
        return metric

    if lpips_net.available:
        out["lpips"] = float(np.mean(lpips_net(pred, gt)))
    else:
        out["lpips_proxy"] = float(np.mean(get_metric()(pred, gt)))
    if fid_net.available:
        out["fid"] = frechet_distance(*fid_net.feature_stats(pred), *fid_net.feature_stats(gt))
    else:
        out["fid_proxy"] = frechet_distance(*get_metric().feature_stats(pred),
                                            *get_metric().feature_stats(gt))
    return out


def main(argv=None) -> int:
    """The CLI (module note): frames listed and sorted by name in both
    directories, the first `min(len)` pairs (at most `--max_frames`), each
    loaded at `--image_size`²."""
    import argparse

    from ipercore_tpu_torch.utils import video as vid

    p = argparse.ArgumentParser(description="SSIM / PSNR / LPIPS / FID over two frame directories")
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--max_frames", type=int, default=500)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    preds = vid.list_frames(args.pred_dir)[: args.max_frames]
    gts = vid.list_frames(args.gt_dir)[: args.max_frames]
    n = min(len(preds), len(gts))
    if n == 0:
        print(json.dumps({"error": "no frames"}))
        return 1
    a = np.stack([vid.load_image(f, size=args.image_size) for f in preds[:n]])
    b = np.stack([vid.load_image(f, size=args.image_size) for f in gts[:n]])
    metrics = evaluate_frames(a, b, device=args.device)
    metrics["n_frames"] = n
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
