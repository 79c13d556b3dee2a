"""3D pose and shape: SPIN (ResNet-50 + iterative regressor) and SMPLify.

The port's copy of `ipercore_tpu/tools/pose3d.py`:
  * the SPIN network (ResNet-50 trunk with frozen batch norms, a 3-step
    regressor of rot6d pose, shape and camera) and its batched runner;
  * the priors of the fit: the Geman-McClure robust error, the knee/elbow
    angle prior and the max-mixture Gaussian pose prior;
  * SMPLify: fixed-iteration Adam over (rot6d pose, shape, camera) against
    2D keypoints, and the multi-hypothesis fit that also refines from a
    natural stance with a camera fit to the keypoints.

The networks take NHWC tensors at their boundary and run NCHW inside; their
submodules carry the Flax names, so a flat `.npz` of the JAX package loads
through the strict carrier. The fit reads nothing back to the host: its loop
is a Python loop of `torch.autograd.grad` and Adam steps on the device.
"""
from __future__ import annotations

import os
import pickle
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.models.networks.blocks import FrozenBatchNorm, frozen_bn_nchw as _bn
from ipercore_tpu_torch.ops.rotations import axis_angle_to_rot6d, rot6d_to_rotmat, rotmat_to_axis_angle
from ipercore_tpu_torch.utils.checkpoint import (WEIGHTS_DIR, load_flat_npz, load_generator_params,
                                                 seeded_flat_params)

HMR_IMG_SIZE = 224
# seeded weights when no weight file is given (the JAX package inits from PRNGKey(0))
SPIN_SEED = 7
SPIN_DEFAULT_WEIGHTS = os.path.join(WEIGHTS_DIR, "spin.npz")
GMM_DEFAULT_WEIGHTS = os.path.join(WEIGHTS_DIR, "gmm_prior.npz")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Bottleneck(nn.Module):
    """torchvision's bottleneck (stride on the 3x3), NCHW."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(features * 4)
        if cin != features * 4 or stride != 1:
            self.downsample_conv = nn.Conv2d(cin, features * 4, 1, stride=stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(features * 4)

    def forward(self, x):
        y = F.relu(_bn(self.bn1, self.conv1(x)))
        y = F.relu(_bn(self.bn2, self.conv2(y)))
        y = _bn(self.bn3, self.conv3(y))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = _bn(self.downsample_bn, self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """ResNet-50 trunk with frozen batch norms: NCHW in, (N, 2048) out."""

    STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for i, (blocks, width) in enumerate(self.STAGES):
            for b in range(blocks):
                stride = 2 if (b == 0 and i > 0) else 1
                self.add_module(f"layer{i + 1}_{b}", Bottleneck(cin, width, stride))
                cin = width * 4

    def forward(self, x):
        x = F.relu(_bn(self.bn1, self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i, (blocks, _) in enumerate(self.STAGES):
            for b in range(blocks):
                x = getattr(self, f"layer{i + 1}_{b}")(x)
        return x.mean(dim=(2, 3))  # global average pool


class SPINRegressor(nn.Module):
    """Iterative HMR regressor: `n_iter` refinements of (pose6d, shape, cam)."""

    def __init__(self, n_iter: int = 3, feat_dim: int = 2048):
        super().__init__()
        self.n_iter = n_iter
        self.fc1 = nn.Linear(feat_dim + 24 * 6 + 10 + 3, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.decpose = nn.Linear(1024, 24 * 6)
        self.decshape = nn.Linear(1024, 10)
        self.deccam = nn.Linear(1024, 3)

    def forward(self, feats, pose, shape, cam):
        for _ in range(self.n_iter):
            x = torch.cat([feats, pose, shape, cam], dim=-1)
            x = F.relu(self.fc2(F.relu(self.fc1(x))))
            pose = self.decpose(x) + pose
            shape = self.decshape(x) + shape
            cam = self.deccam(x) + cam
        return pose, shape, cam


class SPINNet(nn.Module):
    """ResNet-50 + iterative regressor. `init_cam` starts at (0.9, 0, 0), as
    the Flax initializer sets it (`SEED_VALUES`, read by `seeded_flat_params`)."""

    SEED_VALUES = {"init_cam": (0.9, 0.0, 0.0)}

    def __init__(self):
        super().__init__()
        self.backbone = ResNet50()
        self.init_pose = nn.Parameter(torch.zeros(1, 24 * 6))
        self.init_shape = nn.Parameter(torch.zeros(1, 10))
        self.init_cam = nn.Parameter(torch.tensor([self.SEED_VALUES["init_cam"]]))
        self.regressor = SPINRegressor()

    def forward(self, images):
        """images: (N, 224, 224, 3) ImageNet-normalized, NHWC.

        Returns: pose6d (N, 144), shape (N, 10), cam (N, 3)."""
        n = images.shape[0]
        feats = self.backbone(images.permute(0, 3, 1, 2))
        return self.regressor(feats, self.init_pose.expand(n, -1), self.init_shape.expand(n, -1),
                              self.init_cam.expand(n, -1))


def spin_output_to_theta(pose6d: torch.Tensor, shape: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """(N, 144) rot6d + (N, 10) + (N, 3) -> (N, 85) theta (cam | pose_aa | shape)."""
    n = pose6d.shape[0]
    aa = rotmat_to_axis_angle(rot6d_to_rotmat(pose6d.reshape(n, 24, 6))).reshape(n, 72)
    return torch.cat([cam, aa, shape], dim=-1)


class SPINRunner:
    """Batched SPIN inference on the device.

    Without `params` (flat parameters in the Flax layout), the weights load
    from `weights_path` or `assets/spin.npz` when that file exists (`trained`
    True), else they are `seeded_flat_params(net, SPIN_SEED)` (`trained`
    False)."""

    def __init__(self, params=None, weights_path: str = None, device="cuda"):
        self.device = torch.device(device)
        self.net = SPINNet().eval()
        self.trained = params is not None
        if params is None:
            path = weights_path or SPIN_DEFAULT_WEIGHTS
            if os.path.exists(path):
                params = load_flat_npz(path)
                self.trained = True
            else:
                params = seeded_flat_params(self.net, SPIN_SEED)
        load_generator_params(self.net, params)
        self.net.to(self.device)
        self.params = params
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, device=self.device)

    def run(self, images, batch_size: int = 32) -> np.ndarray:
        """images: (N, 224, 224, 3) in [-1, 1], an array or a tensor. Returns
        numpy theta (N, 85). The tail is padded with the last frame to a
        whole batch, as the JAX package pads it to its one compiled shape."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        x = ((x + 1.0) * 0.5 - self._mean) / self._std
        n = x.shape[0]
        pad = (-n) % batch_size
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, -1, -1, -1)])
        with torch.inference_mode():
            outs = [spin_output_to_theta(*self.net(x[i:i + batch_size]))
                    for i in range(0, x.shape[0], batch_size)]
        return torch.cat(outs)[:n].cpu().numpy()


# ---------------------------------------------------------------------------
# SMPLify refinement
# ---------------------------------------------------------------------------


def gmof(x: torch.Tensor, sigma: float = 100.0) -> torch.Tensor:
    """Geman-McClure robust error (`smplify/losses.py:213`)."""
    sq = x ** 2
    return sq * sigma / (sq + sigma ** 2)


def angle_prior(pose_aa: torch.Tensor) -> torch.Tensor:
    """Penalize unnatural knee/elbow bending (`smplify/losses.py:20-26`).

    pose_aa: (N, 72) including the global orient: elbow-y (joints 18, 19) at
    55 and 58 and knee-x (joints 4, 5) at 12 and 15, signs (1, -1, -1, -1).
    The columns are taken by slicing, so no index crosses from the host."""
    vals = torch.stack([pose_aa[:, 55], -pose_aa[:, 58], -pose_aa[:, 12], -pose_aa[:, 15]], dim=-1)
    return torch.sum(torch.exp(vals) ** 2, dim=-1)


class GMMPosePrior(NamedTuple):
    """Max-mixture Gaussian pose prior (`smplify/prior.py:99-215`).

    means: (K, 69) body-pose axis-angle (no global orient);
    precisions: (K, 69, 69) inverse covariances;
    log_nll_weights: (K,) log of the reference's `nll_weights`.
    """

    means: torch.Tensor
    precisions: torch.Tensor
    log_nll_weights: torch.Tensor


def load_gmm_prior(path: str, device="cuda") -> Optional[GMMPosePrior]:
    """A GMM pose prior from this repository's `.npz` (`means`, `covars`,
    `weights`) or from SMPLify's `gmm_08.pkl` (a pickle: it must come from a
    trusted source); None when `path` does not exist."""
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        with np.load(path) as z:
            gmm = {k: z[k] for k in z.files}
    else:
        with open(path, "rb") as f:
            gmm = pickle.load(f, encoding="latin1")
    means = np.asarray(gmm["means"], np.float64)
    covs = np.asarray(gmm["covars"], np.float64)
    weights = np.asarray(gmm["weights"], np.float64)
    return _build_gmm_prior(means, covs, weights, device)


def _build_gmm_prior(means, covs, weights, device="cuda") -> GMMPosePrior:
    """Inverses and determinants in float64 numpy, then cast to float32, as
    the JAX package computes them."""
    precisions = np.stack([np.linalg.inv(c) for c in covs])
    sqrdets = np.sqrt(np.clip([np.linalg.det(c) for c in covs], 1e-300, None))
    const = (2 * np.pi) ** (means.shape[1] / 2.0)
    nll_weights = weights / (const * (sqrdets / sqrdets.min()))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return GMMPosePrior(means=f32(means), precisions=f32(precisions),
                        log_nll_weights=f32(np.log(np.clip(nll_weights, 1e-30, None))))


def fit_gmm_raw(samples: np.ndarray, k: int = 8, iters: int = 20,
                reg: float = 1e-4, seed: int = 0):
    """K-means + per-cluster full covariance; the raw (means, covs, weights)
    arrays (the `gmm_08.pkl` layout). Numpy with `RandomState(seed)`."""
    rng = np.random.RandomState(seed)
    x = np.asarray(samples, np.float64)
    n, d = x.shape
    k = min(k, n)
    centers = x[rng.choice(n, k, replace=False)]
    for _ in range(iters):
        d2 = ((x[:, None] - centers[None]) ** 2).sum(-1)
        assign = d2.argmin(1)
        for j in range(k):
            sel = x[assign == j]
            if len(sel):
                centers[j] = sel.mean(0)
    covs, weights = [], []
    for j in range(k):
        sel = x[assign == j]
        if len(sel) < 2:
            covs.append(np.eye(d) * reg)
        else:
            covs.append(np.cov(sel.T) + np.eye(d) * reg)
        weights.append(max(len(sel), 1) / n)
    return centers, np.stack(covs), np.asarray(weights)


def fit_gmm_prior(samples: np.ndarray, k: int = 8, iters: int = 20,
                  reg: float = 1e-4, seed: int = 0, device="cuda") -> GMMPosePrior:
    """A k-component prior fit to pose samples (`fit_gmm_raw`)."""
    return _build_gmm_prior(*fit_gmm_raw(samples, k, iters, reg, seed), device=device)


def gmm_prior_nll(prior: GMMPosePrior, body_pose: torch.Tensor) -> torch.Tensor:
    """Max-mixture negative log-likelihood: the min over components of
    (0.5 quadratic form - log nll_weight). body_pose (N, 69) -> (N,)."""
    diff = body_pose[:, None, :] - prior.means[None]  # (N, K, D)
    quad = torch.einsum("nkj,kji,nki->nk", diff, prior.precisions, diff)
    return torch.amin(0.5 * quad - prior.log_nll_weights[None], dim=1)


class SMPLifyConfig(NamedTuple):
    n_iters: int = 40
    lr: float = 0.02
    kp_sigma: float = 100.0
    w_reproj: float = 1.0
    w_pose_reg: float = 1e-3
    w_shape_reg: float = 1e-2
    w_angle: float = 1e-2
    w_temporal: float = 1e-2
    # the GMM prior and temporal joint smoothness (effective weights: the
    # reference squares its `losses.py:103-150` weights)
    w_gmm: float = 1e-3
    w_smooth_j2d: float = 1e-2
    w_smooth_j3d: float = 1.0


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0, which is 1 (`torch.abs` gives 0 there).
    The temporal 2D term takes |j2d[t+1] - j2d[t]|, which is exactly 0 where
    consecutive frames share a theta (a still clip, a repeated init)."""
    return torch.where(x >= 0, x, -x)


def _unpack(params: dict) -> torch.Tensor:
    n = params["pose"].shape[0]
    aa = rotmat_to_axis_angle(rot6d_to_rotmat(params["pose"].reshape(n, 24, 6))).reshape(n, 72)
    return torch.cat([params["cam"], aa, params["shape"]], dim=-1)


def smplify_loss(model, params: dict, pose0: torch.Tensor, kps2d: torch.Tensor,
                 kps_conf: torch.Tensor, cfg: SMPLifyConfig,
                 prior: Optional[GMMPosePrior]) -> torch.Tensor:
    """SMPLify's objective (`smplify.py:46-175`, `losses.py:103-150`) at
    params {pose (N, 144) rot6d, shape (N, 10), cam (N, 3)}: the robust
    reprojection error, the GMM prior (else L2 to the initial rot6d pose
    `pose0`), the shape and angle priors, and temporal smoothness."""
    pose6d, shape = params["pose"], params["shape"]
    n = pose6d.shape[0]
    theta = _unpack(params)
    details = smpl_mod.get_details(model, theta)
    j2d, j3d = details["j2d"], details["j3d"]
    reproj = torch.sum(kps_conf[..., None] * gmof(j2d - kps2d, cfg.kp_sigma), dim=(1, 2))
    if prior is not None:
        pose_prior = gmm_prior_nll(prior, theta[:, 6:75]) * cfg.w_gmm
    else:
        pose_prior = torch.sum((pose6d - pose0) ** 2, dim=-1) * cfg.w_pose_reg
    shape_reg = torch.sum(shape ** 2, dim=-1)
    ang = angle_prior(theta[:, 3:75])
    total = (cfg.w_reproj * torch.sum(reproj) + torch.sum(pose_prior)
             + cfg.w_shape_reg * torch.sum(shape_reg) + cfg.w_angle * torch.sum(ang))
    if n > 1:
        temporal = cfg.w_temporal * torch.sum((pose6d[1:] - pose6d[:-1]) ** 2)
        conf_d = kps_conf[1:] ** 2
        temporal = temporal + cfg.w_smooth_j2d * torch.sum(
            conf_d * torch.sum(_abs(j2d[1:] - j2d[:-1]), dim=-1))
        temporal = temporal + cfg.w_smooth_j3d * torch.sum((j3d[1:] - j3d[:-1]) ** 2)
        total = total + temporal
    return total


def smplify_refine(
    model: smpl_mod.SMPLModel,
    theta_init: torch.Tensor,
    kps2d: torch.Tensor,
    kps_conf: torch.Tensor,
    cfg: SMPLifyConfig = SMPLifyConfig(),
    prior: Optional[GMMPosePrior] = None,
) -> torch.Tensor:
    """Refine SMPL parameters against 2D keypoints with `cfg.n_iters` steps
    of Adam (optax's `adam(cfg.lr)`: b1 0.9, b2 0.999, eps 1e-8).

    Args:
        theta_init: (N, 85); kps2d: (N, 19, 2) in [-1, 1]; kps_conf: (N, 19),
            all on the model's device.
        prior: optional GMM pose prior (`load_gmm_prior` / `fit_gmm_prior`).

    Returns:
        theta_refined: (N, 85).
    """
    from ipercore_tpu_torch.trainers.lwg_trainer import Adam

    n = theta_init.shape[0]
    theta_init = theta_init.detach().clone()  # also frees an inference-mode tensor for autograd
    pose0 = axis_angle_to_rot6d(theta_init[:, 3:75].reshape(n, 24, 3)).reshape(n, 144)
    params = {"pose": pose0, "shape": theta_init[:, 75:].clone(), "cam": theta_init[:, :3].clone()}
    tx = Adam(cfg.lr, grad_clip=0.0, b1=0.9, skip_nonfinite=False)
    state = tx.init(params)
    names = list(params)
    for _ in range(cfg.n_iters):
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = smplify_loss(model, leaves, pose0, kps2d, kps_conf, cfg, prior)
            grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        params, state = tx.apply(grads, state, params)
    return _unpack(params).detach()


# Arms-down standing pose in axis-angle: SMPL's zero pose is a T-pose;
# shoulder z-rotations of +-1.1 rad (joints 16 / 17) lower the arms.
NATURAL_STANCE = ((3 * 16 + 2, 1.1), (3 * 17 + 2, -1.1))


def natural_stance_aa() -> np.ndarray:
    pose = np.zeros((72,), np.float32)
    for i, v in NATURAL_STANCE:
        pose[i] = v
    return pose


def keypoint_cam_init(
    model: smpl_mod.SMPLModel,
    kps2d: torch.Tensor,
    kps_conf: torch.Tensor,
    pose_aa: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """SPIN-free SMPLify init: a canonical pose with the weak-perspective
    camera fit to the keypoints by confidence-weighted least squares
    (s = cov_w(X, Y) / var_w(X), t = (mean_w(Y) - s mean_w(X)) / s).

    kps2d: (N, 19, 2) NDC; kps_conf: (N, 19). Returns theta (N, 85). The
    natural stance is written on the device, not copied from the host."""
    n, dev = kps2d.shape[0], kps2d.device
    theta0 = torch.zeros(n, 85, device=dev, dtype=kps2d.dtype)
    theta0[:, 0] = 1.0
    if pose_aa is not None:
        theta0[:, 3:75] = torch.as_tensor(pose_aa, dtype=kps2d.dtype, device=dev)
    else:
        for i, v in NATURAL_STANCE:
            theta0[:, 3 + i] = v
    X = smpl_mod.get_details(model, theta0)["j2d"]  # cam (1, 0, 0): the model's own xy
    Y, w = kps2d, torch.clamp(kps_conf, min=0.0)[..., None]
    wsum = torch.clamp(w.sum(dim=1, keepdim=True), min=1e-6)
    mX = (w * X).sum(dim=1, keepdim=True) / wsum
    mY = (w * Y).sum(dim=1, keepdim=True) / wsum
    cov = (w * (X - mX) * (Y - mY)).sum(dim=(1, 2))
    var = torch.clamp((w * (X - mX) ** 2).sum(dim=(1, 2)), min=1e-6)
    s = torch.clamp(cov / var, 0.2, 5.0)
    t = (mY[:, 0] - s[:, None] * mX[:, 0]) / s[:, None]
    return torch.cat([s[:, None], t, theta0[:, 3:]], dim=-1)


def reprojection_error(
    model: smpl_mod.SMPLModel,
    theta: torch.Tensor,
    kps2d: torch.Tensor,
    kps_conf: torch.Tensor,
) -> torch.Tensor:
    """Confidence-weighted mean 2D joint error per frame (N,), in NDC."""
    j2d = smpl_mod.get_details(model, theta)["j2d"]
    err = torch.linalg.norm(j2d - kps2d, dim=-1)
    w = torch.clamp(kps_conf, min=0.0)
    return (w * err).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1e-6)


def smplify_refine_multi(
    model: smpl_mod.SMPLModel,
    theta_init: torch.Tensor,
    kps2d: torch.Tensor,
    kps_conf: torch.Tensor,
    cfg: SMPLifyConfig = SMPLifyConfig(),
    prior: Optional[GMMPosePrior] = None,
) -> torch.Tensor:
    """Multi-hypothesis SMPLify: refine from the given init and from a
    natural stance with a keypoint-fit camera, keep each frame's winner by
    reprojection error, refine the selected sequence for half the steps (at
    least 10) and keep that only where it does not lose more than 0.01 to
    the selection. The selections are `torch.where` on the device."""
    h0 = smplify_refine(model, theta_init, kps2d, kps_conf, cfg, prior)
    nat = keypoint_cam_init(model, kps2d, kps_conf)
    h1 = smplify_refine(model, nat, kps2d, kps_conf, cfg, prior)
    e0 = reprojection_error(model, h0, kps2d, kps_conf)
    e1 = reprojection_error(model, h1, kps2d, kps_conf)
    sel = torch.where((e1 < e0)[:, None], h1, h0)
    short = cfg._replace(n_iters=max(cfg.n_iters // 2, 10))
    final = smplify_refine(model, sel, kps2d, kps_conf, short, prior)
    ef = reprojection_error(model, final, kps2d, kps_conf)
    es = torch.minimum(e0, e1)
    return torch.where((ef <= es + 0.01)[:, None], final, sel)
