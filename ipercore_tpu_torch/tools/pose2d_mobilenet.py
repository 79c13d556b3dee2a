"""Lightweight Mobilenet OpenPose (COCO-18) — the fast 2D-pose variant.

The port's copy of `ipercore_tpu/tools/pose2d_mobilenet.py` (the reference's
`openpose/models/mobilenet.py`, Osokin's lightweight-human-pose-estimation):
a MobileNet-v1 trunk (depthwise-separable convolutions, a dilated tail), a
CPM alignment head, one initial and N refinement stages, each emitting 19
heatmaps + 38 PAFs. Batch norms are frozen (`blocks.FrozenBatchNorm`'s
parameters and epsilon). The network takes and returns NHWC tensors and runs
NCHW inside; its state-dict names are the Flax tree's. The decode is shared
with Body-25 (`tools/pose2d_decode.py`).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.models.networks.blocks import FrozenBatchNorm
from ipercore_tpu_torch.utils.checkpoint import (WEIGHTS_DIR, load_flat_npz, load_generator_params,
                                                 seeded_flat_params)

N_COCO_HEATMAPS = 19  # 18 joints + background
N_COCO_PAFS = 38
# seeded weights when no weight file is given (the JAX package inits from PRNGKey(0))
MOBILENET_SEED = 6


def _bn(bn: FrozenBatchNorm, x: torch.Tensor) -> torch.Tensor:
    """`FrozenBatchNorm` (its parameters and epsilon) on an NCHW tensor."""
    c = lambda p: p[:, None, None]
    return (x - c(bn.mean)) * c(bn.scale * torch.rsqrt(bn.var + bn.eps)) + c(bn.bias)


class ConvDW(nn.Module):
    """Depthwise (dilated, strided) 3x3 conv + BN + ReLU, pointwise conv + BN + ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.dw = nn.Conv2d(cin, cin, 3, stride=stride, padding=dilation, dilation=dilation,
                            groups=cin, bias=False)
        self.dwbn = FrozenBatchNorm(cin)
        self.pw = nn.Conv2d(cin, features, 1, bias=False)
        self.pwbn = FrozenBatchNorm(features)

    def forward(self, x):
        x = F.relu(_bn(self.dwbn, self.dw(x)))
        return F.relu(_bn(self.pwbn, self.pw(x)))


class ConvDWNoBN(nn.Module):
    """Depthwise-separable conv with ELU, no BN."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.dw = nn.Conv2d(cin, cin, 3, padding=1, groups=cin, bias=False)
        self.pw = nn.Conv2d(cin, features, 1, bias=False)

    def forward(self, x):
        return F.elu(self.pw(F.elu(self.dw(x))))


class Cpm(nn.Module):
    """CPM alignment head."""

    def __init__(self, cin: int, features: int = 128):
        super().__init__()
        self.align = nn.Conv2d(cin, features, 1)
        for i in range(3):
            self.add_module(f"trunk{i}", ConvDWNoBN(features, features))
        self.conv = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        x = F.relu(self.align(x))
        t = x
        for i in range(3):
            t = getattr(self, f"trunk{i}")(t)
        return F.relu(self.conv(x + t))


class InitialStage(nn.Module):
    def __init__(self, features: int = 128, n_heatmaps: int = N_COCO_HEATMAPS, n_pafs: int = N_COCO_PAFS):
        super().__init__()
        for i in range(3):
            self.add_module(f"trunk{i}", nn.Conv2d(features, features, 3, padding=1))
        self.hm0 = nn.Conv2d(features, 512, 1)
        self.hm1 = nn.Conv2d(512, n_heatmaps, 1)
        self.paf0 = nn.Conv2d(features, 512, 1)
        self.paf1 = nn.Conv2d(512, n_pafs, 1)

    def forward(self, x):
        t = x
        for i in range(3):
            t = F.relu(getattr(self, f"trunk{i}")(t))
        return self.hm1(F.relu(self.hm0(t))), self.paf1(F.relu(self.paf0(t)))


class RefinementBlock(nn.Module):
    """1x1 align + two BN'd 3x3 convs (the second dilated 2), residual."""

    def __init__(self, cin: int, features: int = 128):
        super().__init__()
        self.initial = nn.Conv2d(cin, features, 1)
        self.trunk0 = nn.Conv2d(features, features, 3, padding=1)
        self.trunk0_bn = FrozenBatchNorm(features)
        self.trunk1 = nn.Conv2d(features, features, 3, padding=2, dilation=2)
        self.trunk1_bn = FrozenBatchNorm(features)

    def forward(self, x):
        init = F.relu(self.initial(x))
        t = F.relu(_bn(self.trunk0_bn, self.trunk0(init)))
        t = F.relu(_bn(self.trunk1_bn, self.trunk1(t)))
        return init + t


class RefinementStage(nn.Module):
    def __init__(self, cin: int, features: int = 128, n_heatmaps: int = N_COCO_HEATMAPS,
                 n_pafs: int = N_COCO_PAFS):
        super().__init__()
        for b in range(5):
            self.add_module(f"block{b}", RefinementBlock(cin if b == 0 else features, features))
        self.hm0 = nn.Conv2d(features, features, 1)
        self.hm1 = nn.Conv2d(features, n_heatmaps, 1)
        self.paf0 = nn.Conv2d(features, features, 1)
        self.paf1 = nn.Conv2d(features, n_pafs, 1)

    def forward(self, x):
        for b in range(5):
            x = getattr(self, f"block{b}")(x)
        return self.hm1(F.relu(self.hm0(x))), self.paf1(F.relu(self.paf0(x)))


class MobilenetOpenPose(nn.Module):
    """`PoseEstimationWithMobileNet`: input (N, H, W, 3); returns the last
    stage's (heatmaps, pafs) at H/8, NHWC."""

    # (out_channels, stride, dilation) per MobileNet block after the stem
    TRUNK = ((64, 1, 1), (128, 2, 1), (128, 1, 1), (256, 2, 1), (256, 1, 1),
             (512, 1, 1), (512, 1, 2), (512, 1, 1), (512, 1, 1), (512, 1, 1),
             (512, 1, 1))

    def __init__(self, num_refinement_stages: int = 1, features: int = 128):
        super().__init__()
        self.num_refinement_stages = num_refinement_stages
        self.model0_conv = nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False)
        self.model0_bn = FrozenBatchNorm(32)
        cin = 32
        for i, (width, stride, dil) in enumerate(self.TRUNK, start=1):
            self.add_module(f"model{i}", ConvDW(cin, width, stride, dil))
            cin = width
        self.cpm = Cpm(cin, features)
        self.initial_stage = InitialStage(features)
        for r in range(num_refinement_stages):
            self.add_module(f"refine{r}", RefinementStage(features + N_COCO_HEATMAPS + N_COCO_PAFS, features))

    def forward(self, x):
        x = F.relu(_bn(self.model0_bn, self.model0_conv(x.permute(0, 3, 1, 2))))
        for i in range(1, len(self.TRUNK) + 1):
            x = getattr(self, f"model{i}")(x)
        feats = self.cpm(x)
        hm, paf = self.initial_stage(feats)
        for r in range(self.num_refinement_stages):
            hm, paf = getattr(self, f"refine{r}")(torch.cat([feats, hm, paf], dim=1))
        return hm.permute(0, 2, 3, 1), paf.permute(0, 2, 3, 1)


# COCO-18 joint id -> Body-25 slot (Body-25 8 = mid-hip has no COCO joint;
# the runner makes it from the two hips), so Mobilenet results go through the
# same `body25_to_cocoplus` formatter as the default estimator.
COCO18_TO_BODY25_SLOT = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18], np.int32)

MOBILENET_DEFAULT_WEIGHTS = os.path.join(WEIGHTS_DIR, "mobilenet_openpose.npz")


class MobilenetOpenPoseRunner:
    """Runner of the lightweight variant on the device, with the (kps, scores,
    valid) Body-25-slot contract of `pose2d.OpenPoseRunner.run`.

    The published checkpoint's normalisation is (pix - 128) / 256 in BGR:
    inputs in [-1, 1] RGB map to it as `x[..., ::-1] * 0.5`. Without
    `params`, weights load from `weights_path` or
    `assets/mobilenet_openpose.npz` when it exists, else
    `seeded_flat_params(net, 6)` (`trained` False)."""

    def __init__(self, params=None, weights_path: str = None, device="cuda"):
        self.device = torch.device(device)
        self.net = MobilenetOpenPose().eval()
        self.trained = params is not None
        if params is None:
            path = weights_path or MOBILENET_DEFAULT_WEIGHTS
            if os.path.exists(path):
                params = load_flat_npz(path)
                self.trained = True
            else:
                params = seeded_flat_params(self.net, MOBILENET_SEED)
        load_generator_params(self.net, params)
        self.net.to(self.device)
        self.params = params

    def _apply(self, images):
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return self.net(x.flip(3) * 0.5)

    def _to_body25(self, kps18, scores18):
        """(N, 18, 2) / (N, 18) COCO -> (N, 25, 2) / (N, 25) Body-25 slots."""
        N = kps18.shape[0]
        kps = np.zeros((N, 25, 2), np.float32)
        scores = np.zeros((N, 25), np.float32)
        kps[:, COCO18_TO_BODY25_SLOT] = kps18
        scores[:, COCO18_TO_BODY25_SLOT] = scores18
        kps[:, 8] = 0.5 * (kps[:, 9] + kps[:, 12])
        scores[:, 8] = np.minimum(scores[:, 9], scores[:, 12])
        return kps, scores

    def run(self, images):
        """images: (N, H, W, 3) in [-1, 1]. Returns kps (N, 25, 2) NDC,
        scores (N, 25), valid (N, 25)."""
        from ipercore_tpu_torch.tools.pose2d import decode_single_person

        hm, _ = self._apply(images)
        kps18, scores18, _ = decode_single_person(hm, n_joints=18)
        kps, scores = self._to_body25(kps18.cpu().numpy(), scores18.cpu().numpy())
        return kps, scores, scores > 0.1

    def run_tracked(self, images, smooth: bool = True):
        """NMS + PAF grouping + 1-euro over the COCO-18 topology, the mirror
        of `pose2d.OpenPoseRunner.run_tracked`."""
        from ipercore_tpu_torch.tools.pose2d import decode_single_person
        from ipercore_tpu_torch.tools.pose2d_decode import (COCO18_LIMBS, COCO18_PAF_IDS, OneEuroFilter,
                                                            decode_multi_person, pick_largest_person)

        hm, paf = self._apply(images)
        kps18, scores18, _ = decode_single_person(hm, n_joints=18)
        kps18, scores18 = np.array(kps18.cpu().numpy()), np.array(scores18.cpu().numpy())
        hm_n, paf_n = hm.cpu().numpy(), paf.cpu().numpy()
        h, w = hm_n.shape[1:3]
        filt = OneEuroFilter() if smooth else None
        for i in range(len(hm_n)):
            people = decode_multi_person(hm_n[i], paf_n[i], limbs=COCO18_LIMBS,
                                         paf_ids=COCO18_PAF_IDS, n_joints=18)
            best = pick_largest_person(people)
            if best is not None:
                px = best["kps"]  # (18, 2) pixel coords, NaN missing
                ndc = np.stack([(2 * px[:, 0] + 1 - w) / w, (2 * px[:, 1] + 1 - h) / h], axis=1)
                take = np.isfinite(ndc[:, 0])
                kps18[i][take] = ndc[take]
                scores18[i][take] = best["scores"][take]
            if filt is not None:
                kps18[i] = filt(kps18[i])
        kps, scores = self._to_body25(kps18, scores18)
        return kps, scores, scores > 0.1
