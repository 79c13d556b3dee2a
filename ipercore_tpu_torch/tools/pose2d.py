"""2D pose estimation: OpenPose Body-25 in torch + decoding.

The port's copy of `ipercore_tpu/tools/pose2d.py` (the reference's
`human_pose2d_estimators/openpose/`): the Body-25 network (VGG-ish stem +
four PAF stages + two heatmap stages of dense MConv blocks) and its runner.
The network takes and returns NHWC tensors like its Flax twin and runs NCHW
inside (one permute each way); its state-dict names are the Flax tree's
(`model0.conv1_1`, `block02.Mconv1_stage0_L2_0`, ...), so the carrier
(`utils/checkpoint.py`) loads `openpose.npz` strictly.

Two decode paths:
  * `decode_single_person` — per-joint argmax with a 3x3 centre-of-mass
    refinement, on the device: the fast path when one person is guaranteed;
  * `OpenPoseRunner.run_tracked` — heatmap NMS + greedy PAF grouping +
    largest-person pick + 1-euro filter on the host (`tools/pose2d_decode.py`).
    It is `decode_tracked(*heads(images))`: the network with the flip on the
    device, then the host decode.

Spans (`utils/logging.span`, recorded while `torch.profiler` records):
`pose2d.run` (`frames`, `batches`) around `run_tracked`; `pose2d.heads`
(`frames`, `padded`) a batch, holding `pose2d.stem`, `pose2d.paf_stages`,
`pose2d.heatmap_stages` (`OpenPoseBody25.forward`) and `pose2d.flip_merge`;
`pose2d.fetch`, the argmax decode and the heads coming to the host; and
`pose2d.decode` (`frames`, `peaks` kept over the frames and joints, `people`
grouped over the frames), the host decode of the clip.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.models.networks.criterions import ChannelPReLU
from ipercore_tpu_torch.utils.checkpoint import (META_PREFIX, WEIGHTS_DIR, load_flat_npz,
                                                 load_generator_params, seeded_flat_params)
from ipercore_tpu_torch.utils.logging import span

N_BODY25_JOINTS = 25
N_BODY25_PAFS = 52
# seeded weights when no weight file is given (the JAX package inits from PRNGKey(0))
OPENPOSE_SEED = 4
# frames a chunk of `OpenPoseRunner.heads` (the network sees twice as many, with the flip)
BATCH = 32
# a clip's tail chunk runs at a multiple of this many frames: on an H100 (float32, TF32 off)
# cuDNN ran chunks of 11-31 frames that are no multiple of 4 at 2.6-6.5x a full chunk's time
# a frame, the multiples of 4 within 1.26x and chunks of 1-10 frames faster than a full chunk
CHUNK_MULTIPLE = 4

# Body-25 left<->right joint swap (horizontal-flip test-time augmentation):
# 2-4 R arm <-> 5-7 L arm, 9-11 R leg <-> 12-14 L leg, 15/16 eyes, 17/18
# ears, 19-21 L foot <-> 22-24 R foot; 0/1/8 are midline. Channel 25 = bg.
BODY25_FLIP_JOINTS = np.asarray(
    [0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11,
     16, 15, 18, 17, 22, 23, 24, 19, 20, 21, 25], np.int32)


def _body25_paf_flip_tables():
    """(perm, sign) over the 52 PAF channels for horizontal flip: channel c
    of the flip-TTA output reads sign[c] * flip_x(paf[..., perm[c]]) — the
    mirrored limb's field, with the x-component negated."""
    from ipercore_tpu_torch.tools.pose2d_decode import BODY25_LIMBS, BODY25_PAF_IDS

    swap = {int(a): int(b) for a, b in zip(BODY25_FLIP_JOINTS[:25], range(25)) if a != b}
    perm = np.arange(N_BODY25_PAFS, dtype=np.int32)
    sign = np.ones(N_BODY25_PAFS, np.float32)
    for i, (ja, jb) in enumerate(BODY25_LIMBS):
        m = BODY25_LIMBS.index((swap.get(ja, ja), swap.get(jb, jb)))
        cx, cy = BODY25_PAF_IDS[i]
        mcx, mcy = BODY25_PAF_IDS[m]
        perm[cx], perm[cy] = mcx, mcy
        sign[cx] = -1.0
    return perm, sign


def chunk_frames(n: int, batch_size: int = BATCH) -> list:
    """The frames each chunk of `OpenPoseRunner.heads` runs through the
    network for a clip of n frames: chunks of `batch_size`, and the tail
    chunk of a clip longer than a chunk rounded up to a multiple of
    `CHUNK_MULTIPLE` (at most the chunk's size)."""
    bs = min(batch_size, n)
    sizes = [min(bs, n - i) for i in range(0, n, bs)]
    return [min(bs, -(-k // CHUNK_MULTIPLE) * CHUNK_MULTIPLE) for k in sizes]


def _prelu(slopes: ChannelPReLU, x: torch.Tensor) -> torch.Tensor:
    """`ChannelPReLU` (its per-channel slopes, 0.25 when seeded) on an NCHW
    tensor: `F.prelu` takes channel dim 1 and gives the same values as the
    module's NHWC `where`."""
    return F.prelu(x, slopes.weight)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class OpenPoseStem(nn.Module):
    """model0 — VGG stem + CPM convs with PReLU tails (NCHW inside)."""

    WIDTHS = (("conv1_1", 3, 64), ("conv1_2", 64, 64), ("pool",),
              ("conv2_1", 64, 128), ("conv2_2", 128, 128), ("pool",),
              ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
              ("conv3_4", 256, 256), ("pool",), ("conv4_1", 256, 512))
    PRELU = (("conv4_2", "prelu4_2", 512, 512), ("conv4_3_CPM", "prelu4_3_CPM", 512, 256),
             ("conv4_4_CPM", "prelu4_4_CPM", 256, 128))

    def __init__(self):
        super().__init__()
        for entry in self.WIDTHS:
            if entry[0] != "pool":
                self.add_module(entry[0], _conv3(entry[1], entry[2]))
        for conv, prelu, cin, cout in self.PRELU:
            self.add_module(conv, _conv3(cin, cout))
            self.add_module(prelu, ChannelPReLU(cout))

    def forward(self, x):
        for entry in self.WIDTHS:
            if entry[0] == "pool":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, entry[0])(x))
        for conv, prelu, _, _ in self.PRELU:
            x = _prelu(getattr(self, prelu), getattr(self, conv)(x))
        return x


class StackMConv(nn.Module):
    """One OpenPose-1.5 refinement stage: 5 dense triple-MConv blocks + 1x1
    squeeze + 1x1 head, named as the reference checkpoint
    ('Mconv{i}_stage{s}_L{l}_{col}', 'Mprelu...'), one level deep (NCHW)."""

    def __init__(self, stage: int, l_name: int, mid: int, out_channels: int, cin: int):
        super().__init__()
        self.stage, self.l_name, self.mid = stage, l_name, mid
        s, l = stage, l_name
        for i in range(1, 6):
            c = cin if i == 1 else 3 * mid
            for col in range(3):
                self.add_module(f"Mconv{i}_stage{s}_L{l}_{col}", _conv3(c if col == 0 else mid, mid))
                self.add_module(f"Mprelu{i}_stage{s}_L{l}_{col}", ChannelPReLU(mid))
        squeeze = 256 if mid == 96 else 512
        self.add_module(f"Mconv6_stage{s}_L{l}", nn.Conv2d(3 * mid, squeeze, 1))
        self.add_module(f"Mprelu6_stage{s}_L{l}", ChannelPReLU(squeeze))
        self.add_module(f"Mconv7_stage{s}_L{l}", nn.Conv2d(squeeze, out_channels, 1))

    def forward(self, x):
        s, l = self.stage, self.l_name
        for i in range(1, 6):
            outs = []
            h = x
            for col in range(3):
                h = getattr(self, f"Mconv{i}_stage{s}_L{l}_{col}")(h)
                h = _prelu(getattr(self, f"Mprelu{i}_stage{s}_L{l}_{col}"), h)
                outs.append(h)
            x = torch.cat(outs, dim=1)
        x = _prelu(getattr(self, f"Mprelu6_stage{s}_L{l}"), getattr(self, f"Mconv6_stage{s}_L{l}")(x))
        return getattr(self, f"Mconv7_stage{s}_L{l}")(x)


class OpenPoseBody25(nn.Module):
    """Body-25 OpenPose 1.5: model0 stem -> 4 PAF (L2) stages -> 2 heatmap
    (L1) stages. Input (N, H, W, 3) in [-0.5, 0.5]; returns (pafs, heatmaps)
    at H/8, NHWC."""

    def __init__(self):
        super().__init__()
        feat, P, J = 128, N_BODY25_PAFS, N_BODY25_JOINTS + 1
        self.model0 = OpenPoseStem()
        self.block02 = StackMConv(0, 2, 96, P, feat)
        self.block12 = StackMConv(1, 2, 128, P, feat + P)
        self.block22 = StackMConv(2, 2, 128, P, feat + P)
        self.block32 = StackMConv(3, 2, 128, P, feat + P)
        self.block01 = StackMConv(0, 1, 96, J, feat + P)
        self.block11 = StackMConv(1, 1, 128, J, feat + P + J)

    def forward(self, x, return_stages: bool = False):
        """`return_stages=True` also returns every stage's output (4 PAF + 2
        heatmap tensors), as for deep supervision during training."""
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        with span("pose2d.stem"):
            feat = self.model0(x.permute(0, 3, 1, 2))
        with span("pose2d.paf_stages"):
            pafs = [self.block02(feat)]
            for block in (self.block12, self.block22, self.block32):
                pafs.append(block(torch.cat([feat, pafs[-1]], dim=1)))
        paf = pafs[-1]
        with span("pose2d.heatmap_stages"):
            hms = [self.block01(torch.cat([feat, paf], dim=1))]
            hms.append(self.block11(torch.cat([feat, paf, hms[0]], dim=1)))
        if return_stages:
            return nhwc(paf), nhwc(hms[-1]), [nhwc(p) for p in pafs], [nhwc(h) for h in hms]
        return nhwc(paf), nhwc(hms[-1])


def decode_single_person(heatmaps: torch.Tensor, threshold: float = 0.1, n_joints: int = None):
    """Argmax + sub-pixel decode per joint (single person), on the tensor's
    device. The sub-pixel refinement is a 3x3 centre of mass around the peak
    of the zero-padded heatmap; ties of the argmax take the first maximum in
    (N, h*w, J) order, as `jnp.argmax`.

    Args:
        heatmaps: (N, h, w, J+1); the last channel is background.

    Returns:
        kps: (N, J, 2) x, y in [-1, 1] NDC; scores (N, J); valid (N, J).
    """
    hm = heatmaps[..., :(n_joints or N_BODY25_JOINTS)]
    N, h, w, J = hm.shape
    flat = hm.reshape(N, h * w, J)
    idx = flat.argmax(dim=1)  # (N, J)
    scores = flat.gather(1, idx[:, None, :])[:, 0]
    ys = idx // w
    xs = idx % w
    flatp = F.pad(hm, (0, 0, 1, 1, 1, 1)).reshape(N, (h + 2) * (w + 2), J)
    num_x = torch.zeros_like(scores)
    num_y = torch.zeros_like(scores)
    den = torch.zeros_like(scores)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nidx = (ys + 1 + dy) * (w + 2) + (xs + 1 + dx)
            v = flatp.gather(1, nidx[:, None, :])[:, 0].clamp(min=0.0)
            num_x = num_x + v * dx
            num_y = num_y + v * dy
            den = den + v
    off_x = (num_x / den.clamp(min=1e-6)).clamp(-1.0, 1.0)
    off_y = (num_y / den.clamp(min=1e-6)).clamp(-1.0, 1.0)
    # divide by tensors on the heatmaps' device: CUDA turns a division by a
    # Python number into a product with its rounded reciprocal, which the CPU
    # (and JAX) do not, and the decode must not depend on the device
    x_ndc = (2.0 * (xs.to(hm.dtype) + off_x) + 1.0 - w) / hm.new_tensor(float(w))
    y_ndc = (2.0 * (ys.to(hm.dtype) + off_y) + 1.0 - h) / hm.new_tensor(float(h))
    return torch.stack([x_ndc, y_ndc], dim=-1), scores, scores > threshold


OPENPOSE_DEFAULT_WEIGHTS = os.path.join(WEIGHTS_DIR, "openpose.npz")


def _numpy(*tensors):
    return tuple(t.cpu().numpy() for t in tensors)


class OpenPoseRunner:
    """Chunked runner of Body-25 on the device, with the flip test-time
    augmentation.

    Without `params` (flat parameters in the Flax layout), the weights load
    from `weights_path` or `assets/openpose.npz` when that file exists
    (`trained` True, `trained_size` from its `__meta__/input_size`), else they
    are `seeded_flat_params(net, 4)` (`trained` False)."""

    def __init__(self, params=None, weights_path: str = None, device="cuda"):
        self.device = torch.device(device)
        self.net = OpenPoseBody25().eval()
        self.trained = params is not None
        # the FCN runs at any resolution but is scale-calibrated to the one it
        # trained at; trainers stamp it into the checkpoint
        self.trained_size = None
        if params is None:
            path = weights_path or OPENPOSE_DEFAULT_WEIGHTS
            if os.path.exists(path):
                params = load_flat_npz(path)
                self.trained = True
                if META_PREFIX + "input_size" in params:
                    self.trained_size = int(params[META_PREFIX + "input_size"])
            else:
                params = seeded_flat_params(self.net, OPENPOSE_SEED)
        load_generator_params(self.net, params)
        self.net.to(self.device)
        self.params = params
        perm, sign = _body25_paf_flip_tables()
        self._flip_joints = torch.as_tensor(BODY25_FLIP_JOINTS, dtype=torch.long, device=self.device)
        self._perm = torch.as_tensor(perm, dtype=torch.long, device=self.device)
        self._sign = torch.as_tensor(sign, device=self.device)

    def _apply(self, x: torch.Tensor):
        # the flip test-time augmentation, in one batch of [x; flip(x)]:
        # average the original heads with the un-flipped mirrored heads (joint
        # channels swapped, mirrored limbs' PAFs with negated x-components)
        n = x.shape[0]
        paf, hm = self.net(torch.cat([x, x.flip(2)]))
        with span("pose2d.flip_merge"):
            hm_f = hm[n:].flip(2).index_select(3, self._flip_joints)
            paf_f = paf[n:].flip(2).index_select(3, self._perm) * self._sign
            return 0.5 * (paf[:n] + paf_f), 0.5 * (hm[:n] + hm_f)

    def heads(self, images, batch_size: int = BATCH):
        """The network with the flip in chunks of `batch_size` frames:
        (pafs, heatmaps) as NHWC tensors on the device. `images` is
        (N, H, W, 3) in [-1, 1], a numpy array or a tensor. A chunk runs at
        the size `chunk_frames` gives, padded with its last frame, whose
        outputs are dropped (the JAX package pads the tail chunk to one
        compiled shape)."""
        n = len(images)
        bs = min(batch_size, n)
        pafs, hms = [], []
        with torch.inference_mode():
            for i, size in zip(range(0, n, bs), chunk_frames(n, batch_size)):
                real = min(bs, n - i)
                with span("pose2d.heads", frames=real, padded=size - real):
                    x = torch.as_tensor(images[i:i + bs], dtype=torch.float32, device=self.device)
                    if size > real:
                        x = torch.cat([x, x[-1:].expand(size - real, *x.shape[1:])])
                    paf, hm = self._apply(x * 0.5)
                pafs.append(paf[:real])
                hms.append(hm[:real])
        return torch.cat(pafs), torch.cat(hms)

    def run(self, images):
        """images: (N, H, W, 3) in [-1, 1]. Returns numpy kps (N, 25, 2) NDC,
        scores (N, 25), valid (N, 25)."""
        _, hm = self.heads(images)
        return _numpy(*decode_single_person(hm))

    def run_tracked(self, images, smooth: bool = True):
        """The path for frames that may hold several people: NMS + PAF grouping
        per frame on the host, the largest person, an optional 1-euro filter;
        the argmax decode where grouping finds nobody. Same contract as `run`."""
        n = len(images)
        with span("pose2d.run", frames=n, batches=-(-n // min(BATCH, n))):
            return self.decode_tracked(*self.heads(images), smooth)

    def decode_tracked(self, paf: torch.Tensor, hm: torch.Tensor, smooth: bool = True):
        """The decode of `run_tracked` on the heads that `heads` gave: the
        argmax decode on the device, then per frame on the host NMS, PAF
        grouping and the largest person, and the 1-euro filter over the
        frames in order."""
        from ipercore_tpu_torch.tools.pose2d_decode import (OneEuroFilter, extract_peaks, group_people,
                                                            pick_largest_person)

        with span("pose2d.fetch"):
            kps_a, scores_a, _ = _numpy(*decode_single_person(hm))
            paf_n, hm_n = _numpy(paf, hm)
        h, w = hm_n.shape[1:3]
        out_kps = np.array(kps_a)
        out_scores = np.array(scores_a)
        filt = OneEuroFilter() if smooth else None
        with span("pose2d.decode", frames=len(hm_n)) as s:
            peaks = people = 0
            for i in range(len(hm_n)):
                found = [extract_peaks(hm_n[i][..., j]) for j in range(N_BODY25_JOINTS)]
                grouped = group_people(found, paf_n[i])
                peaks += sum(len(p) for p in found)
                people += len(grouped)
                best = pick_largest_person(grouped)
                if best is not None:
                    px = best["kps"]  # (25, 2) pixel coords, NaN missing
                    ndc = np.stack([(2 * px[:, 0] + 1 - w) / w, (2 * px[:, 1] + 1 - h) / h], axis=1)
                    take = np.isfinite(ndc[:, 0])
                    out_kps[i][take] = ndc[take]
                    out_scores[i][take] = best["scores"][take]
                if filt is not None:
                    out_kps[i] = filt(out_kps[i])
            s.set(peaks=peaks, people=people)
        valid = out_scores > 0.1
        return out_kps.astype(np.float32), out_scores, valid

    def run_tracked_robust(self, images, smooth: bool = True):
        """`run_tracked`, then degenerate-decode recovery: a frame whose
        confident joints have no lateral structure (the flat-heatmap argmax
        fallback, every joint on the crop midline) is retried over scale /
        shift jittered crops, keeping the non-degenerate decode of the best
        mean confidence. Filters first, recovers after, as the JAX package.
        Same contract as `run_tracked` (numpy or a tensor on any device); the
        jittered windows are cut and resized on the host."""
        kps, scores, valid = self.run_tracked(images, smooth=smooth)
        for i in range(len(images)):
            if not _degenerate_decode(kps[i], scores[i] * valid[i]):
                continue
            image = images[i].cpu().numpy() if torch.is_tensor(images[i]) else np.asarray(images[i])
            best = None
            for s, dx, dy in ((0.8, 0.0, 0.0), (1.25, 0.0, 0.0), (0.9, 0.1, 0.0), (0.9, -0.1, 0.0),
                              (1.1, 0.0, 0.1), (1.1, 0.0, -0.1)):
                crop = _affine_window(image, s, dx, dy)
                k1, s1, v1 = self.run_tracked(crop[None], smooth=False)
                k1 = k1[0] * s + np.asarray([dx, dy], np.float32)
                c1 = (s1 * v1)[0]
                if _degenerate_decode(k1, c1):
                    continue
                m = float(c1.mean())
                if best is None or m > best[0]:
                    best = (m, k1, s1[0], v1[0])
            if best is not None:
                kps[i], scores[i], valid[i] = best[1], best[2], best[3]
        return kps, scores, valid


def _degenerate_decode(kps: np.ndarray, conf: np.ndarray, conf_thr: float = 0.3) -> bool:
    """True when a Body-25 decode has no lateral structure: fewer than 4
    confident joints, or their x spread under 0.035 NDC, or their y extent
    under 0.15."""
    sel = conf > conf_thr
    if sel.sum() < 4:
        return True
    x = kps[sel, 0]
    y = kps[sel, 1]
    return bool(x.std() < 0.035 or (y.max() - y.min()) < 0.15)


def _affine_window(image: np.ndarray, s: float, dx: float, dy: float) -> np.ndarray:
    """Resample a square window of NDC side 2*s centred at (dx, dy) back to
    the input resolution (zeros outside), on the host: a point at window NDC
    u maps to image NDC u*s + (dx, dy)."""
    H, W = image.shape[:2]
    x0 = (dx - s + 1.0) * 0.5 * W
    y0 = (dy - s + 1.0) * 0.5 * H
    side_x, side_y = s * W, s * H
    xi, yi = int(round(max(x0, 0))), int(round(max(y0, 0)))
    xj = int(round(min(x0 + side_x, W)))
    yj = int(round(min(y0 + side_y, H)))
    oh, ow = int(round(side_y)), int(round(side_x))
    out = np.zeros((oh, ow) + image.shape[2:], image.dtype)
    dy0, dx0 = yi - int(round(y0)), xi - int(round(x0))
    h = max(0, min(yj - yi, oh - dy0))
    w = max(0, min(xj - xi, ow - dx0))
    out[dy0:dy0 + h, dx0:dx0 + w] = image[yi:yi + h, xi:xi + w]
    return resize_linear(out, (H, W) + image.shape[2:])


# Body-25 -> cocoplus-19 joint mapping; -1 = missing.
BODY25_TO_COCOPLUS19 = np.asarray(
    [11, 10, 9, 12, 13, 14, 4, 3, 2, 5, 6, 7, 1, 0, 17, 15, 18, 16, 8], np.int32)


def body25_to_cocoplus(kps: np.ndarray, scores: np.ndarray):
    """Map Body-25 keypoints to the 19-joint cocoplus convention."""
    m = BODY25_TO_COCOPLUS19
    return kps[..., m, :], scores[..., m]


def build_pose2d_estimator(name: str = "openpose_body25", device="cuda", **kw):
    """"openpose_body25" (the default) or "mobilenet" (the lightweight
    COCO-18 variant)."""
    if name in ("openpose_body25", "openpose", "body25"):
        return OpenPoseRunner(device=device, **kw)
    if name in ("mobilenet", "lightweight"):
        from ipercore_tpu_torch.tools.pose2d_mobilenet import MobilenetOpenPoseRunner

        return MobilenetOpenPoseRunner(device=device, **kw)
    raise KeyError(f"unknown pose2d estimator {name!r}")
