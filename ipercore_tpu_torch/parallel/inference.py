"""Sharded frame synthesis: split the target-frame axis across devices.

Twin of `ipercore_tpu/parallel/inference.py`. Frames are independent given
the SourceCache (non-temporal mode), so inference scales over devices with no
collective in the loop: the composer, the generator and the cache are
replicated, the SMPL batch is split on the frame axis, and each device
rasterizes and generates its slice. One process drives every device, as JAX's
single controller does: CUDA launches are asynchronous per device, so every
device's slice is enqueued before any result is read, and one host thread keeps
them all busy.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from ipercore_tpu_torch.models import flow_composition as fc
from ipercore_tpu_torch.models import imitator as imit
from ipercore_tpu_torch.parallel.mesh import Device, local_devices, pad_to_multiple, replicate


def sharded_synthesize(
    comp: fc.FlowComposer,
    generator,
    cache: imit.SourceCache,
    tgt_smpl: torch.Tensor | np.ndarray,
    devices: Optional[Sequence[Device]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Synthesize frames with the frame axis split over `devices`.

    The generator holds its weights, so there is no `params` argument (as for
    `synthesize_frames`). The frames are padded with the last frame to a
    multiple of `len(devices)` and device k takes the k-th contiguous slice;
    the replicas are made on every call, the ones already on a device reused.

    Args:
        tgt_smpl: (T, 85) prepared target SMPLs (`prepare_target_smpls`).
        devices: the devices to split over (a device may repeat); default all
            visible CUDA devices (`local_devices()`), which raises without one.

    Returns:
        preds (T, S, S, 3), masks (T, S, S, 1) on `devices[0]`, unpadded.
    """
    devices = local_devices() if devices is None else [torch.device(d) for d in devices]
    smpls = torch.as_tensor(tgt_smpl, dtype=torch.float32, device=devices[0])
    smpls, true_t = pad_to_multiple(smpls, len(devices), axis=0)
    per = smpls.shape[0] // len(devices)

    replicas, outs = {}, []
    for k, dev in enumerate(devices):  # enqueue every slice before reading any
        if dev not in replicas:
            replicas[dev] = (replicate(comp, dev), replicate(generator, dev), replicate(cache, dev))
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            outs.append(imit.synthesize_frames(*replicas[dev], smpls[k * per:(k + 1) * per].to(dev)))
    preds = torch.cat([p.to(devices[0]) for p, _ in outs])
    masks = torch.cat([m.to(devices[0]) for _, m in outs])
    return preds[:true_t], masks[:true_t]
