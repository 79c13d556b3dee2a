"""The yardstick: the chip's published peaks, the operations and bytes that a
kernel call needs, and the nominal operations of the networks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full 700 W):
3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores, 495 TFLOP/s
in TF32 on the tensor cores. A kernel's roofline share is the least time the
chip could take for the call (operations over the float32 peak or bytes over
the bandwidth, whichever is larger) over the call's device time. The whole
step's share (`mfu`) is its nominal operations over the window over the TF32
tensor-core peak: cuDNN's float32 Winograd and FFT algorithms do fewer
operations than the nominal count, so a share of the 67 TFLOP/s peak could
pass 100 % without any fault.
"""
from __future__ import annotations

import torch
import torch.nn as nn

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12


def bound_s(bytes_moved: float, flops: float) -> float:
    """Least seconds for a call: the larger of its bytes at the bandwidth and
    its operations at the float32 peak."""
    return max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def raster_flops(face_verts: torch.Tensor, size: int, n_out_floats: int) -> float:
    """Float32 operations a raster needs for these faces, whatever its tiling:
    every (pixel, valid face) pair whose guarded box (+- 2/S) covers the pixel
    pays 30 (three barycentrics, the inside test, depth, depth test, compare);
    every output float is a 5-operation blend."""
    from portbench.reference.geometry import face_bary, face_bbox

    _, valid = face_bary(face_verts)
    box = face_bbox(face_verts)[valid].double()
    eps = 2.0 / size

    def covered(lo, hi):
        i0 = torch.ceil(((lo - eps) * size + size - 1) / 2).clamp(min=0)
        i1 = torch.floor(((hi + eps) * size + size - 1) / 2).clamp(max=size - 1)
        return (i1 - i0 + 1).clamp(min=0)

    return float((covered(box[:, 0], box[:, 1]) * covered(box[:, 2], box[:, 3])).sum()) * 30 \
        + n_out_floats * 5


def raster_flows_bound_s(face_verts: torch.Tensor, size: int, n_flows: int) -> float:
    """K1 (`raster_flows`) on (T, F, 3, 3) faces with n_flows flow sets: read
    the faces and the flow sources (n_flows, F, 3, 2), write fim (T, S, S) i32
    and the flows (T, S, S, n_flows, 2) f32."""
    T, F_ = face_verts.shape[0], face_verts.shape[1]
    n_out = T * size * size * n_flows * 2
    moved = 4 * (face_verts.numel() + n_flows * F_ * 6 + T * size * size + n_out)
    return bound_s(moved, raster_flops(face_verts, size, n_out))


def raster_fim_bound_s(face_verts: torch.Tensor, size: int) -> float:
    """K3 (`raster_fim`): read the faces, write fim (N, S, S) i32 and wim (N, S, S, 3)."""
    N = face_verts.shape[0]
    n_out = N * size * size * 3
    return bound_s(4 * (face_verts.numel() + N * size * size + n_out),
                   raster_flops(face_verts, size, n_out))


def grid_sample_bound_s(n: int, h_in: int, w_in: int, c: int, h: int, w: int,
                        shared_image: bool = True) -> float:
    """K2 (`grid_sample_nhwc`): read the image (once when the batch shares it)
    and the grid (n, h, w, 2), write (n, h, w, c); 8 operations per output
    float and 6 per grid coordinate."""
    image = (1 if shared_image else n) * h_in * w_in * c
    grid, out = n * h * w * 2, n * h * w * c
    return bound_s(4 * (image + grid + out), out * 8 + grid * 6)


def count_flops(module: nn.Module, fn) -> float:
    """Nominal operations (2 per multiply-add) of the convolutions,
    transposed convolutions and matrix products that `fn()` runs in `module`,
    counted by forward hooks from the layers' shapes. Attention over the
    source axis counts its two products (a module with a `c` width and a
    `fk` key convolution is taken as one)."""
    total = [0.0]

    def conv_hook(m, inp, out):
        k = m.weight.shape  # Conv2d (O, I/g, kh, kw); ConvTranspose2d (I, O/g, kh, kw)
        if isinstance(m, nn.ConvTranspose2d):
            x = inp[0]
            total[0] += 2.0 * x.numel() * k[1] * k[2] * k[3]
        else:
            total[0] += 2.0 * out.numel() * k[1] * k[2] * k[3]

    def attention_hook(m, inp, out):
        x, src = inp[0], inp[1]  # (bs, h, w, c), (bs, ns, h, w, c')
        bs, ns, h, w = src.shape[:4]
        total[0] += 2 * (2.0 * bs * ns * h * w * m.c)

    handles = []
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            handles.append(m.register_forward_hook(conv_hook))
        elif hasattr(m, "fk") and hasattr(m, "c"):
            handles.append(m.register_forward_hook(attention_hook))
    try:
        with torch.no_grad():
            fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]
