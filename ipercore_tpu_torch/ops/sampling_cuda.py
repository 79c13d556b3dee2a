"""Hopper bilinear grid-sample kernel: wrapper and plain version.

`grid_sample_nhwc` replaces the Pallas TPU kernel `_sample_kernel`
(`ipercore_tpu/ops/sampling_pallas.py`, entry `grid_sample_pallas`): bilinear,
zero-padded, align_corners=False sample of (N, H, W, C) at (N, h, w, 2),
returned in f32. The device code is `csrc/grid_sample.cu`: a direct 4-tap
gather, with a path for the main path's case (one f32 RGB image shared by the
batch, repacked to 4 channels so that a tap is one 16-byte load). The grid is
read and the output written through their pixel strides, so the caller can
hand over the UV flow inside the flows tensor and a channel slice of the
generator's input as `out`. It is bound by memory traffic (image and grid
read once, output written once).

The plain version is explicit floor / 4-tap code with the kernel's arithmetic
order, not `torch.nn.functional.grid_sample`, so it is independent of that
library call. The wrapper runs it only for a CPU tensor (or inside
`dispatch.force_plain()`); for a CUDA tensor it launches the kernel or raises,
on that tensor's device (`dispatch.kernel_stream`).
Its launches are counted as `k2.launches` (`utils.logging.count`).
"""
from __future__ import annotations

import ctypes

import torch

from ipercore_tpu_torch.ops.dispatch import kernel_stream, use_kernel
from ipercore_tpu_torch.utils import cuda_build
from ipercore_tpu_torch.utils.logging import count


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("grid_sample")
    if not getattr(lib, "_ipercore_ready", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        lib.grid_sample_nhwc_launch.argtypes = [p, i, ll, p, ll, p, ll, p, i, i, i, i, i, i, p]
        lib.grid_sample_nhwc_launch.restype = i
        lib._ipercore_ready = True
    return lib


def grid_sample_plain(imgs: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """Plain version: imgs (N, H, W, C) f32/bf16, grids (N, h, w, 2) f32 ->
    (N, h, w, C) f32."""
    N, H, W, C = imgs.shape
    g = grids.float()
    x = (g[..., 0] + 1.0) * (W * 0.5) - 0.5
    y = (g[..., 1] + 1.0) * (H * 0.5) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1

    vx0 = (x0 >= 0) & (x0 <= W - 1)
    vx1 = (x0 >= -1) & (x0 <= W - 2)
    vy0 = (y0 >= 0) & (y0 <= H - 1)
    vy1 = (y0 >= -1) & (y0 <= H - 2)
    # validity is decided on floats; invalid coordinates never become indices
    xi = torch.where(vx0 | vx1, x0, torch.zeros_like(x0)).long()
    yi = torch.where(vy0 | vy1, y0, torch.zeros_like(y0)).long()

    flat = imgs.reshape(N, H * W, C)
    batch = torch.arange(N, device=imgs.device).reshape(N, 1, 1)

    def tap(dy, dx, valid):
        idx = (yi + dy).clamp(0, H - 1) * W + (xi + dx).clamp(0, W - 1)
        t = flat[batch, idx].float()
        return torch.where(valid[..., None], t, torch.zeros_like(t))

    acc = tap(0, 0, vy0 & vx0) * (wy0 * wx0)[..., None] + tap(0, 1, vy0 & vx1) * (wy0 * wx1)[..., None]
    acc = acc + tap(1, 0, vy1 & vx0) * (wy1 * wx0)[..., None]
    return acc + tap(1, 1, vy1 & vx1) * (wy1 * wx1)[..., None]


def _pixel_stride(t: torch.Tensor) -> int | None:
    """Elements from one pixel of the (N, h, w, c) view `t` to the next, when
    its pixels lie at one stride with their channels dense; else None."""
    N, h, w, c = t.shape
    ps = t.stride(2) if w > 1 else c
    if t.stride(3) != 1 and c > 1:
        return None
    if (h > 1 and t.stride(1) != w * ps) or (N > 1 and t.stride(0) != h * w * ps):
        return None
    return ps


def grid_sample_nhwc(imgs: torch.Tensor, grids: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear, zero-padded, align_corners=False sample.

    Args:
        imgs: (N, H, W, C) float32 or bfloat16; grids: (N, h, w, 2) float32
            with (x, y) in [-1, 1]; any h x w. The grid may be a view whose
            pixels lie at one stride (e.g. `flows[..., 0, :]` of a dense
            (N, h, w, J, 2) tensor).
        out: optional (N, h, w, C) float32 view to write into, its pixels at
            one stride with dense channels (e.g. `x[..., :C]` of a dense
            (N, h, w, C') tensor).

    Returns:
        (N, h, w, C) float32: `out` when given.
    """
    if imgs.dim() != 4 or grids.dim() != 4 or grids.shape[-1] != 2 or grids.shape[0] != imgs.shape[0]:
        raise ValueError(f"expected imgs (N, H, W, C) and grids (N, h, w, 2); got "
                         f"{tuple(imgs.shape)} and {tuple(grids.shape)}")
    if imgs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"imgs must be float32 or bfloat16, got {imgs.dtype}")
    if grids.dtype != torch.float32 or grids.device != imgs.device:
        raise TypeError("grids must be float32 on the device of imgs")
    N, H, W, C = imgs.shape
    h, w = grids.shape[1], grids.shape[2]
    if out is not None:
        if tuple(out.shape) != (N, h, w, C) or out.dtype != torch.float32 or out.device != imgs.device:
            raise ValueError(f"out must be ({N}, {h}, {w}, {C}) float32 on the device of imgs, got "
                             f"{tuple(out.shape)} {out.dtype}")

    if not use_kernel(imgs):
        res = grid_sample_plain(imgs, grids)
        return res if out is None else out.copy_(res)

    out_ps = None if out is None else _pixel_stride(out)
    if out is not None and out_ps is None:
        raise ValueError(f"out must have its pixels at one stride, got strides {out.stride()}")
    with kernel_stream(imgs, grids) as stream:
        if out is None:
            out = torch.empty((N, h, w, C), dtype=torch.float32, device=imgs.device)
            out_ps = C
        grid_ps = _pixel_stride(grids)
        if grid_ps is None or grid_ps % 2 or grids.data_ptr() % 8:
            grids, grid_ps = grids.contiguous(), 2
        # one image broadcast over the batch (`expand`) is read in place, stride 0
        shared = N == 1 or imgs.stride(0) == 0
        if not shared:
            imgs = imgs.contiguous()
        elif imgs.stride()[1:] != (W * C, C, 1):
            imgs = imgs[:1].contiguous().expand(N, H, W, C)
        # the rgb4 path: a shared f32 RGB image, repacked to 4 channels per call
        img4 = (torch.empty((H * W, 4), dtype=torch.float32, device=imgs.device)
                if shared and C == 3 and imgs.dtype == torch.float32 else None)
        err = _lib().grid_sample_nhwc_launch(
            imgs.data_ptr(), int(imgs.dtype == torch.bfloat16), 0 if shared else H * W * C,
            grids.data_ptr(), grid_ps, out.data_ptr(), out_ps,
            None if img4 is None else img4.data_ptr(), N, H, W, C, h, w, stream)
    cuda_build.check_launch(err, "grid_sample_nhwc")
    count("k2.launches")
    return out
