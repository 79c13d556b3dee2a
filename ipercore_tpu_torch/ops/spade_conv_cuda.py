"""Hopper kernel K5, SPADE's 3x3 convolutions: wrapper and plain version.

K5 replaces no TPU kernel (the JAX package left these convolutions to XLA).
It computes the three 3x3 convolutions of `models/networks/blocks.SPADE` as a
float32 implicit GEMM on FFMA, NHWC in and out, in two launches a block
(`csrc/spade_conv.cu`):

  * `spade_conv_relu`: relu(conv3x3(condmap, Conv_0) + bias);
  * `spade_modulate`: Conv_1 and Conv_2 as one GEMM over weights packed with
    interleaved (gamma, beta) columns, and `(x - mean) * rstd * (1 + gamma) +
    beta` in its epilogue, so gamma and beta never reach device memory.

It is bound by operations (float32 FFMA, no TF32), and takes any channel
widths. Weights are packed by `pack_conv3x3` (`SPADE` packs them on every
call). The plain versions run `F.conv2d` on the packed weights with the same epilogue. A wrapper runs its plain version
only for a CPU tensor (or inside `dispatch.force_plain()`); for a CUDA tensor
it launches the kernel or raises, on that tensor's device
(`dispatch.kernel_stream`). Launches are counted as `k5.launches`
(`utils.logging.count`).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ipercore_tpu_torch.ops.dispatch import kernel_stream, use_kernel
from ipercore_tpu_torch.utils import cuda_build
from ipercore_tpu_torch.utils.logging import count


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("spade_conv")
    if not getattr(lib, "_ipercore_ready", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.spade_conv_relu_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.spade_conv_relu_launch.restype = i
        lib.spade_modulate_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.spade_modulate_launch.restype = i
        lib._ipercore_ready = True
    return lib


def pack_conv3x3(weights, biases) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack 3x3 convolutions of one input, each (cout, cin, 3, 3) with a bias
    (cout,), into K5's layout: (9 * cin, n * cout) rows in the order (tap,
    input channel), the n convolutions' output channels interleaved (column
    n * o + i is channel o of convolution i), and the bias in that order."""
    w = torch.stack([wi.detach() for wi in weights], dim=1)  # (cout, n, cin, 3, 3)
    cout, n, cin = w.shape[:3]
    wp = w.reshape(cout * n, cin, 3, 3).permute(2, 3, 1, 0).reshape(9 * cin, cout * n)
    bias = torch.stack([b.detach() for b in biases], dim=1).reshape(cout * n)
    return wp.contiguous(), bias.contiguous()


def _conv_plain(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """conv3x3 of NHWC `x` with packed weights (9 * cin, cout), NHWC out."""
    cin, cout = x.shape[-1], wp.shape[1]
    w = wp.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    return F.conv2d(x.permute(0, 3, 1, 2), w, bias, padding=1).permute(0, 2, 3, 1)


def spade_conv_relu_plain(condmap, wp, bias):
    """Plain version of `spade_conv_relu`."""
    return F.relu(_conv_plain(condmap, wp, bias))


def spade_modulate_plain(actv, wp, bias, x, mean, rstd):
    """Plain version of `spade_modulate`."""
    gb = _conv_plain(actv, wp, bias)
    return (x - mean) * rstd * (1.0 + gb[..., 0::2]) + gb[..., 1::2]


def _check(t: torch.Tensor, name: str, shape: tuple, like: torch.Tensor) -> None:
    if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != like.device:
        raise ValueError(f"{name} must be {shape} float32 on {like.device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _kernel_inputs(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """The tensors dense and 16-byte aligned, copied where they are not."""
    out = [t.contiguous() for t in tensors]
    return [t.clone() if t.data_ptr() % 16 else t for t in out]


def spade_conv_relu(condmap: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(condmap) + bias), zero padding 1, stride 1.

    Args:
        condmap: (N, H, W, cin) float32.
        wp, bias: (9 * cin, cout) and (cout,) from `pack_conv3x3`.

    Returns:
        (N, H, W, cout) float32.
    """
    if condmap.dim() != 4 or condmap.dtype != torch.float32:
        raise ValueError(f"condmap must be (N, H, W, C) float32, got {tuple(condmap.shape)} {condmap.dtype}")
    N, H, W, cin = condmap.shape
    cout = wp.shape[-1]
    _check(wp, "wp", (9 * cin, cout), condmap)
    _check(bias, "bias", (cout,), condmap)
    if not use_kernel(condmap):
        return spade_conv_relu_plain(condmap, wp, bias)
    with kernel_stream(condmap, wp, bias) as stream:
        condmap, wp, bias = _kernel_inputs(condmap, wp, bias)
        out = torch.empty((N, H, W, cout), dtype=torch.float32, device=condmap.device)
        err = _lib().spade_conv_relu_launch(condmap.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                                            out.data_ptr(), N, H, W, cin, cout, stream)
    cuda_build.check_launch(err, "spade_conv_relu")
    count("k5.launches")
    return out


def spade_modulate(actv: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                   mean: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
    """SPADE's output: (x - mean) * rstd * (1 + gamma) + beta, with gamma and
    beta the two 3x3 convolutions of `actv` packed into `wp`.

    Args:
        actv: (N, H, W, cin) float32, the ReLU of `spade_conv_relu`.
        wp, bias: (9 * cin, 2c) and (2c,) from `pack_conv3x3` of the gamma
            and the beta convolutions, in that order.
        x: (N, H, W, c) float32, the modulated feature.
        mean, rstd: (N, 1, 1, c) float32, x's instance-norm statistics
            (`blocks.instance_norm_stats`).

    Returns:
        (N, H, W, c) float32.
    """
    if actv.dim() != 4 or actv.dtype != torch.float32:
        raise ValueError(f"actv must be (N, H, W, C) float32, got {tuple(actv.shape)} {actv.dtype}")
    N, H, W, cin = actv.shape
    c = wp.shape[-1] // 2
    _check(wp, "wp", (9 * cin, 2 * c), actv)
    _check(bias, "bias", (2 * c,), actv)
    _check(x, "x", (N, H, W, c), actv)
    _check(mean, "mean", (N, 1, 1, c), actv)
    _check(rstd, "rstd", (N, 1, 1, c), actv)
    if not use_kernel(actv):
        return spade_modulate_plain(actv, wp, bias, x, mean, rstd)
    with kernel_stream(actv, wp, bias, x, mean, rstd) as stream:
        actv, wp, bias, x, mean, rstd = _kernel_inputs(actv, wp, bias, x, mean, rstd)
        out = torch.empty((N, H, W, c), dtype=torch.float32, device=actv.device)
        err = _lib().spade_modulate_launch(actv.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                                           x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                           out.data_ptr(), N, H, W, cin, c, stream)
    cuda_build.check_launch(err, "spade_modulate")
    count("k5.launches")
    return out
