"""Kernel dispatch for the port: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the kernel's plain PyTorch version.

This replaces the JAX package's backend tests (`rasterizer._use_pallas`,
`sampling_pallas.use_pallas_sampling`). `force_plain()` exists for one
purpose: a check that runs the plain versions on the GPU to hold the kernels
against them end to end. `kernel_stream()` is where every hand-written
kernel is launched: on its inputs' device, whichever device is current.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_force_plain = False


def use_kernel(t: torch.Tensor) -> bool:
    """True when a wrapper given `t` must launch its CUDA kernel."""
    return t.is_cuda and not _force_plain


@contextlib.contextmanager
def kernel_stream(*tensors: torch.Tensor) -> Iterator[int]:
    """Make the tensors' device current inside the block and yield the handle
    of that device's current stream, for a ctypes launch and the scratch
    tensors it needs. The CUDA runtime launches on the calling thread's
    current device, so without this a tensor on `cuda:1` would be handed to a
    kernel and a stream of `cuda:0`. Raises when the tensors lie on more than
    one device."""
    dev = tensors[0].device
    other = [t.device for t in tensors[1:] if t.device != dev]
    if other:
        raise ValueError(f"a kernel's inputs lie on {dev} and {other[0]}")
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


@contextlib.contextmanager
def force_plain():
    """Within the block every wrapper runs its plain version, also on CUDA
    tensors. For comparison runs only."""
    global _force_plain
    prev = _force_plain
    _force_plain = True
    try:
        yield
    finally:
        _force_plain = prev
