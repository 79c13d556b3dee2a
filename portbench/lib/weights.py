"""Seeded weights made on the device, in the layout of a module's state dict.

One normal draw of every parameter at once on a `torch.Generator` of the
device, then cut into the state dict: a convolution's kernel is scaled by
1 / sqrt(fan_in) (its input channels times its kernel area), which keeps the
activations at unit scale through the depth of the generators; a bias takes
1 / 100 of the draw. Because the draw depends on the seed and the state
dict's names and shapes alone, the program and the reference get the same
weights from the same seed.
"""
from __future__ import annotations

import torch
import torch.nn as nn


def _fan_in(module: nn.Module, key: str, shape: tuple) -> int | None:
    """Fan-in of a convolution kernel (None for a vector)."""
    if len(shape) < 2:
        return None
    owner = module.get_submodule(key.rsplit(".", 1)[0]) if "." in key else module
    if isinstance(owner, nn.ConvTranspose2d):  # (I, O, kh, kw)
        return shape[0] * shape[2] * shape[3]
    n = 1
    for s in shape[1:]:
        n *= s
    return n


def seeded_state_dict(module: nn.Module, seed: int, device) -> dict:
    """{name: tensor} for every entry of `module.state_dict()`, drawn on `device`."""
    entries = sorted((k, tuple(v.shape)) for k, v in module.state_dict().items())
    total = sum(torch.Size(s).numel() for _, s in entries)
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, s in entries:
        n = torch.Size(s).numel()
        fan = _fan_in(module, k, s)
        scale = 0.01 if fan is None else fan ** -0.5
        out[k] = (flat[at:at + n] * scale).reshape(s)
        at += n
    return out
