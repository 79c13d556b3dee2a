"""Process-group helpers: the port's counterpart of `ipercore_tpu/parallel/mesh.py`.

The JAX package runs one controller over a 1-D device mesh and lets pjit
insert the gradient all-reduce. Here each device is one process (`torchrun
--nproc_per_node=N`), joined in a `torch.distributed` process group:
`init_data_parallel` joins it, `world_size` / `rank` read it (1 / 0 without a
group), and `all_reduce_mean` averages a list of tensors across the ranks in
one collective.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

Device = Union[str, torch.device]


def init_data_parallel(device: Device = "cuda", init_method: Optional[str] = None) -> torch.device:
    """Join the process group that `torchrun` describes and return the device
    this rank runs on.

    Reads `RANK`, `WORLD_SIZE` and `LOCAL_RANK`. With `WORLD_SIZE` unset or 1
    and no `init_method`, no group is needed and none is made. Otherwise the
    group is joined through `init_method` (default "env://", which reads
    `MASTER_ADDR` / `MASTER_PORT`), with NCCL for a CUDA device and gloo for a
    CPU device: the backend follows the device asked for. A CUDA rank runs on
    `cuda:<LOCAL_RANK>`.
    """
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank_ = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank_)))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_data_parallel: a CUDA device was asked for and there is none")
        device = torch.device("cuda", local if device.index is None else device.index)
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"init_data_parallel: no backend for device {device}")
    if world == 1 and init_method is None:
        return device
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=init_method or "env://", world_size=world, rank=rank_)
    return device


def world_size() -> int:
    """Ranks in the process group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def all_reduce_mean(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The mean of each tensor over the ranks, by one all-reduce (SUM, then
    divided by the world size) of one flat buffer. Counts its calls in
    `all_reduce_mean.calls`."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    all_reduce_mean.calls += 1
    flat = flat / dist.get_world_size()
    return [part.reshape(t.shape) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


all_reduce_mean.calls = 0


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0) -> tuple[torch.Tensor, int]:
    """Pad an axis up to a multiple by repeating its last entry (frames must
    divide the ranks): (padded, original length)."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    last = x.narrow(axis, n - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = target - n
    return torch.cat([x, last.repeat(*reps)], dim=axis), n
