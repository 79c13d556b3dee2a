"""Device and process-group helpers: the port's counterpart of
`ipercore_tpu/parallel/mesh.py`.

The JAX package runs one controller over a 1-D device mesh. For training it
lets pjit insert the gradient all-reduce; here each device is one process
(`torchrun --nproc_per_node=N`), joined in a `torch.distributed` process
group: `init_data_parallel` joins it, `world_size` / `rank` read it (1 / 0
without a group), and `all_reduce_mean` averages a list of tensors across the
ranks in one collective. For inference one process drives every device, as
JAX's controller does: `local_devices` lists them (`make_mesh`), `replicate`
puts a copy of the weights and tables on one of them (`replicate` /
`shard_batch`), and `pad_to_multiple` evens the frame axis out.
"""
from __future__ import annotations

import copy
import itertools
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


def local_devices(n: Optional[int] = None, device: Device = "cuda") -> list[torch.device]:
    """The first `n` (default: all) visible CUDA devices, `cuda:0` first: the
    counterpart of `make_mesh`. Raises when no CUDA device is visible or fewer
    than `n` are. With `device="cpu"` the CPU is given `n` times (default
    once), as JAX gives its virtual CPU devices: for tests and rehearsals."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (1 if n is None else n)
    if kind != "cuda":
        raise ValueError(f"local_devices: no devices of type {kind}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("local_devices: no CUDA device is visible")
    if n is not None and not 0 < n <= count:
        raise ValueError(f"local_devices: {n} devices asked for, {count} visible")
    return [torch.device("cuda", i) for i in range(count if n is None else n)]


def _same_device(a: torch.device, b: torch.device) -> bool:
    index = lambda d: torch.cuda.current_device() if d.type == "cuda" and d.index is None else d.index
    return a.type == b.type and (a.type != "cuda" or index(a) == index(b))


def _module_on(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """A deep copy of `module` whose parameters and buffers are made on
    `device` straight from the originals: each crosses once, and the source
    device holds no second copy."""
    memo = {}
    for x in itertools.chain(module.parameters(), module.buffers()):
        if id(x) not in memo:
            moved = x.detach().to(device, copy=True)
            memo[id(x)] = torch.nn.Parameter(moved, x.requires_grad) if isinstance(x, torch.nn.Parameter) else moved
    return copy.deepcopy(module, memo)


def replicate(tree, device: Device):
    """A copy of `tree` on `device`: a tensor, an `nn.Module` (its parameters
    and buffers copied to `device`, the rest deep-copied) or a tuple or
    `NamedTuple` of them (`FlowComposer`, `SourceCache`, `MeshAssets`,
    `SMPLModel`); other leaves (ints, numpy arrays) are shared. Where nothing
    needs to move, the object itself is returned."""
    device = torch.device(device)
    if isinstance(tree, torch.Tensor):
        return tree if _same_device(tree.device, device) else tree.to(device)
    if isinstance(tree, torch.nn.Module):
        first = next(itertools.chain(tree.parameters(), tree.buffers()), None)
        if first is None or _same_device(first.device, device):
            return tree
        return _module_on(tree, device)
    if isinstance(tree, tuple):
        items = [replicate(x, device) for x in tree]
        if all(a is b for a, b in zip(items, tree)):
            return tree
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree
