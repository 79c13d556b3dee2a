"""What the training drivers share: the device, the optimizer chains, seeded
starting weights, one update, the f16 save and optax's cross-entropies.

The JAX drivers build their optimizers from optax; the port's optax twin is
`trainers/lwg_trainer.Adam`:

  * `clip_by_global_norm(1.0)` -> `adam(lr)` (`train_openpose.py:252`,
    `train_faceloss.py:166`): `adam(lr, clip=1.0)`;
  * `adam(lr)` (`train_vgg.py:120`, `train_person_seg.py:257`): `adam(lr)`;
  * `clip_by_global_norm(1.0)` -> `masked(adam(lr), mask)` with the batch
    norms' `mean` / `var` masked out (`train_spin.py:164-174`):
    `adam(lr, clip=1.0, frozen=...)`.

Flax seeds each `net.init` with its own `PRNGKey`, which cannot be reproduced
without JAX, so a driver starts its networks from `seeded_flat_params(net,
seed)` with the seed the port names for that network (`SEEDS`).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Iterable

import numpy as np
import torch
import torch.nn.functional as F

from ipercore_tpu_torch.trainers.lwg_trainer import Adam, AdamState
from ipercore_tpu_torch.utils.checkpoint import (WEIGHTS_DIR, load_generator_params, save_params,
                                                 seeded_flat_params)

# the checkout's root: the drivers' default checkpoint directories lie under it
REPO_DIR = os.path.dirname(WEIGHTS_DIR)

# starting weights of each trained network (the networks' own seeds where the
# port has one: `pose2d.OPENPOSE_SEED`, `mattors.PERSON_SEG_SEED` / `MATTING_SEED`,
# `pose3d.SPIN_SEED`, `criterions.init_vgg_params` / `init_face_params`,
# `parsers.SCHP_SEED`, `inpaintors.INPAINT_SEED` / `REFINE_SEED` / `SR_SEED`)
SEEDS = {"G": 0, "D": 1, "vgg": 2, "face": 3, "openpose": 4, "person_seg": 5, "mobilenet": 6,
         "spin": 7, "matting": 8, "schp": 9, "inpaintor": 10, "inpaintor_refine": 11, "esrgan": 12}


def resolve_device(name: str | torch.device) -> torch.device:
    """The training device: `cuda` unless the caller asks for the CPU. A CUDA
    device without a card raises: no driver falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch sees no CUDA device "
                           "(pass --device cpu to train on the CPU)")
    return device


def smoke_out(path: str, smoke: bool) -> str:
    """A smoke run never overwrites the repository's weights: an output under
    `assets/` goes to `<temp dir>/<name>_smoke.npz` instead."""
    if smoke and os.path.abspath(path).startswith(WEIGHTS_DIR + os.sep):
        return os.path.join(tempfile.gettempdir(),
                            os.path.basename(path).replace(".npz", "_smoke.npz"))
    return path


def adam(lr: float, clip: float = 0.0, frozen: Iterable[str] = ()) -> Adam:
    """optax's `adam(lr)` (b1 0.9, b2 0.999, eps 1e-8), behind
    `clip_by_global_norm(clip)` when clip > 0, with `frozen` masked out."""
    return Adam(lr, grad_clip=clip, b1=0.9, skip_nonfinite=False, frozen=frozenset(frozen))


def seeded(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """`net` with `seeded_flat_params(net, seed)` loaded in place."""
    load_generator_params(net, seeded_flat_params(net, seed))
    return net


def params_of(net: torch.nn.Module) -> dict[str, torch.Tensor]:
    return dict(net.named_parameters())


def init_state(tx: Adam, net: torch.nn.Module) -> AdamState:
    return tx.init({k: v.detach() for k, v in net.named_parameters()})


def grads_of(net: torch.nn.Module, loss: torch.Tensor) -> dict[str, torch.Tensor]:
    """d loss / d every parameter of `net`; zeros for a parameter the loss
    does not reach (a head the forward leaves out), as `jax.grad` gives."""
    params = params_of(net)
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                                materialize_grads=True)))


def update(net: torch.nn.Module, tx: Adam, opt_state: AdamState, loss: torch.Tensor) -> AdamState:
    """One optimizer step on `loss`: the gradients of every parameter, `tx`'s
    update, written into `net`'s parameters in place. Reads nothing back to
    the host."""
    params = params_of(net)
    grads = grads_of(net, loss)
    new, opt_state = tx.apply(grads, opt_state, {k: v.detach() for k, v in params.items()})
    with torch.no_grad():
        torch._foreach_copy_([params[k] for k in params], [new[k] for k in params])
    return opt_state


def f16(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """f32 arrays cast to f16, others as they are (the drivers' save)."""
    return {k: np.asarray(v, np.float16) if np.asarray(v).dtype == np.float32 else np.asarray(v)
            for k, v in flat.items()}


def save_f16(path: str, flat: dict[str, np.ndarray]) -> str:
    """Write flat Flax-layout parameters as f16 `.npz` (`save_params`)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_params(path, f16(flat))
    return path


def log(record: dict, digits: int = 4) -> None:
    """One JSON line, numbers rounded as the JAX drivers print them."""
    out = {k: (round(float(v), digits) if isinstance(v, (float, torch.Tensor, np.floating)) else v)
           for k, v in record.items()}
    print(json.dumps(out), flush=True)


# --- optax's cross-entropies ----------------------------------------------------

def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """`optax.sigmoid_binary_cross_entropy`, elementwise."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """`optax.softmax_cross_entropy` over the last axis."""
    return -(labels * torch.log_softmax(logits, dim=-1)).sum(-1)


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """`optax.softmax_cross_entropy_with_integer_labels` over the last axis:
    log-sum-exp of the max-shifted logits (the max taking no gradient) minus
    the label's shifted logit."""
    shifted = logits - logits.amax(-1, keepdim=True).detach()
    label_logits = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    return torch.log(torch.exp(shifted).sum(-1)) - label_logits


def box_down4(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/4, W/4, C): the mean of each 4x4 block
    (`jax.lax.reduce_window(x, 0, add, (1, 4, 4, 1), (1, 4, 4, 1), "VALID") / 16`)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)


def pool_chunks(render, draws, pool: int, batch: int) -> torch.Tensor:
    """A pre-rendered pool: `render(draws)` of `batch` items, called until
    max(pool, batch) items exist, concatenated and cut to that count (the
    JAX drivers' pools; one chunk per split key there)."""
    n = max(pool, batch)
    return torch.cat([render(draws) for _ in range(-(-n // batch))])[:n]


def roll_each(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """`vmap(jnp.roll(im, s, axis=(0, 1)))`: each (H, W, ...) item of `x`
    rolled by its own (dy, dx) of `shift` (B, 2), with no host sync."""
    b, h, w = x.shape[:3]
    rows = (torch.arange(h, device=x.device)[None, :] - shift[:, 0:1]) % h  # (B, H)
    cols = (torch.arange(w, device=x.device)[None, :] - shift[:, 1:2]) % w  # (B, W)
    bi = torch.arange(b, device=x.device)[:, None, None]
    return x[bi, rows[:, :, None], cols[:, None, :]]

