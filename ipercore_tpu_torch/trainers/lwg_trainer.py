"""Liquid-Warping-GAN trainer: one G+D step over explicit state.

Twin of `ipercore_tpu/trainers/lwg_trainer.py` (`TrainConfig`, `_schedule`,
`make_optimizers`, `LWGTrainState`, the keypoint boxes, `create_train_state`,
`_composite`, `train_step`). The JAX package jits one pure function; here the
step is one Python function over an explicit `LWGTrainState` (parameter dicts
in the modules' state-dict layout, both optimizer states, the step count).
The modules only give the structure: their own parameters are not read, the
step runs them through `torch.func.functional_call` and updates nothing in
place.

  * flow composition under `no_grad` (the JAX package's stop_gradient); on a
    CUDA device its rasters go through the `raster_fim` kernel;
  * G loss: rec 10 * (L1(src) + L1(bg)) / 2, tsf 10 * VGG, face 5, adv 1
    (LSGAN, G target 0), mask 5 * BCE, tv 1. D runs with its old parameters
    and takes no gradient (`torch.autograd.grad` with respect to G's). Every
    generator of the registry trains: without BGNet (AttLWB-Front) the real
    background stands in for the predicted one (its L1 is 0); without a
    source stream (InputConcat, TextureWarping: `_norm_gen_outputs`) rec is
    10 * L1(bg) and only the target masks are supervised;
  * D loss on the G forward's output from before G's update, detached:
    LSGAN real = 1, fake = -1;
  * the optimizer is optax's chain clip_by_global_norm(10) -> adam(b1 = 0.5,
    b2 = 0.999, eps = 1e-8) -> apply_if_finite, written over
    `torch._foreach_*` in optax's order (`Adam` below). A step whose
    gradients are not all finite is skipped by `torch.where`, with no host
    sync, and does not advance the Adam count.

`compute_dtype="bfloat16"` runs G and D under autocast over the f32 master
weights; `remat` recomputes the G forward in the backward pass
(`torch.utils.checkpoint`).

`eval_step` is the validation forward (the G losses without an update, and
the panel rows). `make_sharded_train_step` is the data-parallel step: each
rank runs `train_step` on its rows and G's and D's gradients (with the
metrics) are averaged across the ranks by one all-reduce per network before
the optimizer, where the JAX package's pjit inserts its collectives. Every
loss is a mean over the batch and no network holds batch statistics, so the
mean of the ranks' gradients over equal shards is the gradient over the global
batch.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Union

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ipercore_tpu_torch.models import flow_composition as fc
from ipercore_tpu_torch.models.imitator import reference_precision
from ipercore_tpu_torch.models.networks import criterions as C
from ipercore_tpu_torch.utils.logging import span

NECK_IDS = 12  # cocoplus: joints >= 12 are neck / head

Params = dict[str, torch.Tensor]


class TrainConfig(NamedTuple):
    lambda_rec: float = 10.0
    lambda_tsf: float = 10.0
    lambda_face: float = 5.0
    lambda_mask: float = 5.0
    lambda_mask_smooth: float = 1.0
    lambda_d_prob: float = 1.0
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    use_face: bool = True
    # face-net crop size: (112, 96) Sphere20a, (224, 224) SENet-50
    face_hw: tuple = (112, 96)
    use_gan: bool = True
    aug_bg: bool = False
    temporal: bool = False
    # lr constant for `niters_no_decay` steps, then linear to 0 over
    # `niters_decay`; niters_decay = 0 keeps it constant
    niters_no_decay: int = 0
    niters_decay: int = 0
    # "bfloat16": G and D under autocast over f32 master weights and f32
    # losses and optimizer states
    compute_dtype: str = "float32"
    # recompute the G forward in the backward pass
    remat: bool = False
    # global-norm gradient clipping; 0 disables it
    grad_clip: float = 10.0


def _schedule(lr: float, cfg: TrainConfig) -> Union[float, Callable[[torch.Tensor], torch.Tensor]]:
    """The learning rate: constant, or a function of the (int32 tensor) step
    count that holds `lr` until max(niters_no_decay, 1) and then falls
    linearly to 0 over niters_decay steps (optax's join of a constant and a
    linear schedule)."""
    if cfg.niters_decay <= 0:
        return lr
    boundary, steps = max(cfg.niters_no_decay, 1), cfg.niters_decay

    def schedule(count: torch.Tensor) -> torch.Tensor:
        done = (count - boundary).clamp(0, steps).to(torch.float32) / steps
        return torch.where(count < boundary, torch.full_like(done, lr), lr * (1 - done))

    return schedule


class AdamState(NamedTuple):
    """State of clip -> Adam -> apply_if_finite: the Adam count (accepted
    steps), the moments (dicts like the parameters), and apply_if_finite's
    counters. All tensors on the parameters' device."""

    count: torch.Tensor  # int32
    mu: Params
    nu: Params
    notfinite_count: torch.Tensor  # int32, consecutive skipped steps
    last_finite: torch.Tensor  # bool
    total_notfinite: torch.Tensor  # int32


# Adam's constants, and apply_if_finite's limit of consecutive skipped steps
# (100 000: in practice "always skip, never halt")
B1, B2, EPS = 0.5, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 100_000


class Adam(NamedTuple):
    """optax's clip_by_global_norm(grad_clip) -> adam(lr, b1, b2=B2, eps=EPS) ->
    apply_if_finite(MAX_CONSECUTIVE_ERRORS), updates applied. The defaults are
    the trainers' chain; `Adam(lr, grad_clip=0, b1=0.9, skip_nonfinite=False)`
    is a plain `optax.adam(lr)` (no clip, no skipped steps), which the 3D fits
    of preprocessing run.

    `frozen` names parameters the update leaves bit-unchanged, as optax's
    clip -> masked(adam) chain with them masked out is meant to (SPIN's batch
    norm statistics): their gradients still count in the global norm the clip
    reads, and their moments stay zero. (optax 0.2's `masked` passes a
    masked-out gradient through as the update, so `apply_updates` adds it;
    the port does not.) Empty, nothing changes."""

    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]]
    grad_clip: float = 10.0
    b1: float = B1
    skip_nonfinite: bool = True
    frozen: frozenset = frozenset()

    def init(self, params: Params) -> AdamState:
        dev = next(iter(params.values())).device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return AdamState(
            count=zero, mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()}, notfinite_count=zero,
            last_finite=torch.ones((), dtype=torch.bool, device=dev), total_notfinite=zero)

    def apply(self, grads: Params, state: AdamState, params: Params) -> tuple[Params, AdamState]:
        """One update: (new params, new state). Reads nothing back to the host."""
        names = list(params)
        g = [grads[k] for k in names]
        p = [params[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        b1, b2 = self.b1, B2
        one = torch.ones_like(state.count)

        if self.skip_nonfinite:
            # apply_if_finite: every gradient finite (the largest magnitude is
            # NaN or inf otherwise)
            finite = torch.stack(torch._foreach_norm(g, float("inf"))).isfinite().all()
            notfinite_count = torch.where(finite, torch.zeros_like(state.count), state.notfinite_count + one)
            accept = finite | (notfinite_count > MAX_CONSECUTIVE_ERRORS)

        if self.grad_clip and self.grad_clip > 0:
            # clip_by_global_norm: t kept while the norm is below the limit,
            # else (t / norm) * limit
            norm = torch.stack(torch._foreach_norm(g)).square().sum().sqrt()
            keep = norm < self.grad_clip
            g = torch._foreach_div(g, torch.where(keep, torch.ones_like(norm), norm))
            g = torch._foreach_mul(g, torch.where(keep, torch.ones_like(norm),
                                                  torch.full_like(norm, self.grad_clip)))

        # scale_by_adam, in optax's order
        mu_new = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(mu, b1))
        nu_new = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                    torch._foreach_mul(nu, b2))
        count_inc = state.count + one
        mu_hat = torch._foreach_div(mu_new, 1 - b1 ** count_inc.to(torch.float32))
        nu_hat = torch._foreach_div(nu_new, 1 - b2 ** count_inc.to(torch.float32))
        upd = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS))
        # scale_by_learning_rate (a schedule reads the count before this step)
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        upd = torch._foreach_mul(upd, -lr)
        p_new = torch._foreach_add(p, upd)
        if self.frozen:
            keep = [k in self.frozen for k in names]
            pick_kept = lambda new, old: [o if f else n_ for n_, o, f in zip(new, old, keep)]
            p_new, mu_new, nu_new = pick_kept(p_new, p), pick_kept(mu_new, mu), pick_kept(nu_new, nu)

        if not self.skip_nonfinite:
            return dict(zip(names, p_new)), state._replace(
                count=count_inc, mu=dict(zip(names, mu_new)), nu=dict(zip(names, nu_new)))
        pick = lambda new, old: {k: torch.where(accept, a, b) for k, a, b in zip(names, new, old)}
        new_state = AdamState(
            count=torch.where(accept, count_inc, state.count), mu=pick(mu_new, mu), nu=pick(nu_new, nu),
            notfinite_count=notfinite_count, last_finite=finite,
            total_notfinite=torch.where(finite, state.total_notfinite, state.total_notfinite + one))
        return pick(p_new, p), new_state


def make_optimizers(cfg: TrainConfig) -> tuple[Adam, Adam]:
    """The two Adams (b1 = 0.5) with the constant-then-linear lr schedule,
    global-norm clipping and skipping of non-finite steps."""
    return (Adam(_schedule(cfg.lr_g, cfg), grad_clip=cfg.grad_clip),
            Adam(_schedule(cfg.lr_d, cfg), grad_clip=cfg.grad_clip))


class LWGTrainState(NamedTuple):
    params_G: Params
    params_D: Params
    opt_G: AdamState
    opt_D: AdamState
    step: torch.Tensor  # int32


def cal_head_bbox_by_kps(j2d: torch.Tensor) -> torch.Tensor:
    """Head box in NDC from cocoplus j2d (N, 19, 2) in [-1, 1] -> (N, 4) =
    (x0, y0, x1, y1)."""
    head = j2d[:, NECK_IDS:, :]
    box = [head[:, :, 0].amin(1) - 0.1, head[:, :, 1].amin(1) - 0.1,
           head[:, :, 0].amax(1) + 0.1, head[:, :, 1].amax(1) + 0.1]
    return torch.stack([b.clamp(-1.0, 1.0) for b in box], dim=1)


def cal_body_bbox_by_kps(j2d: torch.Tensor, factor: float = 1.2) -> torch.Tensor:
    """Body box in NDC from j2d (N, J, 2), enlarged by `factor` -> (N, 4)."""
    min_x, max_x = j2d[:, :, 0].amin(1), j2d[:, :, 0].amax(1)
    min_y, max_y = j2d[:, :, 1].amin(1), j2d[:, :, 1].amax(1)
    mid_x, w = (min_x + max_x) / 2, (max_x - min_x) * factor
    mid_y, h = (min_y + max_y) / 2, (max_y - min_y) * factor
    box = [mid_x - w / 2, mid_y - h / 2, mid_x + w / 2, mid_y + h / 2]
    return torch.stack([b.clamp(-1.0, 1.0) for b in box], dim=1)


def _params_of(module: torch.nn.Module) -> Params:
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def create_train_state(generator: torch.nn.Module, discriminator: torch.nn.Module,
                       cfg: TrainConfig, params_G: Optional[Params] = None,
                       params_D: Optional[Params] = None) -> LWGTrainState:
    """Parameters (copies of the modules' own unless given) and two fresh
    Adam states."""
    params_G = _params_of(generator) if params_G is None else params_G
    params_D = _params_of(discriminator) if params_D is None else params_D
    tx_g, tx_d = make_optimizers(cfg)
    return LWGTrainState(params_G=params_G, params_D=params_D, opt_G=tx_g.init(params_G),
                         opt_D=tx_d.init(params_D),
                         step=torch.zeros((), dtype=torch.int32, device=next(iter(params_G.values())).device))


def _composite(color, mask, bg):
    return mask * bg + (1.0 - mask) * color


def _norm_gen_outputs(outs):
    """A generator's training outputs as the LWB 5-tuple (bg, src color, src
    mask, tsf color, tsf mask). The baselines (InputConcat / TextureWarping)
    have no source stream and give (bg, tsf color, tsf mask)."""
    if len(outs) == 3:
        bg, tsf_color, tsf_mask = outs
        return bg, None, None, tsf_color, tsf_mask
    return tuple(outs)


def _gen_losses(outs, real_bg, src_img, masks, ns: int, S: int, cfg: TrainConfig, aug_bg=None):
    """The generator's outputs composited, and the terms that need no loss
    network: (fake_tsf_imgs (bs, nt, S, S, 3), fake_bg_b (bs, 1, S, S, 3),
    loss_rec, fake_masks (N, S, S, 1)).

    Without a predicted background (AttLWB-Front) the real one stands in, so
    its reconstruction term is 0; without a source stream (the baselines)
    rec is the background term alone and only the target masks are
    supervised."""
    fake_bg, fake_src_color, fake_src_mask, fake_tsf_color, fake_tsf_mask = _norm_gen_outputs(outs)
    fake_aug_bg = None
    if fake_bg is None:
        fake_bg_b = real_bg[:, None]
    else:
        if aug_bg is not None:  # split off the appended aug sample
            fake_aug_bg, fake_bg = fake_bg[:, -1], fake_bg[:, :-1]
        fake_bg_b = fake_bg[:, 0:1]  # (bs, 1, S, S, 3) shared background
    fake_tsf_imgs = _composite(fake_tsf_color, fake_tsf_mask, fake_bg_b)
    bg_rec = C.l1_loss(fake_bg_b[:, 0], real_bg)
    if fake_aug_bg is not None:
        bg_rec = (bg_rec + C.l1_loss(fake_aug_bg, aug_bg)) / 2.0
    if fake_src_color is not None:
        fake_src_imgs = _composite(fake_src_color, fake_src_mask, fake_bg_b)
        loss_rec = (C.l1_loss(fake_src_imgs, src_img) + bg_rec) / 2.0 * cfg.lambda_rec
        fake_masks, body_masks = torch.cat([fake_src_mask, fake_tsf_mask], dim=1), masks
    else:
        loss_rec = bg_rec * cfg.lambda_rec
        fake_masks, body_masks = fake_tsf_mask, masks[:, ns:]
    loss_mask = C.mask_bce_loss(fake_masks.reshape(-1, S, S, 1), body_masks.reshape(-1, S, S, 1)) * cfg.lambda_mask
    return fake_tsf_imgs, fake_bg_b, loss_rec, loss_mask, fake_masks.reshape(-1, S, S, 1)


def _precision(cfg: TrainConfig, device: torch.device):
    """bf16 autocast for "bfloat16", else nothing (f32; `train_step` turns
    TF32 off around the whole step)."""
    if cfg.compute_dtype == "bfloat16":
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


def train_step(state: LWGTrainState, batch: dict, comp: fc.FlowComposer, generator: torch.nn.Module,
               discriminator: torch.nn.Module, vgg: torch.nn.Module, face: Optional[torch.nn.Module],
               cfg: TrainConfig, ns: int = 2) -> tuple[LWGTrainState, dict[str, torch.Tensor]]:
    """One G+D update.

    Args:
        batch: dict of tensors on the parameters' device:
            images (bs, ns+nt, S, S, 3) in [-1, 1]; smpls (bs, ns+nt, 85);
            masks (bs, ns+nt, S, S, 1) background = 1; bg (bs, S, S, 3) the
            pseudo-background; optional offsets (V, 3), links_ids, aug_bg
            (bs, S, S, 3).
        face: the face net, or None when cfg.use_face is off.
        ns: number of source frames at the start of the frame axis.

    Returns:
        (new state, metrics: 0-dim tensors g_rec, g_tsf, g_face, g_adv,
        g_mask, g_smooth, g_total, d_total).
    """
    with reference_precision():
        return _train_step(state, batch, comp, generator, discriminator, vgg, face, cfg, ns)


Reduce = Callable[[list[torch.Tensor]], list[torch.Tensor]]


def _train_step(state, batch, comp, generator, discriminator, vgg, face, cfg, ns,
                reduce: Optional[Reduce] = None):
    """`train_step`'s body. `reduce`, when given, maps each network's
    gradients followed by its metrics (G: the g_* losses; D: d_total) before
    the optimizer applies them (the data-parallel mean).

    Spans: `train.step` around the step, and inside it in order
    `train.compose`, `train.g_forward` (G and its losses), `train.g_backward`
    (G's gradients, and their `reduce`), `train.g_adam`, and with the GAN
    `train.d_step` (D forward and backward) and `train.d_adam`."""
    with span("train.step"):
        images, smpls, masks = batch["images"], batch["smpls"], batch["masks"]
        bs, nt, S = images.shape[0], images.shape[1] - ns, comp.image_size
        device = images.device
        src_img, ref_img = images[:, :ns], images[:, ns:]

        # flow composition: frozen geometry, no gradient
        with span("train.compose"), torch.no_grad():
            comp_out = fc.forward(comp, src_img, ref_img, smpls[:, :ns], smpls[:, ns:],
                                  src_mask=masks[:, :ns], ref_mask=masks[:, ns:],
                                  links_ids=batch.get("links_ids"), offsets=batch.get("offsets", 0.0),
                                  temporal=cfg.temporal)
        ref_j2d = comp_out["ref_info"]["j2d"]  # (bs*nt, 19, 2)
        head_bbox = cal_head_bbox_by_kps(ref_j2d)
        body_bbox = cal_body_bbox_by_kps(ref_j2d)
        input_G_bg = comp_out["input_G_bg"]

        # aug-bg supervision: the first source's mask pasted on a clean
        # background joins BGNet's inputs, supervised against the clean image
        aug_bg = batch.get("aug_bg") if cfg.aug_bg else None
        if aug_bg is not None:
            src_mask0 = masks[:, 0:1]
            aug_in = torch.cat([aug_bg[:, None] * src_mask0, src_mask0], dim=-1)
            input_G_bg = torch.cat([input_G_bg, aug_in], dim=1)

        real_bg = batch["bg"]
        tsf_cond = comp_out["input_G_tsf"][..., 3:6].reshape(bs * nt, S, S, 3)
        real_tsf = ref_img.reshape(bs * nt, S, S, 3)
        g_inputs = (input_G_bg, comp_out["input_G_src"], comp_out["input_G_tsf"], comp_out["Tst"],
                    comp_out["Ttt"])
        tx_g, tx_d = make_optimizers(cfg)

        def apply_G(params, *inputs):
            with _precision(cfg, device):
                outs = functional_call(generator, params, inputs, {"only_tsf": False})
            return [o.float() if o is not None else None for o in outs]

        def apply_D(params, x):
            with _precision(cfg, device):
                outs = functional_call(discriminator, params, (x, None, body_bbox, head_bbox))
            return [o.float() for o in outs]

        zero = torch.zeros((), device=device)

        # ------------------------------------------------------------------ G
        with span("train.g_forward"):
            params_G = {k: v.detach().requires_grad_() for k, v in state.params_G.items()}
            if cfg.remat:
                outs = checkpoint(apply_G, params_G, *g_inputs, use_reentrant=False)
            else:
                outs = apply_G(params_G, *g_inputs)
            fake_tsf_imgs, _, loss_rec, loss_mask, fake_masks = _gen_losses(
                outs, real_bg, src_img, masks, ns, S, cfg, aug_bg)
            flat_tsf = fake_tsf_imgs.reshape(bs * nt, S, S, 3)

            if cfg.use_gan:  # D with its old parameters, taking no gradient
                d_outs = apply_D(state.params_D, torch.cat([flat_tsf, tsf_cond], dim=-1))
                loss_adv = C.lsgan_loss(d_outs, 0.0) * cfg.lambda_d_prob
            else:
                loss_adv = zero
            loss_tsf = C.perceptual_loss(vgg, flat_tsf, real_tsf) * cfg.lambda_tsf
            if cfg.use_face:
                loss_face = C.face_loss(face, flat_tsf, real_tsf, head_bbox, head_bbox,
                                        hw=cfg.face_hw) * cfg.lambda_face
            else:
                loss_face = zero
            loss_smooth = C.tv_loss(fake_masks) * cfg.lambda_mask_smooth
            total = loss_rec + loss_tsf + loss_face + loss_adv + loss_mask + loss_smooth
        with span("train.g_backward"):
            g_grads = torch.autograd.grad(total, list(params_G.values()))
            metrics = {"g_rec": loss_rec, "g_tsf": loss_tsf, "g_face": loss_face, "g_adv": loss_adv,
                       "g_mask": loss_mask, "g_smooth": loss_smooth, "g_total": total}
            metrics = {k: v.detach() for k, v in metrics.items()}
            if reduce is not None:
                reduced = reduce(list(g_grads) + list(metrics.values()))
                g_grads, metrics = reduced[:len(g_grads)], dict(zip(metrics, reduced[len(g_grads):]))
        with span("train.g_adam"):
            new_params_G, new_opt_G = tx_g.apply(dict(zip(params_G, g_grads)), state.opt_G,
                                                 state.params_G)
        fake_tsf = flat_tsf.detach()
        del outs, fake_tsf_imgs, fake_masks, total

        # ------------------------------------------------------------------ D
        if cfg.use_gan:
            with span("train.d_step"):
                params_D = {k: v.detach().requires_grad_() for k, v in state.params_D.items()}
                d_fake = apply_D(params_D, torch.cat([fake_tsf, tsf_cond], dim=-1))
                d_real = apply_D(params_D, torch.cat([real_tsf, tsf_cond], dim=-1))
                d_total = C.lsgan_loss(d_real, 1.0) + C.lsgan_loss(d_fake, -1.0)
                d_grads = torch.autograd.grad(d_total, list(params_D.values()))
                d_total = d_total.detach()
                if reduce is not None:
                    *d_grads, d_total = reduce(list(d_grads) + [d_total])
            with span("train.d_adam"):
                new_params_D, new_opt_D = tx_d.apply(dict(zip(params_D, d_grads)), state.opt_D,
                                                     state.params_D)
        else:
            d_total, new_params_D, new_opt_D = zero, state.params_D, state.opt_D
        metrics["d_total"] = d_total
        return LWGTrainState(params_G=new_params_G, params_D=new_params_D, opt_G=new_opt_G,
                             opt_D=new_opt_D, step=state.step + 1), metrics


def eval_step(state: LWGTrainState, batch: dict, comp: fc.FlowComposer, generator: torch.nn.Module,
              discriminator: torch.nn.Module, vgg: torch.nn.Module, face: Optional[torch.nn.Module],
              cfg: TrainConfig, ns: int = 2, return_images: bool = False):
    """Validation forward: `train_step`'s G losses (without the smoothness
    term) and no update, on held-out batches.

    Runs under `no_grad` with TF32 off, in f32 as the JAX package's
    `eval_step` (which casts nothing to `compute_dtype`). The composition
    takes neither offsets nor links, as there.

    Returns the metrics val_g_rec, val_g_tsf, val_g_face, val_g_adv,
    val_g_mask, val_g_total (0-dim tensors); with `return_images` also the
    panel rows {src, ref, fake_tsf, fake_bg}, each (bs, S, S, 3): the first
    source, the first target, the first synthesized target, the background.
    """
    with reference_precision(), torch.no_grad():
        images, smpls, masks = batch["images"], batch["smpls"], batch["masks"]
        bs, nt, S = images.shape[0], images.shape[1] - ns, comp.image_size
        src_img, ref_img = images[:, :ns], images[:, ns:]
        comp_out = fc.forward(comp, src_img, ref_img, smpls[:, :ns], smpls[:, ns:],
                              src_mask=masks[:, :ns], ref_mask=masks[:, ns:], temporal=cfg.temporal)
        ref_j2d = comp_out["ref_info"]["j2d"]
        head_bbox = cal_head_bbox_by_kps(ref_j2d)
        body_bbox = cal_body_bbox_by_kps(ref_j2d)
        real_bg = batch["bg"]
        tsf_cond = comp_out["input_G_tsf"][..., 3:6].reshape(bs * nt, S, S, 3)
        real_tsf = ref_img.reshape(bs * nt, S, S, 3)

        outs = functional_call(generator, state.params_G,
                               (comp_out["input_G_bg"], comp_out["input_G_src"], comp_out["input_G_tsf"],
                                comp_out["Tst"], comp_out["Ttt"]), {"only_tsf": False})
        fake_tsf_imgs, fake_bg_b, loss_rec, loss_mask, _ = _gen_losses(
            outs, real_bg, src_img, masks, ns, S, cfg)
        flat_tsf = fake_tsf_imgs.reshape(bs * nt, S, S, 3)
        loss_tsf = C.perceptual_loss(vgg, flat_tsf, real_tsf) * cfg.lambda_tsf
        zero = torch.zeros((), device=images.device)
        if cfg.use_face:
            loss_face = C.face_loss(face, flat_tsf, real_tsf, head_bbox, head_bbox,
                                    hw=cfg.face_hw) * cfg.lambda_face
        else:
            loss_face = zero
        if cfg.use_gan:
            d_outs = functional_call(discriminator, state.params_D,
                                     (torch.cat([flat_tsf, tsf_cond], dim=-1), None, body_bbox, head_bbox))
            loss_adv = C.lsgan_loss(d_outs, 0.0) * cfg.lambda_d_prob
        else:
            loss_adv = zero
        total = loss_rec + loss_tsf + loss_face + loss_adv + loss_mask
        metrics = {"val_g_rec": loss_rec, "val_g_tsf": loss_tsf, "val_g_face": loss_face,
                   "val_g_adv": loss_adv, "val_g_mask": loss_mask, "val_g_total": total}
        if return_images:
            return metrics, {"src": src_img[:, 0], "ref": ref_img[:, 0],
                             "fake_tsf": fake_tsf_imgs[:, 0], "fake_bg": fake_bg_b[:, 0]}
        return metrics


def make_sharded_train_step(comp: fc.FlowComposer, generator: torch.nn.Module,
                            discriminator: torch.nn.Module, vgg: torch.nn.Module,
                            face: Optional[torch.nn.Module], cfg: TrainConfig, ns: int = 2):
    """The data-parallel train step: `step(state, batch) -> (state, metrics)`
    over this rank's rows of the global batch.

    In a process group, G's gradients with the g_* metrics, and D's with
    d_total, are each averaged across the ranks by one all-reduce
    (`parallel.mesh.all_reduce_mean`) before the optimizer, so the
    global-norm clip and the finite check see the averaged gradients and
    every rank applies the same update. Without a group it is `train_step`.
    """
    from ipercore_tpu_torch.parallel import mesh

    if not torch.distributed.is_initialized():
        return lambda state, batch: train_step(state, batch, comp, generator, discriminator, vgg, face,
                                               cfg, ns=ns)

    def step(state, batch):
        with reference_precision():
            return _train_step(state, batch, comp, generator, discriminator, vgg, face, cfg, ns,
                               reduce=mesh.all_reduce_mean)

    return step
