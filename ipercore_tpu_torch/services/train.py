"""The train service: data-parallel LWG-GAN training from scratch or resumed.

Twin of `ipercore_tpu/services/train.py`, line for line, with one process per
device where the JAX package runs one controller over a device mesh:

    python -m ipercore_tpu_torch.services.train --cfg_path cfg.toml [--device cpu]
    torchrun --nproc_per_node=N -m ipercore_tpu_torch.services.train --cfg_path cfg.toml

`batch_size` is per rank (the JAX package's is per device), so the global
batch is `batch_size * world`, and every rank's dataset iterator draws that
global batch from the same seed and decodes its own rows: the samples are the
JAX package's for every world size. The step is
`lwg_trainer.make_sharded_train_step` (one all-reduce of G's and one of D's
gradients a step). Only rank 0 evaluates, logs, writes panels and
checkpoints; every rank loads the checkpoint on resume. Cadences are by wall
clock (`print_freq_s`, `display_freq_s`, `save_latest_freq_s`), compared with
`>` as there; a checkpoint saved at loop index i holds the state after step
i and is named `net_iter_<i>`, so a resumed run repeats index i, and the
dataset iterator starts again from its seed.

`opt.train_name` picks the trainer of `trainers.TRAINER_REGISTRY` (its
aug-bg branch and its generator, unless `opt.gen_name` names another).
Weights: G from `seeded_flat_params(G, 0)`, D from seed 1 (the JAX
package's Flax `PRNGKey` init cannot be reproduced); the VGG from
`Train.vgg_loss_path` (or the shipped file, or seed 2) and the face net from
`Train.face_loss_path` (or seed 3), as `personalize` loads them. Batches
carry only images, smpls, masks and bg into the step, as the JAX service's
do (so `aug_bg` is decoded but not trained on).
"""
from __future__ import annotations

import os
import time
from typing import Optional, Union

import torch

from ipercore_tpu_torch.data.prefetch import prefetch
from ipercore_tpu_torch.parallel import mesh
from ipercore_tpu_torch.services.meta_info import checkpoints_dir
from ipercore_tpu_torch.trainers import lwg_trainer as T
from ipercore_tpu_torch.utils.checkpoint import find_latest_iter, load_train_ckpt, save_train_ckpt
from ipercore_tpu_torch.utils.logging import MetricsLogger

Device = Union[str, torch.device]
STEP_KEYS = ("images", "smpls", "masks", "bg")


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items() if k in STEP_KEYS}


def train(opt, max_iters: Optional[int] = None, device: Device = "cuda") -> dict:
    """Run (or resume) training on `device`; returns the last step's metrics
    as floats. In a process group (`parallel.mesh.init_data_parallel`) every
    rank calls it with its own device."""
    from ipercore_tpu_torch.data import build_dataset
    from ipercore_tpu_torch.models import flow_composition as fc
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.models.networks import build_discriminator, build_generator
    from ipercore_tpu_torch.models.networks import criterions as C
    from ipercore_tpu_torch.trainers import resolve_trainer
    from ipercore_tpu_torch.utils.checkpoint import load_generator_params, seeded_flat_params

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: a CUDA device was asked for and there is none")
    world, rank = mesh.world_size(), mesh.rank()
    S = int(opt.image_size)
    ns = int(opt.num_source)
    nt = int(opt.get("time_step", 2))

    tspec = resolve_trainer(opt.get("train_name", "LWGTrainer"))
    model = smpl_mod.resolve_body_model(opt, device=device)
    assets = load_assets(model, device=device, synthetic=bool(opt.get("smoke_model", False)))
    comp = fc.make_composer(model, assets, image_size=S, out_dilate_ks=int(opt.get("out_dilate_ks", 51)))
    aug_bg = bool(opt.get("aug_bg", tspec["aug_bg"]))
    gen = build_generator(opt.get("gen_name", tspec["default_gen"]), opt.Generator,
                          temporal=bool(opt.get("temporal", False)), num_source=ns, device=device)
    load_generator_params(gen, seeded_flat_params(gen, 0))
    dis = build_discriminator(opt.get("dis_name", "patch_global_body_head"), opt.Discriminator,
                              use_aug_bg=aug_bg, device=device)
    load_generator_params(dis, seeded_flat_params(dis, 1))
    tr = opt.Train
    vgg = C.init_vgg_params(C.build_vgg(str(tr.get("use_vgg", "VGG19")), device=device),
                            weights_path=tr.get("vgg_loss_path"), seed=2)
    face, face_hw = C.init_face_params(str(tr.get("face_loss_path", "sphere20a")), seed=3, device=device)
    cfg = T.TrainConfig(
        lambda_rec=float(tr.lambda_rec), lambda_tsf=float(tr.lambda_tsf),
        lambda_face=float(tr.lambda_face), lambda_mask=float(tr.lambda_mask),
        lambda_mask_smooth=float(tr.lambda_mask_smooth),
        lambda_d_prob=float(tr.lambda_D_prob),
        lr_g=float(tr.lr_G), lr_d=float(tr.lr_D),
        use_face=bool(tr.use_face),
        face_hw=face_hw,
        aug_bg=aug_bg,
        temporal=bool(opt.get("temporal", False)),
        niters_no_decay=int(tr.get("niters_or_epochs_no_decay", 0)),
        niters_decay=int(tr.get("niters_or_epochs_decay", 0)),
        compute_dtype=str(tr.get("compute_dtype", "float32")),
        remat=bool(tr.get("remat", False)),
    )
    scheduled = cfg.niters_decay > 0
    state = T.create_train_state(gen, dis, cfg)

    # resume parameters and both optimizer states, on every rank
    ckpt_dir = checkpoints_dir(opt.output_dir, opt.model_id)
    start_iter, g_path = find_latest_iter(ckpt_dir, "G")
    if g_path:
        state = load_train_ckpt(ckpt_dir, start_iter, state, gen, dis, scheduled=scheduled)

    step_fn = T.make_sharded_train_step(comp, gen, dis, vgg, face, cfg, ns=ns)

    dirs = list(opt.get("dataset_dirs", []))
    ds = build_dataset(opt.get("dataset_mode", "ProcessedVideo"), dataset_dirs=dirs,
                       image_size=S, num_source=ns, time_step=nt)
    # the held-out split (`val.txt` per dataset dir; every video without one)
    try:
        val_ds = build_dataset(opt.get("dataset_mode", "ProcessedVideo"), dataset_dirs=dirs,
                               image_size=S, num_source=ns, time_step=nt, split="val")
    except TypeError:
        val_ds = None
    eval_fn = panel_fn = val_it = None
    if rank == 0 and val_ds is not None and len(val_ds) > 0:
        eval_fn = lambda st, b: T.eval_step(st, b, comp, gen, dis, vgg, face, cfg, ns=ns)
        panel_fn = lambda st, b: T.eval_step(st, b, comp, gen, dis, vgg, face, cfg, ns=ns,
                                             return_images=True)
        # the global validation batch, one row a rank, as the JAX package's
        val_it = val_ds.iterate(batch_size=world, seed=7)
    batch_size = max(int(opt.get("batch_size", 1)), 1)

    # overlap host decode with the device step
    it = prefetch(ds.iterate(batch_size, rank=rank, world=world), depth=int(opt.get("prefetch_depth", 2)))

    logger = MetricsLogger(os.path.join(ckpt_dir, "train_log.jsonl")) if rank == 0 else None
    total = max_iters if max_iters is not None else int(tr.get("total_iters", 400_000))
    save_every_s = float(tr.get("save_latest_freq_s", 300.0))
    print_every_s = float(tr.get("print_freq_s", 30.0))
    display_every_s = float(tr.get("display_freq_s", 300.0))
    last_save = last_print = last_display = time.time()

    # live dashboard: --live_port N serves the loss curves and the panels
    dash = None
    live_port = int(opt.get("live_port", 0) or 0)
    if live_port and rank == 0:
        from ipercore_tpu_torch.utils.live_dashboard import LiveDashboard

        dash = LiveDashboard(os.path.join(ckpt_dir, "train_log.jsonl"),
                             os.path.join(ckpt_dir, "panels"), port=live_port).start()

    metrics = {}
    try:
        for i in range(int(state.step), total):
            batch = next(it)
            state, metrics = step_fn(state, _to_device(batch, device))
            now = time.time()
            if now - last_print > print_every_s:
                if logger is not None:
                    row = {k: float(v) for k, v in metrics.items()}
                    if eval_fn is not None:
                        vm = eval_fn(state, _to_device(next(val_it), device))
                        row.update({k: float(v) for k, v in vm.items()})
                    logger.log(step=i, **row)
                last_print = now
            if panel_fn is not None and now - last_display > display_every_s:
                from ipercore_tpu_torch.utils.visualizer import save_train_panel

                _, imgs = panel_fn(state, _to_device(next(val_it), device))
                save_train_panel(os.path.join(ckpt_dir, "panels", f"panel_iter_{i:08d}.png"),
                                 {k: v.float().cpu().numpy() for k, v in imgs.items()})
                last_display = now
            if now - last_save > save_every_s:
                if rank == 0:
                    save_train_ckpt(ckpt_dir, i, state, gen, dis, scheduled=scheduled)
                last_save = now

        if rank == 0:
            save_train_ckpt(ckpt_dir, total, state, gen, dis, scheduled=scheduled)
    finally:
        if dash is not None:
            dash.stop()
    return {k: float(v) for k, v in metrics.items()}


def main(argv=None):  # pragma: no cover - CLI shim
    """`python -m ipercore_tpu_torch.services.train [--device cpu] ...`, or
    under `torchrun`: joins the process group `torchrun` describes, trains,
    and leaves the group."""
    from ipercore_tpu_torch.services.options import parse_args

    opt = parse_args(argv)
    device = mesh.init_data_parallel(opt.get("device", "cuda"))
    try:
        return train(opt, device=device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":  # pragma: no cover
    main()
