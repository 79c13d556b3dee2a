"""Personalization: fine-tune the generator on the source person.

Twin of `ipercore_tpu/services/personalization.py`: build the LWG train state
from the pretrained generator, loop train steps over batches of the subject's
processed frames, and save `<output_dir>/models/<model_id>/personalized.npz`
with the JAX package's keys and layout, which the imitation stage
(`run_imitator.build_runtime`) then loads. Skips when that file exists.

`opt.gen_name` picks any generator of the registry. Weights without a
pretrain: G from `seeded_flat_params(G, 0)`, as `build_runtime` seeds it; D,
the VGG and the face net from seeds 1, 2 and 3 (the JAX package's Flax
`PRNGKey` init cannot be reproduced). The loss
networks load their shipped checkpoints when they are on disk
(`criterions.init_vgg_params` / `init_face_params`).
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ipercore_tpu_torch.services.meta_info import MetaProcess, checkpoints_dir, parse_src_input
from ipercore_tpu_torch.services.process_info import ProcessInfo
from ipercore_tpu_torch.utils import video as vid

Device = Union[str, torch.device]


def personalized_path(opt) -> str:
    """`<output_dir>/models/<model_id>/personalized.npz`."""
    return os.path.join(checkpoints_dir(opt.output_dir, opt.model_id), "personalized.npz")


def load_pretrained_generator(opt, generator: torch.nn.Module) -> Optional[dict[str, np.ndarray]]:
    """The flat Flax parameters to start G from, or None.

    Candidates in order: `opt.load_path_G`, then
    `<output_dir>/models/pretrains/AttLWB-SPADE_G.npz`, then the repository's
    `assets/lwg_pretrained_G.npz`. A missing file is passed over, and so is a
    `.npz` that does not fit `generator` (missing keys or other shapes). A
    `.pth` / `.pt` (the reference's torch checkpoint, a state dict, or a dict
    holding one under "state_dict") is read with `weights_only=True` and
    converted by `utils.torch_convert.convert_generator` over
    `seeded_flat_params(generator, 0)`: entries it does not name keep their
    seeded values, and their count is printed.
    """
    from ipercore_tpu_torch.utils.checkpoint import (
        WEIGHTS_DIR,
        flax_params_to_torch,
        load_flat_npz,
        seeded_flat_params,
    )
    from ipercore_tpu_torch.utils.torch_convert import convert_generator

    candidates = [
        str(opt.get("load_path_G", "") or ""),
        os.path.join(opt.output_dir, "models", "pretrains", "AttLWB-SPADE_G.npz"),
        os.path.join(WEIGHTS_DIR, "lwg_pretrained_G.npz"),
    ]
    like = generator.state_dict()
    for p in candidates:
        if not p or not os.path.exists(p):
            continue
        if p.endswith(".npz"):
            flat = load_flat_npz(p)
            try:
                flax_params_to_torch(flat, like=like)
            except ValueError as e:
                print(f"[personalize] skip incompatible pretrain {p}: {e}")
                continue
            return flat
        if p.endswith((".pth", ".pt")):
            sd = torch.load(p, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
            flat, report = convert_generator(sd, seeded_flat_params(generator, 0))
            if report:
                print(f"[personalize] {p}: {len(report)} unconverted entries")
            return flat
    return None


def make_personalized_batches(opt, src_meta, rng: np.random.RandomState, n_iters: int):
    """Yield `n_iters` training batches (numpy) from the subject's processed
    frames: the sources are the fixed front / back frames, the targets
    `time_step` random frames, the pseudo-background the processed
    `background.png` (zeros without one)."""
    proc_dir = MetaProcess(src_meta.name, opt.output_dir).processed_dir
    info = ProcessInfo.deserialize(proc_dir)
    S = int(opt.image_size)
    ns = int(opt.num_source)
    nt = int(opt.get("time_step", 1))

    src = info.read_src_info(num_source=ns)
    smpls = np.asarray(info.get_array("smpls"), np.float32)
    n = len(smpls)
    img_dir = os.path.join(proc_dir, "images")
    names = info.meta["valid_img_names"]
    masks_arr = info.get_array("masks")

    def load(i):
        return vid.load_image(os.path.join(img_dir, names[i]), size=S)

    src_ids = src["src_ids"]
    src_imgs = np.stack([load(i) for i in src_ids])
    bg_path = os.path.join(proc_dir, "background.png")
    bg = vid.load_image(bg_path, size=S) if os.path.exists(bg_path) else np.zeros((S, S, 3), np.float32)

    for _ in range(n_iters):
        tgt_ids = rng.randint(0, n, size=nt)
        imgs = np.concatenate([src_imgs, np.stack([load(i) for i in tgt_ids])])[None]
        ids = list(src_ids) + list(tgt_ids)
        if masks_arr is not None:
            m = masks_arr[ids].astype(np.float32)
            masks = (m[..., None] if m.ndim == 3 else m)[None]
        else:
            masks = np.ones((1, ns + nt, S, S, 1), np.float32)
        yield {
            "images": imgs.astype(np.float32),
            "smpls": smpls[ids][None].astype(np.float32),
            "masks": masks,
            "bg": bg[None],
        }


def personalize(opt, device: Device = "cuda") -> str:
    """Fine-tune G for each source subject on `device`; returns the path of
    `personalized.npz` (written, or found and left as it is)."""
    out_path = personalized_path(opt)
    if os.path.exists(out_path):
        return out_path

    from ipercore_tpu_torch.models import flow_composition as fc
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.models.networks import build_discriminator, build_generator
    from ipercore_tpu_torch.models.networks import criterions as C
    from ipercore_tpu_torch.trainers import lwg_trainer as T
    from ipercore_tpu_torch.utils.checkpoint import (
        load_generator_params,
        save_params,
        seeded_flat_params,
        torch_params_to_flax,
    )

    model = smpl_mod.resolve_body_model(opt, device=device)
    assets = load_assets(model, device=device, synthetic=bool(opt.get("smoke_model", False)))
    S = int(opt.image_size)
    comp = fc.make_composer(model, assets, image_size=S, out_dilate_ks=int(opt.get("out_dilate_ks", 51)))
    ns = int(opt.num_source)
    gen = build_generator(opt.get("gen_name", "AttLWB-SPADE"), opt.Generator, num_source=ns, device=device)
    dis = build_discriminator(opt.get("dis_name", "patch_global"), opt.Discriminator, device=device)
    load_generator_params(dis, seeded_flat_params(dis, 1))
    vgg = C.init_vgg_params(C.build_vgg(device=device), seed=2)
    tr = opt.Train
    face, _ = C.init_face_params(str(tr.get("face_loss_path", "sphere20a")), seed=3, device=device)
    cfg = T.TrainConfig(
        lambda_rec=float(tr.lambda_rec), lambda_tsf=float(tr.lambda_tsf),
        lambda_face=float(tr.lambda_face), lambda_mask=float(tr.lambda_mask),
        lambda_mask_smooth=float(tr.lambda_mask_smooth), lambda_d_prob=float(tr.lambda_D_prob),
        lr_g=float(tr.lr_G), lr_d=float(tr.lr_D), use_face=bool(tr.use_face))
    flat_G = load_pretrained_generator(opt, gen)
    load_generator_params(gen, flat_G if flat_G is not None else seeded_flat_params(gen, 0))
    state = T.create_train_state(gen, dis, cfg)

    n_iters = int(tr.get("niters_or_epochs_no_decay", 100)) + int(tr.get("niters_or_epochs_decay", 0))
    rng = np.random.RandomState(0)
    for src_meta in parse_src_input(opt.src_path):
        for batch in make_personalized_batches(opt, src_meta, rng, n_iters):
            batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
            state, _ = T.train_step(state, batch, comp, gen, dis, vgg, face, cfg, ns=ns)

    save_params(out_path, torch_params_to_flax(gen, state.params_G))
    return out_path
