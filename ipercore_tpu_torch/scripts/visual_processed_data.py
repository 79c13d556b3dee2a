"""Inspect a processed dataset: the flow-composition inputs as PNG grids.

Twin of `scripts/visual_processed_data.py`. For each of `--num_batches`
batches of `build_dataset("ProcessedVideo")` (batch 1), the training
composition (`flow_composition.forward`: K3 for the sources and for the
targets) writes one row per sample, src | target | UV image | the
transfer condition | the masked source, to `<out_dir>/batch_<b>.png`, so a
dataset written by `services.preprocess` can be looked at before training.

    python -m ipercore_tpu_torch.scripts.visual_processed_data --dataset_dir root [--out_dir ./inspect_processed] [--num_batches 4] [--image_size 256] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ipercore_tpu_torch.scripts._common import resolve_device


def grid_row(images: torch.Tensor, out: dict, ns: int) -> list[np.ndarray]:
    """src | target | uv image | tsf condition | masked src of sample 0."""
    n = lambda x: x.detach().cpu().numpy()
    src = n(images[0, 0])
    uv = n(out["uv_img"][0]) if "uv_img" in out else np.zeros_like(src)
    return [src, n(images[0, ns]), uv, n(out["input_G_tsf"][0, 0, ..., 3:6]), n(out["input_G_bg"][0, 0, ..., :3])]


def main(argv=None) -> int:
    from ipercore_tpu_torch.data import build_dataset
    from ipercore_tpu_torch.models import flow_composition as fc
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.utils import video as vid

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset_dir", required=True, nargs="+")
    ap.add_argument("--out_dir", default="./inspect_processed")
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--num_source", type=int, default=2)
    ap.add_argument("--time_step", type=int, default=2)
    ap.add_argument("--num_batches", type=int, default=4)
    ap.add_argument("--smoke_model", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    S, ns = args.image_size, args.num_source
    model = (smpl_mod.synthetic_model(nu=20, nv=18, device=device) if args.smoke_model
             else smpl_mod.resolve_body_model(None, device=device))
    comp = fc.make_composer(model, load_assets(model, device=device), image_size=S, out_dilate_ks=11)
    ds = build_dataset("ProcessedVideo", dataset_dirs=args.dataset_dir, image_size=S, num_source=ns,
                       time_step=args.time_step)
    if len(ds) == 0:
        print("no processed videos found under", args.dataset_dir)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    it = ds.iterate(batch_size=1)
    for b in range(args.num_batches):
        batch = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in next(it).items()
                 if k in ("images", "smpls", "masks")}
        images, smpls, masks = batch["images"], batch["smpls"], batch["masks"]
        with torch.no_grad():
            out = fc.forward(comp, images[:, :ns], images[:, ns:], smpls[:, :ns], smpls[:, ns:],
                             src_mask=masks[:, :ns], ref_mask=masks[:, ns:])
        path = os.path.join(args.out_dir, f"batch_{b:03d}.png")
        vid.save_image(path, vid.fuse_side_by_side([grid_row(images, out, ns)]))
        print("wrote", path)
    print("inspection grids in", args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
