"""Dataset preparation: preprocessing over a whole tree of raw inputs.

Twin of `scripts/prepare_dataset.py`: every video or image folder under
`--raw_dir` goes through the full preprocessing (`services.preprocess.
preprocess_one`, stages 1.1-1.7, one `Preprocessor` for all) into
`--output_dir/primitives/<name>/processed`; the inputs that come out with
SMPL parameters are split into `train.txt` and `val.txt` (the first
`max(1, int(n * val_frac))` names for validation when there are several).

    python -m ipercore_tpu_torch.scripts.prepare_dataset --raw_dir raw --output_dir dataset [--image_size 512] [--val_frac 0.1] [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from ipercore_tpu_torch.scripts._common import resolve_device


def split(names: list[str], val_frac: float) -> tuple[list[str], list[str]]:
    """(train, val): the first max(1, int(n * val_frac)) names for
    validation when there are at least two."""
    n_val = max(1, int(len(names) * val_frac)) if len(names) > 1 else 0
    return names[n_val:], names[:n_val]


def main(argv=None) -> dict:
    from ipercore_tpu_torch.services.meta_info import SrcMetaInfo
    from ipercore_tpu_torch.services.options import setup
    from ipercore_tpu_torch.services.preprocess import _preprocessor, preprocess_one
    from ipercore_tpu_torch.utils.video import is_video_file

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--raw_dir", required=True, help="folder of videos / image folders")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--val_frac", type=float, default=0.1)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    opt = setup(None, [])
    opt.image_size = args.image_size
    opt.output_dir = args.output_dir
    opt.preproc_smoke = args.smoke
    names, pre = [], None
    for e in sorted(os.listdir(args.raw_dir)):
        path = os.path.join(args.raw_dir, e)
        if not (os.path.isdir(path) or is_video_file(path)):
            continue
        name = os.path.splitext(e)[0]
        print(f"[prepare] {name}", flush=True)
        pre = pre or _preprocessor(opt, device)
        info = preprocess_one(opt, SrcMetaInfo(path=path, name=name), is_src=True, pre=pre, device=device)
        if info.get_array("smpls") is not None:
            names.append(name)

    train, val = split(names, args.val_frac)
    os.makedirs(args.output_dir, exist_ok=True)
    for fname, part in (("train.txt", train), ("val.txt", val)):
        with open(os.path.join(args.output_dir, fname), "w") as f:
            f.write("\n".join(part) + "\n")
    print(f"[prepare] done: {len(train)} train / {len(val)} val", flush=True)
    return {"train": train, "val": val}


if __name__ == "__main__":
    main()
