"""Imitation evaluator: SSIM / PSNR / LPIPS / FID-proxy over two frame directories.

Twin of `scripts/evaluate/eval_imitator.py`: the frames of `--pred_dir` and
`--gt_dir`, sorted by name, the first min(len) pairs (at most
`--max_frames`), each loaded at `--image_size`², scored by
`services.evaluate.evaluate_frames`. Prints one JSON line.

    python -m ipercore_tpu_torch.scripts.evaluate.eval_imitator --pred_dir out/synthesis --gt_dir gt [--image_size 256] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ipercore_tpu_torch.scripts._common import resolve_device


def main(argv=None) -> int:
    from ipercore_tpu_torch.services.evaluate import evaluate_frames
    from ipercore_tpu_torch.utils import video as vid

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--max_frames", type=int, default=500)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    preds = vid.list_frames(args.pred_dir)[: args.max_frames]
    gts = vid.list_frames(args.gt_dir)[: args.max_frames]
    n = min(len(preds), len(gts))
    if n == 0:
        print(json.dumps({"error": "no frames"}))
        return 1
    a = np.stack([vid.load_image(f, size=args.image_size) for f in preds[:n]])
    b = np.stack([vid.load_image(f, size=args.image_size) for f in gts[:n]])
    metrics = evaluate_frames(a, b, device=device)
    metrics["n_frames"] = n
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
