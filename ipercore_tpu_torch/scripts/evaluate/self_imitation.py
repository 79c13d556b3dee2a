"""The iPER self-imitation protocol on the reference's sample clip.

Twin of `scripts/evaluate/self_imitation.py`. Source and ground truth come
from one video: frames 0 and 90 of `akun_1.mp4` (from
`$IPERCORE_REFERENCE_SAMPLES/references/`, extracted into
`eval_real_photos.FRAME_DIR`) are the source; the three-stage `run_imitator`
(preprocess, personalize, imitate) imitates the clip's own motion, and the
synthesized frames are scored against the reference's processed crops
(`services.evaluate.evaluate_frames`, at `--eval_size`²). Writes
`<out_dir>/self_imitation_<arm>.json` and prints it. Without the clip it
prints one line saying so and exits 1.

    python -m ipercore_tpu_torch.scripts.evaluate.self_imitation [--image_size 512] [--out_dir .cache/self_imitation] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import time

import numpy as np

from ipercore_tpu_torch.scripts import eval_real_photos as real
from ipercore_tpu_torch.scripts._common import REPO_DIR, resolve_device

SOURCE_FRAMES = (0, 90)  # a frontal frame and a turned one


def main(argv=None) -> int:
    from ipercore_tpu_torch.services import options
    from ipercore_tpu_torch.services.evaluate import evaluate_frames
    from ipercore_tpu_torch.services.run_imitator import run_imitator
    from ipercore_tpu_torch.utils import video as vid

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image_size", type=int, default=512)
    ap.add_argument("--num_source", type=int, default=2)
    ap.add_argument("--out_dir", type=str, default=os.path.join(REPO_DIR, ".cache", "self_imitation"))
    ap.add_argument("--eval_size", type=int, default=256, help="resolution metrics are computed at")
    ap.add_argument("--max_frames", type=int, default=400)
    ap.add_argument("--iters", type=int, default=0,
                    help="override Train.niters_or_epochs_no_decay (0 = the config's default, 100)")
    ap.add_argument("--face", choices=("trained", "random", "off"), default="trained",
                    help="face-loss arm: trained = assets/faceloss.npz; random = random-projection "
                         "features; off = use_face false")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    clip = real.CLIP
    if not clip or not os.path.exists(clip):
        print(json.dumps({"error": "no sample clip: set IPERCORE_REFERENCE_SAMPLES to the reference's "
                                   "assets/samples (references/akun_1.mp4)", "clip": clip}))
        return 1
    t0 = time.perf_counter()
    src_frames = SOURCE_FRAMES[: args.num_source]
    real.ensure_frames(src_frames)
    src_dir = os.path.join(args.out_dir, "source_frames")
    os.makedirs(src_dir, exist_ok=True)
    for f in src_frames:
        dst = os.path.join(src_dir, f"frame_{f:04d}.png")
        if not os.path.exists(dst):
            shutil.copy(os.path.join(real.FRAME_DIR, f"akun_{f:04d}.png"), dst)

    face = {"trained": [], "random": ["--Train.face_loss_path", "random"],
            "off": ["--Train.use_face", "false"]}[args.face]
    iters = ["--Train.niters_or_epochs_no_decay", str(args.iters)] if args.iters else []
    arm = args.face + (f"_it{args.iters}" if args.iters else "")
    opt = options.parse_args(["--output_dir", args.out_dir, "--model_id", f"akun_self_{arm}",
                              "--image_size", str(args.image_size), "--num_source", str(args.num_source),
                              "--src_path", f"path?={src_dir},name?=akun_self",
                              "--ref_path", f"path?={clip},name?=akun_1,pose_fc?=300"] + face + iters)
    run_imitator(opt, device=device)

    syn_dir = os.path.join(args.out_dir, "primitives", "akun_self-akun_1", "synthesis")
    preds = sorted(glob.glob(os.path.join(syn_dir, "pred_*.png")))
    proc_imgs = os.path.join(args.out_dir, "primitives", "akun_1", "processed", "images")
    gts = sorted(glob.glob(os.path.join(proc_imgs, "*.png"))) or sorted(glob.glob(os.path.join(proc_imgs, "*.jpg")))
    n = min(len(preds), len(gts), args.max_frames)
    if n == 0:
        print(json.dumps({"error": "no frames", "syn_dir": syn_dir, "gt_dir": proc_imgs}))
        return 1
    a = np.stack([vid.load_image(p, size=args.eval_size) for p in preds[:n]])
    b = np.stack([vid.load_image(p, size=args.eval_size) for p in gts[:n]])
    metrics = evaluate_frames(a, b, device=device)
    metrics.update({"protocol": "iPER self-imitation (docs/evaluate.md:4-11)", "clip": "akun_1.mp4",
                    "n_frames": n, "image_size": args.image_size, "eval_size": args.eval_size,
                    "num_source": args.num_source, "face_arm": args.face, "personalize_iters": args.iters or 100,
                    "wall_s": round(time.perf_counter() - t0, 1)})
    with open(os.path.join(args.out_dir, f"self_imitation_{arm}.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
