"""The quality cost of each throughput shortcut.

Twin of `scripts/evaluate/accuracy_cost.py`. A fixed golden sequence
(structured source images: gradients, checkers and blobs; a smooth pose
track) is synthesized in the reference configuration (f32, `tst_stride` 1,
`feat_warp_stride` 1) and once per shortcut: bf16 generator, `tst_stride` 2,
`feat_warp_stride` 2, and the two combined settings. Each is reported as the
SSIM, PSNR and mean |delta| of its frames against the golden frames. The
generator's weights are seeded (`seeded_flat_params(cfg, 0)`), so the
numbers are the numeric drift each shortcut introduces through the real
compute graph, not absolute visual quality. Every configuration runs K1 and
K2 on the card (composer build and setup: K3).

    python -m ipercore_tpu_torch.scripts.evaluate.accuracy_cost [--size 512] [--frames 8] [--smoke] [--device cpu]

Prints one JSON line per shortcut, then a markdown table.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ipercore_tpu_torch.scripts._common import resolve_device

SMOKE_CFG = {"BGNet": {"num_filters": [8, 16, 16, 32], "n_res_block": 1},
             "SIDNet": {"num_filters": [8, 16, 32], "n_res_block": 1},
             "TSFNet": {"num_filters": [8, 16, 32], "n_res_block": 1}}
FULL_CFG = {"BGNet": {"num_filters": [64, 128, 128, 256], "n_res_block": 6},
            "SIDNet": {"num_filters": [64, 128, 256], "n_res_block": 6},
            "TSFNet": {"num_filters": [64, 128, 256], "n_res_block": 6}}
# (name, compute dtype, tst_stride, feat_warp_stride); the first is the golden one
CONFIGS = (("golden_f32_stride1", None, 1, 1),
           ("bf16_generator", torch.bfloat16, 1, 1),
           ("tst_stride2", None, 2, 1),
           ("feat_warp_stride2", None, 1, 2),
           ("bench_bf16_stride2", torch.bfloat16, 2, 1),
           ("bench_bf16_stride2_fw2", torch.bfloat16, 2, 2))


def golden_sequence(S: int, ns: int, T: int):
    """Deterministic structured inputs (gradients + checker + blobs), so SSIM
    means something, and a smooth pose track (`golden_sequence`, `:28-51`)."""
    rng = np.random.RandomState(0)
    yy, xx = np.meshgrid(np.linspace(-1, 1, S), np.linspace(-1, 1, S), indexing="ij")
    imgs = []
    for i in range(ns):
        checker = np.sign(np.sin(xx * (8 + 4 * i) * np.pi) * np.sin(yy * 8 * np.pi))
        blob = np.exp(-((xx - 0.2 * i) ** 2 + yy ** 2) / 0.08)
        img = np.stack([xx, checker * 0.5, blob * 2 - 1], axis=-1)
        imgs.append(np.clip(img + rng.uniform(-0.05, 0.05, (S, S, 3)), -1, 1))
    src_img = np.stack(imgs)[None].astype(np.float32)
    src_smpl = np.zeros((1, ns, 85), np.float32)
    src_smpl[..., 0] = 1.1
    t = np.linspace(0, 2 * np.pi, T, endpoint=False)
    tgt = np.zeros((T, 85), np.float32)
    tgt[:, 0] = 1.1
    tgt[:, 3 + 3] = 0.3 * np.sin(t)  # hip sway
    tgt[:, 3 + 48] = 0.4 * np.sin(t * 2)  # arm swing
    tgt[:, 1] = 0.05 * np.cos(t)  # the camera's tx drifts
    return src_img, src_smpl, tgt


def build(size: int, smoke: bool, device):
    """(composer, {feat_warp_stride: generator}, cache): both generators
    share one seeded parameter set."""
    from ipercore_tpu_torch.models import flow_composition as fc
    from ipercore_tpu_torch.models import imitator as imit
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.models.networks import build_generator
    from ipercore_tpu_torch.utils.checkpoint import load_generator_params, seeded_flat_params

    if smoke:
        model = smpl_mod.synthetic_model(nu=20, nv=18, device=device)
        assets, cfg = load_assets(model, device=device, synthetic=True), SMOKE_CFG
    else:
        model = smpl_mod.template_model(device=device)
        assets, cfg = load_assets(model, device=device), FULL_CFG
    comp = fc.make_composer(model, assets, image_size=size, out_dilate_ks=11 if smoke else 51)
    params = seeded_flat_params(cfg, 0)
    gens = {}
    for fw in (1, 2):
        gens[fw] = build_generator("AttLWB-SPADE", cfg, feat_warp_stride=fw, device=device)
        load_generator_params(gens[fw], params)
    src_img, src_smpl, _ = golden_sequence(size, 2, 1)
    t = lambda a: torch.as_tensor(a, device=device)
    return comp, gens, imit.setup_source(comp, gens[1], t(src_img), t(src_smpl))


def run_configs(comp, gens, cache, tgt: torch.Tensor) -> dict:
    """name -> frames (T, S, S, 3) f32 numpy of every configuration."""
    from ipercore_tpu_torch.models import imitator as imit

    out = {}
    with torch.no_grad():
        for name, dtype, stride, fw in CONFIGS:
            pred = imit.synthesize_frames(comp, gens[fw], cache, tgt, compute_dtype=dtype, tst_stride=stride)[0]
            out[name] = pred.float().cpu().numpy()
    return out


def score(frames: dict, device) -> list[dict]:
    """SSIM, PSNR and mean |delta| of each shortcut against the golden frames."""
    from ipercore_tpu_torch.services.evaluate import psnr, ssim

    golden = frames[CONFIGS[0][0]]
    b = torch.as_tensor((golden + 1.0) * 0.5, device=device)
    rows = []
    for name, out in frames.items():
        if name == CONFIGS[0][0]:
            continue
        a = torch.as_tensor((out + 1.0) * 0.5, device=device)
        rows.append({"config": name, "ssim_vs_golden": round(float(ssim(a, b).mean()), 5),
                     "psnr_vs_golden": round(float(psnr(a, b).mean()), 2),
                     "mean_abs_delta": round(float(np.mean(np.abs(out - golden))), 6),
                     "size": golden.shape[1], "frames": len(golden)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", help="tiny nets / mesh")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    S = 64 if args.smoke else args.size
    comp, gens, cache = build(S, args.smoke, device)
    tgt = torch.as_tensor(golden_sequence(S, 2, args.frames)[2], device=device)
    rows = score(run_configs(comp, gens, cache, tgt), device)
    for r in rows:
        print(json.dumps(r))
    print("\n| config | SSIM vs f32/stride1 | PSNR (dB) | mean |Δ| |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['config']} | {r['ssim_vs_golden']} | {r['psnr_vs_golden']} | {r['mean_abs_delta']} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
