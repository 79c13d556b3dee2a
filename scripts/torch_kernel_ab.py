#!/usr/bin/env python3
"""Focused timings of the PyTorch / CUDA port on one NVIDIA GPU, for A/B runs.

Each mode measures the `ipercore_tpu_torch` package of the current directory,
so two versions are compared by unpacking each into its own directory and
running the same mode in each, in turns (a, b, b, a), all on the same
card:

    cd <checkout> && python3 <repo>/scripts/torch_kernel_ab.py k2
    cd <checkout> && python3 <repo>/scripts/torch_kernel_ab.py compose
    cd <checkout> && python3 <repo>/scripts/torch_kernel_ab.py k4
    cd <checkout> && python3 <repo>/scripts/torch_kernel_ab.py temporal
    cd <checkout> && python3 <repo>/scripts/torch_kernel_ab.py generator

Modes (main-path shapes of `chip_smoke.py`: 8 frames, 512^2, the synthetic
body; one JSON line each):
  k2        device microseconds (profiler) and event milliseconds of
            `grid_sample_nhwc` and of `F.grid_sample` on one UV image under the
            UV flow of the first chunk, and under a random grid;
  compose   device microseconds of the UV warp's composition around K2
            (copy of the UV flow + K2 + `torch.cat`, against K2 reading the
            flow in place and writing into the generator's input, in both
            orders, and with a copied grid), beyond K1 and `encode_fim`;
  k4        K4 checked against its plain versions (tables and outputs, k = 2048
            and 256, and a crowded tile), then its kernel, binning and wrapper
            times and device microseconds per kernel;
  temporal  temporal mode on 8 frames, timed five times, and its device time;
  generator one AttLWB-SPADE chunk by convolution: CUDA events around every
            convolution module and every SPADE block inside the chunk (three
            chunks, averaged), summed by role (SPADE, the attention's 1x1s, the
            rest); then each distinct convolution (module type, input and
            weight shapes) and SPADE block run alone under the profiler, with
            the device microseconds and names of the kernels it launches.
Needs a GPU; exits with code 2 when there is none.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def _setup():
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.utils import cuda_build

    cuda_build.build_all()
    dev = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = smpl_mod.template_model(device=dev)
    assets = load_assets(model, device=dev)
    return cs, dev, model, assets


def _total_us(cs, fn, reps: int) -> float:
    return sum(us for us, _ in cs.kernel_times(fn, reps))


def k2() -> dict:
    import torch.nn.functional as Fn

    cs, dev, model, assets = _setup()
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.ops import sampling_cuda as sc

    tgt_fv, _, aux = cs.geometry_inputs(model, assets, dev)
    _, flows = rc.raster_flows(tgt_fv, aux, cs.SIZE)
    g = torch.Generator(device="cpu").manual_seed(0)
    uv = (torch.rand((1, cs.SIZE, cs.SIZE, 3), generator=g) * 2 - 1).to(dev)
    imgs = uv.expand(cs.CHUNK, cs.SIZE, cs.SIZE, 3)
    nchw = imgs.contiguous().permute(0, 3, 1, 2)
    grids = {"flow": flows[..., 0, :].contiguous(),
             "random": (torch.rand((cs.CHUNK, cs.SIZE, cs.SIZE, 2), generator=g) * 2.2 - 1.1).to(dev)}
    out = {}
    for name, grid in grids.items():
        lib = lambda: Fn.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                                     align_corners=False)
        kern = lambda: sc.grid_sample_nhwc(imgs, grid)
        kern()
        out[name] = {"device_us": _total_us(cs, kern, 10), "event_ms": cs.cuda_ms(kern, reps=50),
                     "library_device_us": _total_us(cs, lib, 10),
                     "library_event_ms": cs.cuda_ms(lib, reps=50)}
    return out


def compose() -> dict:
    cs, dev, model, assets = _setup()
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.ops import sampling_cuda as sc

    tgt_fv, _, aux = cs.geometry_inputs(model, assets, dev)
    uv = torch.rand((1, cs.SIZE, cs.SIZE, 3), device=dev) * 2 - 1
    T, S = cs.CHUNK, cs.SIZE
    imgs = uv.expand(T, -1, -1, -1)

    def geo():
        fim, flows = rc.raster_flows(tgt_fv, aux, S)
        return flows, rz.encode_fim(fim, assets.map_fn)

    def cat(flows, cond):  # a copy of the UV flow, K2, then a concatenation
        return torch.cat([sc.grid_sample_nhwc(imgs, flows[..., 0, :].contiguous()), cond], -1)

    def into(flows, cond, k2_first=True, copy_grid=False):
        out = torch.empty((T, S, S, 3 + cond.shape[-1]), device=dev)
        grid = flows[..., 0, :].contiguous() if copy_grid else flows[..., 0, :]
        if not k2_first:
            out[..., 3:] = cond
        sc.grid_sample_nhwc(imgs, grid, out=out[..., :3])
        if k2_first:
            out[..., 3:] = cond
        return out

    variants = {"copy_k2_cat": cat, "k2_then_cond": into,
                "cond_then_k2": lambda f, c: into(f, c, k2_first=False),
                "copied_grid": lambda f, c: into(f, c, k2_first=False, copy_grid=True)}
    flows, cond = geo()
    ref = cat(flows, cond)
    for name, fn in variants.items():
        if not torch.equal(fn(flows, cond), ref):
            raise AssertionError(f"{name} differs from the concatenation")
    out = {}
    for rnd in range(2):
        for name in (list(variants) if rnd == 0 else list(variants)[::-1]):
            fn = variants[name]
            extra = _total_us(cs, lambda: fn(*geo()), 5) - _total_us(cs, geo, 5)
            out.setdefault(name, []).append(extra)
    return {"device_us_beyond_k1_and_encode_fim": out}


def k4() -> dict:
    cs, dev, model, assets = _setup()
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc

    tgt_fv, _, aux = cs.geometry_inputs(model, assets, dev)
    J, k = aux.shape[0], cs.TABLE_K
    for kk in (k, 256):
        cs.table_binning_check(tgt_fv, kk, f"k={kk}")
        fim, flows = rc.raster_flows_table(tgt_fv, aux, cs.SIZE, k=kk)
        fim_p, flows_p = rc.raster_flows_table_plain(tgt_fv, aux, cs.SIZE, kk)
        cs.check(torch.equal(fim, fim_p) and torch.equal(flows, flows_p), f"k={kk}: not bit-equal")
    cs.table_binning_check(cs.crowded_tile_scene(dev), k, "crowded tile")
    plan = rc.prepare_table(tgt_fv, cs.SIZE, k)
    return {"kernel_ms": cs.cuda_ms(lambda: rc.launch_raster_flows_table(plan, aux, cs.SIZE, J), reps=50),
            "binning_ms": cs.cuda_ms(lambda: rc.prepare_table(tgt_fv, cs.SIZE, k), reps=50),
            "wrapper_ms": cs.cuda_ms(lambda: rc.raster_flows_table(tgt_fv, aux, cs.SIZE, k=k), reps=50),
            "device_us": cs.device_us_by_kernel(lambda: rc.raster_flows_table(tgt_fv, aux, cs.SIZE, k=k),
                                                reps=20),
            "work_items": int(plan.items[:, -1].sum())}


def temporal() -> dict:
    cs, dev, model, assets = _setup()
    from ipercore_tpu_torch.models import flow_composition as fc
    from ipercore_tpu_torch.models import imitator as imit
    from ipercore_tpu_torch.models.networks import build_generator
    from ipercore_tpu_torch.services.run_imitator import imitate_sequence
    from ipercore_tpu_torch.utils.checkpoint import load_generator_params, seeded_flat_params

    gen = build_generator("AttLWB-SPADE", cs.CFG, device=dev)
    load_generator_params(gen, seeded_flat_params(cs.CFG, seed=0))
    tgen = build_generator("AttLWB-SPADE", cs.CFG, temporal=True, device=dev)
    load_generator_params(tgen, seeded_flat_params(cs.CFG, seed=0))
    src_img, src_smpl = cs.source_inputs(dev)
    comp = fc.make_composer(model, assets, image_size=cs.SIZE, out_dilate_ks=51)
    cache = imit.setup_source(comp, gen, src_img, src_smpl)
    smpls = imit.prepare_target_smpls(model, cache, cs.target_smpls(cs.N_FRAMES, 1),
                                      cam_strategy="smooth")[:cs.CHUNK]
    run = lambda: imitate_sequence(comp, tgen, cache, smpls, temporal=True, device=dev)
    run()
    fps = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        fps.append(cs.CHUNK / (time.perf_counter() - t0))
    return {"frames_per_s": fps, "device_ms": _total_us(cs, run, 1) / 1e3}


def _role(name: str) -> str:
    if "SPADE" in name:
        return "spade"
    return "attention_1x1" if name.rsplit(".", 1)[-1] in ("fk", "fv", "fq") else "other"


def generator() -> dict:
    cs, dev, model, assets = _setup()
    from ipercore_tpu_torch.models import flow_composition as fc
    from ipercore_tpu_torch.models import imitator as imit
    from ipercore_tpu_torch.models.networks import build_generator
    from ipercore_tpu_torch.models.networks.blocks import SPADE
    from ipercore_tpu_torch.utils.checkpoint import load_generator_params, seeded_flat_params

    gen = build_generator("AttLWB-SPADE", cs.CFG, device=dev)
    load_generator_params(gen, seeded_flat_params(cs.CFG, seed=0))
    src_img, src_smpl = cs.source_inputs(dev)
    comp = fc.make_composer(model, assets, image_size=cs.SIZE, out_dilate_ks=51)
    cache = imit.setup_source(comp, gen, src_img, src_smpl)
    smpls = imit.prepare_target_smpls(model, cache, cs.target_smpls(cs.CHUNK, 1), cam_strategy="smooth")
    batch = torch.as_tensor(smpls, device=dev)
    chunk = lambda: imit.synthesize_frames(comp, gen, cache, batch)
    chunk()

    kinds = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, SPADE)
    mods = {n: m for n, m in gen.named_modules() if isinstance(m, kinds)}
    events, inputs = {}, {}

    def pre(name):
        def hook(mod, args):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            events.setdefault(name, []).append([start, None])
            inputs.setdefault(name, args)
        return hook

    def post(name):
        def hook(mod, args, out):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events[name][-1][1] = end
        return hook

    handles = [h for n, m in mods.items()
               for h in (m.register_forward_pre_hook(pre(n)), m.register_forward_hook(post(n)))]
    reps = 3
    for _ in range(reps):
        chunk()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    ms = {n: sum(s.elapsed_time(e) for s, e in evs) / reps for n, evs in events.items()}

    rows = {}
    with torch.no_grad():
        for n, args in inputs.items():
            m = mods[n]
            sig = (type(m).__name__, tuple(tuple(a.shape) for a in args),
                   tuple(getattr(m, "weight", torch.empty(0)).shape), getattr(m, "stride", None))
            row = rows.get(sig)
            if row is None:
                times = cs.kernel_times(lambda: m(*args), reps=3)
                row = rows[sig] = {
                    "module": type(m).__name__, "input": sig[1], "weight": sig[2], "role": _role(n),
                    "modules": [], "ms_in_chunk": 0.0,
                    "alone_device_us": sum(us for us, _ in times),
                    "kernels": [[round(us, 1), k[:90]] for us, k in sorted(times, reverse=True)[:4]]}
            row["modules"].append(n)
            row["ms_in_chunk"] += ms[n]
    del inputs
    convs = [r for r in rows.values() if r["module"] != "SPADE"]
    by_role = {}
    for r in convs:
        by_role[r["role"]] = by_role.get(r["role"], 0.0) + r["ms_in_chunk"]
    return {"chunk": cs.CHUNK, "chunk_ms": cs.cuda_ms(chunk, reps=3, warmup=1),
            "breakdown": cs.device_breakdown(chunk),
            "conv_module_ms_by_role": by_role,
            "spade_block_ms": {n: v for n, v in ms.items() if isinstance(mods[n], SPADE)},
            "spade_blocks_ms": sum(v for n, v in ms.items() if isinstance(mods[n], SPADE)),
            "spade_blocks": [r for r in rows.values() if r["module"] == "SPADE"],
            "convolutions": sorted(convs, key=lambda r: -r["ms_in_chunk"])}


MODES = {"k2": k2, "compose": compose, "k4": k4, "temporal": temporal, "generator": generator}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=list(MODES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    print(json.dumps({"mode": args.mode, "dir": os.getcwd(), **MODES[args.mode]()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
