#!/usr/bin/env python3
"""Hold K1 (`raster_flows`) against its plain version on one NVIDIA GPU over
frame counts and image sizes.

    python3 scripts/torch_raster_size_probe.py [--out raster_size_probe.json]

For random bodies (`synth_data.make_theta` on the template body, 4-16 frames)
at 384² and 512², and for the face-loss trainer's head close-ups (12 frames at
384², together, in the first 8, and frame by frame), prints one JSON line a
case: the pixels a frame whose face differs between the kernel and the plain
raster run on the card, the largest flow difference, and the first such
pixel with both faces' vertices. Writes all lines as JSON to `--out`. Needs a
GPU; exits with code 2 when there is none.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="raster_size_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.ops import rasterizer as rz
    from ipercore_tpu_torch.ops import rasterizer_cuda as rc
    from ipercore_tpu_torch.scripts import train_faceloss
    from ipercore_tpu_torch.tools import synth_data as sd

    dev = torch.device("cuda:0")
    model = smpl_mod.template_model(device=dev)
    assets = load_assets(model, device=dev)
    res = []

    def check(fv, size, what):
        fim, flows = rc.raster_flows(fv, assets.f2uvs[None], size)
        pfim, pflows = rc.raster_flows_plain(fv, assets.f2uvs[None], size)
        bad = fim != pfim
        r = {"what": what, "T": int(fv.shape[0]), "size": size,
             "bad_pixels_per_frame": bad.reshape(bad.shape[0], -1).sum(1).tolist(),
             "flow_err": float((flows - pflows).abs().max())}
        if bad.any():
            t, y, x = (int(v) for v in bad.nonzero()[0])
            r["first"] = {"t": t, "y": y, "x": x, "kernel_face": int(fim[t, y, x]), "plain_face": int(pfim[t, y, x])}
            for key, f in (("kernel", int(fim[t, y, x])), ("plain", int(pfim[t, y, x]))):
                if f >= 0:
                    r["first"][key + "_verts"] = fv[t, f].tolist()
        res.append(r)
        print(json.dumps(r), flush=True)

    g = torch.Generator(device=dev)
    for T in (8, 12, 16, 7, 13, 4):
        theta = sd.make_theta(sd.Draws(g.manual_seed(T), dev), T)
        d = smpl_mod.get_details(model, theta)
        fv = rz.verts_to_faces(rz.project_verts(d["verts"], d["cam"]), model.faces).contiguous()
        for size in (384, 512):
            check(fv, size, "make_theta")
    calls, k1 = [], sd.raster_flows

    def keep(fv, aux, size, *a, **kw):
        calls.append((fv, size))
        return k1(fv, aux, size, *a, **kw)

    sd.raster_flows = keep
    try:
        train_faceloss.make_batch(*train_faceloss.batch_draws(556, dev), model, assets, 12, 192)
    finally:
        sd.raster_flows = k1
    for fv, size in calls:
        check(fv, size, "faceloss")
        check(fv[:8].contiguous(), size, "faceloss first 8")
        for t in range(fv.shape[0]):
            check(fv[t:t + 1].contiguous(), size, f"faceloss frame {t} alone")
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
