"""Imitation traffic through the port's product path: one client in a closed
loop of reference clips, each through `prepare_target_smpls` and
`StreamingSynthesizer.run`, frames fetched to host memory.

The traffic file says whether the subject is set up once in the set-up
(`"subject": "per_run"`) or with every request (`"per_request"`: its source
views through `setup_source` inside the window). After the window, the
frames of one seeded chunk of a seeded sample of requests are worked out
again by the plain reference from the same inputs and weights and compared.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np
import torch

from portbench.lib import trace as tr
from portbench.lib import yardstick as ys
from portbench.lib.port import body_and_assets
from portbench.lib.runner import device_info, peak_bytes, quantile, sync, tf32
from portbench.lib.traffic import Requests, rng_of, subject
from portbench.lib.weights import seeded_state_dict
from portbench.reference import body as body_ref
from portbench.reference import geometry as geo
from portbench.reference import imitate as ref_imit
from portbench.reference.generator import LWBGenerator as RefGenerator


def weight_seed(seed: int) -> int:
    return int(rng_of(seed, 6).integers(0, 2 ** 63))


def reference_generator(config: dict, device) -> torch.nn.Module:
    return RefGenerator(config["Generator"], config["fusion"]).to(device).eval()


def generator_weights(config: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        shapes = RefGenerator(config["Generator"], config["fusion"])
    return seeded_state_dict(shapes, weight_seed(seed), device)


@contextlib.contextmanager
def delivery_stamps(stamps: list, spans: tr.Spans | None):
    """Record the host clock each time `StreamingSynthesizer` has a chunk's
    frames in host memory: its fetch returns."""
    from ipercore_tpu_torch.parallel import streaming

    bases = {name: getattr(streaming, name) for name in ("_CudaFetch", "_HostFetch")}

    def timed(base):
        class Timed(base):
            def fetch(self, pending):
                item = spans.open("fetch_wait") if spans is not None else None
                out = super().fetch(pending)
                stamps.append(time.perf_counter())
                if item is not None:
                    spans.close(item)
                return out
        return Timed

    for name, base in bases.items():
        setattr(streaming, name, timed(base))
    try:
        yield
    finally:
        for name, base in bases.items():
            setattr(streaming, name, base)


@contextlib.contextmanager
def span(spans, name):
    item = spans.open(name) if spans is not None else None
    try:
        yield
    finally:
        if item is not None:
            spans.close(item)


class Program:
    """The port set up for a cell: body, composer, generator and, for a mix
    with one subject, its source cache."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, body_np: dict, mesh_np: dict):
        from ipercore_tpu_torch.models import flow_composition as fc
        from ipercore_tpu_torch.models import imitator as imit
        from ipercore_tpu_torch.models.networks import build_generator
        from ipercore_tpu_torch.parallel.streaming import StreamingSynthesizer

        self.imit, self.Streaming = imit, StreamingSynthesizer
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.model, assets = body_and_assets(body_np, mesh_np, device)
        self.comp = fc.make_composer(self.model, assets, image_size=config["image_size"],
                                     **config["composer"])
        self.gen = build_generator(config["generator"], config["Generator"],
                                   num_source=config["num_source"], device=device)
        self.gen.load_state_dict(generator_weights(config, seed, device), strict=True)
        self.cache = None  # the subject's source cache, for a mix with one subject

    def setup_source(self, index: int):
        S, ns = self.config["image_size"], self.config["num_source"]
        img, smpl = subject(self.seed, index, S, ns, self.traffic["source"], self.device)
        return self.imit.setup_source(self.comp, self.gen, img, smpl)

    def request(self, cache, clip: np.ndarray, spans=None) -> tuple:
        """One clip: (prepared SMPLs, frames as a list of (S, S, 3) arrays)."""
        with span(spans, "prepare_target_smpls"):
            smpls = self.imit.prepare_target_smpls(self.model, cache, clip, cam_strategy="smooth")
        with span(spans, "stream"):
            frames = self.Streaming(self.comp, self.gen, cache, chunk=self.traffic["chunk"]).run(smpls)
        return smpls, frames


def window(prog: Program, reqs: Requests, seconds: float, trace: bool) -> dict:
    """The measured window: requests in a closed loop until `seconds` have
    passed; the request in flight then finishes, and only what was delivered
    inside the window counts."""
    tfc, chunk = prog.traffic, prog.traffic["chunk"]
    per_request = tfc["subject"] == "per_request"
    spans = tr.Spans() if trace else None
    prof = tr.Profiler(prog.device) if trace else None
    out = {"gaps_s": [], "frames": 0, "requests": 0, "kept": {}, "traced": None}
    traced = {"requests": [], "setup_source_s": [], "kernels": [], "spans": [], "window_s": 0.0}
    if prof is not None:  # before the window: the tracer's start-up takes seconds
        prof.start()
    sync(prog.device)
    t0 = t_trace = time.perf_counter()
    t_end = t0 + seconds
    tracing = prof is not None
    i = 0
    while time.perf_counter() < t_end:
        clip = reqs.clip(i)
        stamps: list = []
        t_req = time.perf_counter()
        with span(spans, "request"):
            if per_request:
                with span(spans, "setup_source"):
                    if tracing:  # the benchmark's own synchronised span, traced runs only
                        sync(prog.device)
                        t_setup = time.perf_counter()
                    cache = prog.setup_source(reqs.subject_index(i))
                    if tracing:
                        sync(prog.device)
                        traced["setup_source_s"].append(time.perf_counter() - t_setup)
            else:
                cache = prog.cache
            with delivery_stamps(stamps, spans):
                smpls, frames = prog.request(cache, clip, spans)
        n = len(clip)
        prev = t_req
        for ci, ts in enumerate(stamps):
            if ts <= t_end:
                out["gaps_s"].append(ts - prev)
                out["frames"] += min(chunk, n - ci * chunk)
            prev = ts
        c = reqs.checked_chunk(i, chunk)
        out["kept"][i] = np.stack(frames[c * chunk:(c + 1) * chunk])
        if tracing:
            traced["requests"].append((i, smpls))
            if time.perf_counter() - t0 >= tfc["trace_seconds"] or time.perf_counter() >= t_end:
                traced["kernels"], t_stop = prof.stop()
                traced["window_s"] = t_stop - t_trace
                traced["spans"] = spans.closed()
                tracing = False
        del frames
        i += 1
    out["requests"] = i
    out["traced"] = traced if trace else None
    return out


def reference_frames(config: dict, traffic: dict, seed: int, device, picks: dict,
                     body_np: dict, mesh_np: dict) -> dict:
    """The reference's frames of the picked chunks {request: chunk index}."""
    reqs = Requests(traffic, seed)
    chunk, S, ns = traffic["chunk"], config["image_size"], config["num_source"]
    with torch.no_grad():
        body = geo.Body(body_np, device)
        comp = ref_imit.Composer(body, mesh_np, S, **config["composer"])
        gen = reference_generator(config, device)
        gen.load_state_dict(generator_weights(config, seed, device), strict=True)
        out, sources = {}, {}
        for i, c in sorted(picks.items()):
            k = reqs.subject_index(i)
            if k not in sources:
                img, smpl = subject(seed, k, S, ns, traffic["source"], device)
                sources = {k: ref_imit.setup_source(comp, gen, img, smpl)}
            src = sources[k]
            smpls = ref_imit.prepare_target_smpls(comp, src, reqs.clip(i))
            n = len(smpls)
            rows = np.concatenate([smpls, np.repeat(smpls[-1:], (-n) % chunk, axis=0)])
            rows = rows[c * chunk:(c + 1) * chunk]
            frames = ref_imit.synthesize(comp, gen, src, torch.as_tensor(rows, device=device))
            out[i] = frames[:min(chunk, n - c * chunk)].cpu().numpy()
    return out


def control(cell, seed: int, device, n_requests: int) -> dict:
    """The control: the reference in the program's place, computed in TF32
    (the precision below the configuration's float32 with TF32 off), on the
    checked chunks of the mix's first `n_requests` requests, compared as a
    run compares the program."""
    config, traffic = cell.config, cell.traffic
    body_np = body_ref.body_arrays()
    mesh_np = body_ref.mesh_arrays(body_np)
    reqs = Requests(traffic, seed)
    picks = {i: reqs.checked_chunk(i, traffic["chunk"]) for i in range(n_requests)}
    with tf32(False):
        want = reference_frames(config, traffic, seed, device, picks, body_np, mesh_np)
    with tf32(True):
        got = reference_frames(config, traffic, seed, device, picks, body_np, mesh_np)
    return compare(got, want)


def compare(got: dict, want: dict) -> dict:
    """The numbers compared: the largest and the mean absolute difference
    over every compared value, and the share of values not finite."""
    if not want:
        return {"frame_max_abs_err": float("inf"), "frame_mean_abs_err": float("inf"),
                "frame_nonfinite": float("inf")}
    diffs = [np.abs(got[i][:len(want[i])].astype(np.float64) - want[i]) for i in want]
    flat = np.concatenate([d.reshape(-1) for d in diffs])
    finite = np.isfinite(flat)
    return {"frame_max_abs_err": float(flat[finite].max()) if finite.any() else float("inf"),
            "frame_mean_abs_err": float(flat[finite].mean()) if finite.any() else float("inf"),
            "frame_nonfinite": float((~finite).sum())}


def picks_of(reqs: Requests, n_requests: int, chunk: int, k: int, seed: int) -> dict:
    """A seeded sample of k of the run's requests, each with its checked chunk."""
    chosen = rng_of(seed, 7).permutation(n_requests)[:k]
    return {int(i): reqs.checked_chunk(int(i), chunk) for i in chosen}


def flops_per_frame(config: dict) -> tuple[float, float]:
    """Nominal operations of one frame's generator and of one subject's
    set-up (BGNet and SIDNet), counted at 64^2 on the host and scaled by
    area: every layer of the generators scales with the image's area."""
    S0, ns = 64, config["num_source"]
    scale = (config["image_size"] / S0) ** 2
    gen = RefGenerator(config["Generator"], config["fusion"]).eval()
    src = torch.zeros(1, ns, S0, S0, 6)
    enc, res = gen.forward_src(src)
    tst = torch.zeros(1, ns, S0, S0, 2)
    frame = ys.count_flops(gen, lambda: gen.forward_tsf(torch.zeros(1, S0, S0, 6), enc, res, tst))
    setup = ys.count_flops(gen, lambda: (gen.forward_bg(torch.zeros(1, 1, S0, S0, 4)),
                                         gen.forward_src(src)))
    return frame * scale, setup * scale


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> tuple:
    config, traffic = cell.config, cell.traffic
    chunk = traffic["chunk"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    marks = [("start", time.perf_counter())]
    body_np = body_ref.body_arrays()
    mesh_np = body_ref.mesh_arrays(body_np)
    reqs = Requests(traffic, seed)
    marks.append(("inputs", time.perf_counter()))

    # set-up: the program, the subject of a one-subject mix, and one warm
    # request through the same path at the same chunk size
    prog = Program(config, traffic, seed, device, body_np, mesh_np)
    sync(device)
    marks.append(("program", time.perf_counter()))
    if traffic["subject"] == "per_run":
        prog.cache = warm_cache = prog.setup_source(0)
    else:
        warm_cache = prog.setup_source(0)
    sync(device)
    marks.append(("source", time.perf_counter()))
    warm = Requests(traffic, seed ^ 0x5EED).clip(0)[:traffic["warmup_frames"]]
    for k in range(2):
        prog.request(warm_cache, warm)
        sync(device)
        marks.append((f"warm{k}", time.perf_counter()))
    del warm_cache
    setup_s = time.perf_counter() - t_start
    print("set-up: imports %.2f s; " % (marks[0][1] - t_start) + "; ".join(
        f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:])), file=sys.stderr)

    w = window(prog, reqs, seconds, trace)
    peak = peak_bytes(device)

    # the program's state goes before the reference runs
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    picks = picks_of(reqs, w["requests"], chunk, traffic["check"]["requests"], seed)
    t_ref = time.perf_counter()
    want = reference_frames(config, traffic, seed, device, picks, body_np, mesh_np)
    print(f"reference: {len(picks)} chunks in {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    numbers = compare({i: w["kept"][i] for i in picks}, want)
    limits = config["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": w["requests"], "failed": 0,
              "metrics": {}, "device": device_info(device, peak)}
    if not trace:
        values = {"frames_per_s": w["frames"] / seconds,
                  "chunk_gap_ms_p95": 1e3 * quantile(w["gaps_s"], 0.95),
                  "setup_s": setup_s}
        print(f"chunk gaps in the window: {len(w['gaps_s'])}; frames {w['frames']}; "
              f"requests {w['requests']}", file=sys.stderr)
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items() if k in units}
        return result, checks

    t = w["traced"]
    frame_flops, setup_flops = flops_per_frame(config)
    body = geo.Body(body_np, device)
    S, ns = config["image_size"], config["num_source"]
    counters = {"frames": 0, "frames_computed": 0, "chunks": 0, "requests": len(t["requests"]),
                "setup_source_calls": len(t["setup_source_s"]),
                "setup_source_s": list(t["setup_source_s"]),
                "frame_flops": frame_flops, "setup_flops": setup_flops,
                "k1_bound_s": 0.0, "k2_bound_s": 0.0}
    with torch.no_grad():
        for _, smpls in t["requests"]:
            n = len(smpls)
            rows = np.concatenate([smpls, np.repeat(smpls[-1:], (-n) % chunk, axis=0)])
            for c in range(len(rows) // chunk):
                fv = geo.face_verts_of(body, torch.as_tensor(rows[c * chunk:(c + 1) * chunk], device=device))
                counters["k1_bound_s"] += ys.raster_flows_bound_s(fv, S, 1 + ns)
                counters["k2_bound_s"] += ys.grid_sample_bound_s(chunk, S, S, 3, S, S)
                counters["chunks"] += 1
            counters["frames"] += n
            counters["frames_computed"] += len(rows)
    run_ = tr.Run(cell=cell.name, config=config, traffic=traffic, counters=counters,
                  kernels=t["kernels"], spans=t["spans"], window_s=t["window_s"])
    result["device"]["busy_s"] = tr.busy_seconds(t["kernels"])
    result["device"]["window_s"] = t["window_s"]
    result["breakdown"] = {"device_ops": tr.top_device_ops(t["kernels"]),
                           "idle_gaps": tr.idle_gaps(t["kernels"], t["spans"])}
    result["run"] = run_
    return result, checks
