"""Sharded imitation traffic through the port's multi-card path: one client in
a closed loop of reference clips, each through `prepare_target_smpls` and one
`parallel/inference.sharded_synthesize` call over the cell's cards, frames
fetched to host memory.

The subject is set up once, in the set-up, on the first card. A clip is one
call: the function pads it with its last frame to a multiple of the cards,
gives each card its contiguous slice, and gathers the frames onto the first
card. The traffic's `chunk` is that multiple (the number of cards), so that
no clip length is one and each antithetic pair of lengths pads the same
number of frames. A clip's latency, from its request to its frames on the
host, is its one delivery, and the window closes at the delivery of the clip
in flight when its seconds are up.

After the window, each card's slice of one seeded clip of the window (the
clips check the cards in turn, and a seeded one of each card's is kept) is
worked out again by the plain reference, its skinning at the batch that card
ran and the rest in blocks of 8 frames, and compared.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np
import torch

from portbench.drivers.imitate import (Program, compare, flops_per_frame, generator_weights,
                                       reference_generator, span)
from portbench.lib import trace as tr
from portbench.lib.runner import device_info, peak_bytes, quantile, sync, tf32
from portbench.lib.traffic import Requests, lengths_drawn, motion, rng_of, subject
from portbench.reference import body as body_ref
from portbench.reference import geometry as geo
from portbench.reference import imitate as ref_imit

BLOCK = 8  # the reference's generator batch, and the batch of the cross-batch gap


def cell_devices(device, chips: int) -> list:
    """The cell's cards, `cuda:0` first; on the host (the benchmark's tests)
    the CPU `chips` times, which `sharded_synthesize` takes."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [device] * chips


def shard_batches(traffic: dict, chips: int) -> list:
    """Every batch a card runs in this mix: each clip length the mix draws,
    padded to a multiple of the cards, over the cards."""
    return sorted({-(-n // chips) for n in lengths_drawn(traffic["clip_frames"], traffic["chunk"])})


def slice_rows(n: int, chips: int, card: int) -> tuple[int, int, int]:
    """(first row, rows the card ran, real frames among them) of card's slice
    of a clip of n frames padded to a multiple of `chips`."""
    per = -(-n // chips)
    return card * per, per, max(0, min(per, n - card * per))


class Sample:
    """A seeded sample of the window's requests, one a card, drawn as the
    requests come: request i gets a seeded key, and each card keeps, with
    its slice, the request of smallest key among those it is checked on, so
    that every card's slice is compared and only one slice a card is held."""

    def __init__(self, seed: int):
        self.seed, self.kept = seed, {}

    def offer(self, i: int, card: int, frames) -> None:
        key = float(rng_of(self.seed, 7, i).random())
        if card not in self.kept or key < self.kept[card][0]:
            self.kept[card] = (key, i, frames)

    def items(self) -> dict:
        """{request: (card, frames)}."""
        return {i: (card, frames) for card, (_, i, frames) in self.kept.items()}


def checked_card(seed: int, i: int, chips: int) -> int:
    """The card whose slice of request i the run compares: the cards in turn
    from a seeded first, so that any `chips` requests in a row cover them."""
    return (i + int(rng_of(seed, 8).integers(0, chips))) % chips


def host_buffer(traffic: dict, size: int, device) -> torch.Tensor:
    """The client's host memory for one clip's frames, made once: pinned
    where the frames come from a card."""
    shape = (traffic["clip_frames"]["max"], size, size, 3)
    return torch.empty(shape, dtype=torch.float32, pin_memory=device.type == "cuda")


def request(prog: Program, devices: list, clip: np.ndarray, host: torch.Tensor, spans=None) -> np.ndarray:
    """One clip: its frames (n, S, S, 3), a view of the host buffer."""
    from ipercore_tpu_torch.parallel.inference import sharded_synthesize

    with span(spans, "prepare_target_smpls"):
        smpls = prog.imit.prepare_target_smpls(prog.model, prog.cache, clip, cam_strategy="smooth")
    with span(spans, "sharded_synthesize"):
        preds, _ = sharded_synthesize(prog.comp, prog.gen, prog.cache, smpls, devices=devices)
    with span(spans, "fetch"):
        host[:len(clip)].copy_(preds)
    return host[:len(clip)].numpy()


def window(prog: Program, devices: list, host: torch.Tensor, reqs: Requests, seconds: float,
           trace: bool, sample: Sample) -> dict:
    """The measured window: clips in a closed loop until `seconds` have
    passed, and the window closes when the clip then in flight is delivered.
    A clip is delivered whole, so the window ends at a delivery: every clip
    it started counts, over the window's whole length."""
    chips = len(devices)
    spans = tr.Spans() if trace else None
    prof = tr.Profiler(devices) if trace else None
    out = {"latency_s": [], "frames": 0, "window_s": 0.0, "traced": None}
    traced = {"requests": [], "kernels": [], "spans": [], "window_s": 0.0}
    if prof is not None:  # before the window: the tracer's start-up takes seconds
        prof.start()
    for d in devices:
        sync(d)
    t0 = time.perf_counter()
    t_end = t0 + seconds
    tracing = prof is not None
    i = 0
    while time.perf_counter() < t_end:
        clip = reqs.clip(i)
        t_req = time.perf_counter()
        with span(spans, "request"):
            frames = request(prog, devices, clip, host, spans)
        t_done = time.perf_counter()
        n = len(clip)
        out["latency_s"].append(t_done - t_req)
        out["frames"] += n
        out["window_s"] = t_done - t0
        card = checked_card(prog.seed, i, chips)
        first, _, real = slice_rows(n, chips, card)
        sample.offer(i, card, frames[first:first + real].copy())
        if tracing:
            traced["requests"].append(n)
            if time.perf_counter() - t0 >= prog.traffic["trace_seconds"] or time.perf_counter() >= t_end:
                traced["kernels"], t_stop = prof.stop()
                traced["window_s"] = t_stop - t0
                traced["spans"] = spans.closed()
                tracing = False
        del frames
        i += 1
    out["traced"] = traced if trace else None
    return out


def reference_slices(config: dict, traffic: dict, seed: int, device, picks: dict, chips: int,
                     body_np: dict, mesh_np: dict) -> tuple[dict, dict]:
    """The reference's frames of the picked slices {request: card}: each
    slice's skinning at the batch its card ran (`sharded_synthesize`'s
    padding and split), the rest in blocks of 8; and, for the cross-batch
    gap, the first 8 of its frames whose vertices move when the skinning runs
    in the chunks of 8 that one card streaming the clip would run, as
    (indices in the slice, frames; None where no vertex moves)."""
    reqs = Requests(traffic, seed)
    S, ns = config["image_size"], config["num_source"]
    with torch.no_grad():
        body = geo.Body(body_np, device)
        comp = ref_imit.Composer(body, mesh_np, S, **config["composer"])
        gen = reference_generator(config, device)
        gen.load_state_dict(generator_weights(config, seed, device), strict=True)
        img, smpl = subject(seed, 0, S, ns, traffic["source"], device)
        src = ref_imit.setup_source(comp, gen, img, smpl)
        out, at8 = {}, {}
        for i, card in sorted(picks.items()):
            smpls = ref_imit.prepare_target_smpls(comp, src, reqs.clip(i))
            n = len(smpls)
            rows = torch.as_tensor(np.concatenate([smpls, np.repeat(smpls[-1:], (-n) % chips, axis=0)]),
                                   device=device)
            first, per, real = slice_rows(n, chips, card)
            fv = geo.face_verts_of(body, rows[first:first + per])
            out[i] = ref_imit.synthesize_faces(comp, gen, src, fv, BLOCK)[:real].cpu().numpy()
            rows8 = torch.as_tensor(np.concatenate([smpls, np.repeat(smpls[-1:], (-n) % BLOCK, axis=0)]),
                                    device=device)
            lo = first - first % BLOCK
            fv8 = torch.cat([geo.face_verts_of(body, rows8[a:a + BLOCK])
                             for a in range(lo, first + real, BLOCK)])[first - lo:first - lo + real]
            moved = (fv8 != fv[:real]).flatten(1).any(dim=1).nonzero().flatten()[:BLOCK]
            at8[i] = (moved.cpu().numpy(), ref_imit.synthesize_faces(comp, gen, src, fv8[moved]).cpu().numpy()
                      if len(moved) else None)
    return out, at8


def control(cell, seed: int, device, n_requests: int) -> dict:
    """The control: the reference in the program's place, computed in TF32
    (the precision below the configuration's float32 with TF32 off), on the
    checked slices of the mix's first `n_requests` requests, compared as a
    run compares the program."""
    config, traffic, chips = cell.config, cell.traffic, cell.chips
    body_np = body_ref.body_arrays()
    mesh_np = body_ref.mesh_arrays(body_np)
    picks = {i: checked_card(seed, i, chips) for i in range(n_requests)}
    with tf32(False):
        want, _ = reference_slices(config, traffic, seed, device, picks, chips, body_np, mesh_np)
    with tf32(True):
        got, _ = reference_slices(config, traffic, seed, device, picks, chips, body_np, mesh_np)
    return compare(got, want)


def warm(prog: Program, devices: list, host: torch.Tensor, seed: int) -> None:
    """Every batch a card runs in this mix, on every card, longest first:
    `synthesize_frames` on a replica made once per card, as the sharded call
    runs it on its slice, each batch enqueued on every card before the next;
    then the longest and the shortest clip through the whole sharded call.
    Every shape of the window is built before it, at the cost of one call's
    compute a batch and not of one call's replicas too."""
    from ipercore_tpu_torch.parallel.mesh import replicate

    traffic, chips = prog.traffic, len(devices)
    clip = motion(rng_of(seed ^ 0x5EED, 3, 0), traffic["clip_frames"]["max"], traffic["motion"])
    smpls = prog.imit.prepare_target_smpls(prog.model, prog.cache, clip, cam_strategy="smooth")
    smpls = torch.as_tensor(smpls, device=devices[0])
    replicas = {d: (replicate(prog.comp, d), replicate(prog.gen, d), replicate(prog.cache, d))
                for d in dict.fromkeys(devices)}
    for per in sorted(shard_batches(traffic, chips), reverse=True):
        for d, rep in replicas.items():
            with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
                prog.imit.synthesize_frames(*rep, smpls[:per].to(d))
    for d in replicas:
        sync(d)
    del replicas
    for n in (traffic["clip_frames"]["max"], traffic["clip_frames"]["min"]):
        request(prog, devices, clip[:n], host)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> tuple:
    config, traffic = cell.config, cell.traffic
    devices = cell_devices(device, cell.chips)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    marks = [("start", time.perf_counter())]
    body_np = body_ref.body_arrays()
    mesh_np = body_ref.mesh_arrays(body_np)
    reqs = Requests(traffic, seed)
    marks.append(("inputs", time.perf_counter()))

    # set-up: the program and the subject on the first card, then every
    # batch a card will run, on every card
    prog = Program(config, traffic, seed, devices[0], body_np, mesh_np)
    prog.cache = prog.setup_source(0)
    sync(devices[0])
    marks.append(("program and source", time.perf_counter()))
    host = host_buffer(traffic, config["image_size"], device)
    warm(prog, devices, host, seed)
    for d in devices:
        sync(d)
    marks.append(("warm", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print("set-up: imports %.2f s; " % (marks[0][1] - t_start) + "; ".join(
        f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:])), file=sys.stderr)

    sample = Sample(seed)
    w = window(prog, devices, host, reqs, seconds, trace, sample)
    peak = peak_bytes(devices)

    # the program's state goes before the reference runs
    del prog, host
    gc.collect()
    if device.type == "cuda":
        for d in devices:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
    kept = sample.items()
    picks = {i: card for i, (card, _) in kept.items()}
    t_ref = time.perf_counter()
    want, at8 = reference_slices(config, traffic, seed, device, picks, cell.chips, body_np, mesh_np)
    print(f"reference: {len(picks)} slices, {sum(len(v) for v in want.values())} frames in "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    got = {i: frames for i, (_, frames) in kept.items()}
    for i in sorted(picks):
        idx, frames8 = at8[i]
        gap = float(np.abs(got[i][idx].astype(np.float64) - frames8).max()) if len(idx) else 0.0
        print(f"request {i} card {picks[i]}: largest gap over {len(idx)} frames to the same frames "
              f"with the skinning in chunks of {BLOCK}: {gap!r} (no limit)", file=sys.stderr)
    numbers = compare(got, want)
    limits = config["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": len(w["latency_s"]), "failed": 0,
              "metrics": {}, "device": device_info(devices, peak)}
    if not trace:
        values = {"frames_per_s": w["frames"] / w["window_s"],
                  "chunk_gap_ms_p95": 1e3 * quantile(w["latency_s"], 0.95),
                  "setup_s": setup_s}
        print(f"clips in the window: {len(w['latency_s'])}; frames {w['frames']}; "
              f"window {w['window_s']:.3f} s", file=sys.stderr)
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items() if k in units}
        return result, checks

    t = w["traced"]
    n_dev = len(set(devices))
    frame_flops, _ = flops_per_frame(config)
    counters = {"requests": len(t["requests"]), "frames": sum(t["requests"]),
                "frames_computed": sum(-(-n // cell.chips) * cell.chips for n in t["requests"]),
                "frame_flops": frame_flops}
    run_ = tr.Run(cell=cell.name, config=config, traffic=traffic, counters=counters,
                  kernels=t["kernels"], spans=t["spans"], window_s=t["window_s"], devices=n_dev)
    result["device"]["busy_s"] = tr.busy_seconds(t["kernels"], n_dev)
    result["device"]["window_s"] = t["window_s"]
    result["breakdown"] = {"device_ops": tr.top_device_ops(t["kernels"]),
                           "idle_gaps": tr.idle_gaps(t["kernels"], t["spans"], devices=n_dev)}
    result["run"] = run_
    return result, checks
