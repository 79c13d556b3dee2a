"""Personalization traffic: the port's train step in a closed loop, as
`services/personalization.personalize` calls it, fed from a subject pool
that set-up makes on the device from the seed.

Set-up builds the one train state, drives it through its first
`check.steps` steps on the feed (rows that all differ) and hands that same
state to the window. After the window the plain reference follows those
first steps from the same weights and batches, and the run compares the
first step's losses, the first gradient as the optimizer got it (from its
first moment after one step), and the parameters' change over the first
steps, leaf by leaf. The later steps' losses are not compared: Adam turns
rounding noise in a gradient into a step of full size, so their gap grows
from step to step on sound runs.
"""
from __future__ import annotations

import gc
import sys
import time
import warnings

import numpy as np
import torch

from portbench.lib import trace as tr
from portbench.lib import yardstick as ys
from portbench.lib.port import body_and_assets
from portbench.lib.runner import device_info, peak_bytes, sync, tf32
from portbench.lib.traffic import motion, rng_of
from portbench.lib.weights import seeded_state_dict
from portbench.reference import body as body_ref
from portbench.reference import geometry as geo
from portbench.reference import losses as ref_losses
from portbench.reference.generator import LWBGenerator as RefGenerator
from portbench.reference.imitate import Composer
from portbench.reference.train import Trainer

NETS = ("G", "D", "vgg", "face")


def reference_nets(config: dict, device) -> dict:
    """The reference modules of the four networks (frozen loss networks)."""
    nets = {"G": RefGenerator(config["Generator"], config["fusion"]),
            "D": ref_losses.GlobalD(config["Discriminator"]),
            "vgg": ref_losses.VGG(), "face": ref_losses.Sphere20a()}
    nets = {k: v.to(device) for k, v in nets.items()}
    for k in ("vgg", "face"):
        nets[k].eval().requires_grad_(False)
    return nets


def net_weights(config: dict, seed: int, device) -> dict:
    """Seeded state dicts of the four networks, made on the device."""
    with torch.device("meta"):
        shapes = reference_nets(config, "meta")
    return {k: seeded_state_dict(m, int(rng_of(seed, 8, i).integers(0, 2 ** 63)), device)
            for i, (k, m) in enumerate(shapes.items())}


def silhouettes(body: geo.Body, theta: torch.Tensor, size: int) -> torch.Tensor:
    """Person masks (N, S, S, 1), background 1: the projected vertices
    splatted on a grid of 8-pixel cells, dilated by one cell."""
    n, cells = theta.shape[0], size // 8
    xy = geo.project(geo.verts_of(body, theta), theta[:, 0:3])[..., 0:2]
    ij = ((xy + 1.0) * 0.5 * cells).floor().long().clamp(0, cells - 1)
    grid = torch.zeros((n, cells * cells), device=theta.device)
    grid.scatter_(1, ij[..., 1] * cells + ij[..., 0], 1.0)
    grid = torch.nn.functional.max_pool2d(grid.reshape(n, 1, cells, cells), 3, stride=1, padding=1)
    sil = torch.nn.functional.interpolate(grid, scale_factor=8, mode="nearest")
    return (1.0 - sil).permute(0, 2, 3, 1).contiguous()


class Pool:
    """The subject's frames on the device: images, SMPLs, person masks and
    a background. Frames 0 .. ns-1 are the source views (the body turned by
    360 / ns degrees each); the others follow a seeded motion."""

    def __init__(self, traffic: dict, body: geo.Body, seed: int, size: int, ns: int, device):
        p = traffic["pool"]
        n = p["frames"]
        rng = rng_of(seed, 9)
        theta = motion(rng, n, traffic["motion"])
        theta[:, 0] = p["cam_scale"]
        theta[:, 1:3] = rng.uniform(-0.05, 0.05, size=2)
        theta[:ns, 3:6] = 0.0
        theta[:ns, 4] = np.arange(ns) * (2 * np.pi / ns)
        self.smpls = torch.as_tensor(theta, device=device)
        g = torch.Generator(device=device).manual_seed(int(rng.integers(0, 2 ** 63)))
        low = torch.randn((n + 1, 3, 16, 16), generator=g, device=device)
        img = torch.nn.functional.interpolate(low, size=(size, size), mode="bicubic", align_corners=False)
        img = img + 0.1 * torch.randn((n + 1, 3, size, size), generator=g, device=device)
        img = torch.tanh(img).clamp(-1.0, 1.0).permute(0, 2, 3, 1).contiguous()
        self.images, self.bg = img[:n], img[n:]
        self.masks = silhouettes(body, self.smpls, size)
        self.ns = ns
        self.order = np.concatenate([rng_of(seed, 10, k).permutation(n) for k in range(64)])

    def batch(self, k: int) -> dict:
        """Batch k: the source views and the k-th target of the seeded feed,
        in the shapes `make_personalized_batches` yields."""
        t = int(self.order[k % len(self.order)])
        rows = lambda a: torch.cat([a[:self.ns], a[t:t + 1]])[None]  # slices: no host sync
        return {"images": rows(self.images), "smpls": rows(self.smpls), "masks": rows(self.masks),
                "bg": self.bg}


def leaf_norms(tensors: dict) -> dict:
    names = list(tensors)
    norms = torch.stack([tensors[k].double().norm() for k in names]).cpu().numpy()
    return dict(zip(names, norms.tolist()))


def worst_gap(prog: dict, ref: dict, keep: list) -> float:
    """Largest |prog - ref| over the kept leaves, each against the larger of
    its reference norm and the median leaf's."""
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def host_syncs(fn, device) -> int:
    """Host syncs that one `fn()` makes, by torch's sync debug mode (its
    one-time notice that the mode is a prototype is not counted); none on
    the host."""
    if device.type != "cuda":
        fn()
        return 0
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message).lower() and "prototype" not in str(w.message).lower()
               for w in caught)


class Program:
    """The port's train rig for a cell: composer, the four networks, the
    train config and the train state."""

    def __init__(self, config: dict, seed: int, device, body_np: dict, mesh_np: dict, weights: dict):
        from ipercore_tpu_torch.models import flow_composition as fc
        from ipercore_tpu_torch.models.networks import build_discriminator, build_generator
        from ipercore_tpu_torch.models.networks import criterions as C
        from ipercore_tpu_torch.trainers import lwg_trainer as T

        self.T = T
        model, assets = body_and_assets(body_np, mesh_np, device)
        self.comp = fc.make_composer(model, assets, image_size=config["image_size"], **config["composer"])
        self.gen = build_generator(config["generator"], config["Generator"],
                                   num_source=config["num_source"], device=device)
        self.dis = build_discriminator(config["discriminator"], config["Discriminator"], device=device)
        self.vgg = C.build_vgg(device=device)
        self.face, _ = C.build_face_net("sphere20a", device=device)
        for k, net in zip(NETS, (self.gen, self.dis, self.vgg, self.face)):
            net.load_state_dict(weights[k], strict=True)
        tr_ = config["train"]
        self.cfg = T.TrainConfig(
            lambda_rec=tr_["lambda_rec"], lambda_tsf=tr_["lambda_tsf"], lambda_face=tr_["lambda_face"],
            lambda_mask=tr_["lambda_mask"], lambda_mask_smooth=tr_["lambda_mask_smooth"],
            lambda_d_prob=tr_["lambda_D_prob"], lr_g=tr_["lr_G"], lr_d=tr_["lr_D"],
            use_face=tr_["use_face"])
        self.ns = config["num_source"]
        self.state = T.create_train_state(self.gen, self.dis, self.cfg)

    def step(self, batch: dict) -> dict:
        self.state, metrics = self.T.train_step(self.state, batch, self.comp, self.gen, self.dis,
                                                self.vgg, self.face, self.cfg, ns=self.ns)
        return metrics


def first_steps(prog: Program, pool: Pool, n: int) -> dict:
    """The state's first n steps on the feed's first n batches: each step's
    losses, the first gradient's leaf norms (the first moment after one step
    over 1 - b1) and the parameters after the n steps, on the host."""
    out = {"losses": []}
    for k in range(n):
        m = prog.step(pool.batch(k))
        out["losses"].append({"g_total": float(m["g_total"]), "d_total": float(m["d_total"])})
        if k == 0:
            one = 1.0 - prog.T.B1
            out["grad_G"] = leaf_norms({n_: v / one for n_, v in prog.state.opt_G.mu.items()})
            out["grad_D"] = leaf_norms({n_: v / one for n_, v in prog.state.opt_D.mu.items()})
    out["params_G"] = {k: v.detach().cpu() for k, v in prog.state.params_G.items()}
    out["params_D"] = {k: v.detach().cpu() for k, v in prog.state.params_D.items()}
    return out


def reference_steps(config: dict, traffic: dict, seed: int, device, body_np: dict, mesh_np: dict,
                    n: int) -> dict:
    """The reference's first n steps from the same weights and batches."""
    body = geo.Body(body_np, device)
    comp = Composer(body, mesh_np, config["image_size"], **config["composer"])
    nets = reference_nets(config, device)
    weights = net_weights(config, seed, device)
    for k, net in nets.items():
        net.load_state_dict(weights[k], strict=True)
    start = {k: {n_: v.detach().clone() for n_, v in nets[k].named_parameters()} for k in ("G", "D")}
    pool = Pool(traffic, body, seed, config["image_size"], config["num_source"], device)
    trainer = Trainer(comp, nets["G"], nets["D"], nets["vgg"], nets["face"], config["train"],
                      config["num_source"])
    out = {"losses": []}
    for k in range(n):
        r = trainer.step(pool.batch(k))
        out["losses"].append({"g_total": r["g_total"], "d_total": r["d_total"]})
        if k == 0:
            out["grad_G"] = leaf_norms(dict(zip([n_ for n_, _ in nets["G"].named_parameters()], r["g_grads"])))
            out["grad_D"] = leaf_norms(dict(zip([n_ for n_, _ in nets["D"].named_parameters()], r["d_grads"])))
    for k in ("G", "D"):
        out[f"change_{k}"] = leaf_norms({n_: v.detach() - start[k][n_] for n_, v in nets[k].named_parameters()})
    return out, start


def program_changes(first: dict, start: dict) -> dict:
    """The program's leaf norms of the parameters' change over its first steps."""
    out = dict(first)
    for net in ("G", "D"):
        dev = next(iter(start[net].values())).device
        out[f"change_{net}"] = leaf_norms(
            {k: first[f"params_{net}"][k].to(dev) - start[net][k] for k in start[net]})
    return out


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: the larger relative gap of the first step's G
    and D losses, and of the leaf norms of the first gradient and of the
    change over the first steps, each leaf's gap against the larger of its reference norm and the
    median leaf's. Leaves whose reference gradient is under a thousandth of
    the median leaf's (biases under an instance norm, whose gradient is zero
    to rounding) are left out of the gradient and change numbers, by that
    rule and not by name."""
    p, r = prog["losses"][0], ref["losses"][0]
    loss = max(abs(p[k] - r[k]) / abs(r[k]) for k in ("g_total", "d_total"))
    grad, change = 0.0, 0.0
    for net in ("G", "D"):
        g_ref = ref[f"grad_{net}"]
        med = float(np.median(list(g_ref.values())))
        keep = [k for k, v in g_ref.items() if v >= 1e-3 * med]
        grad = max(grad, worst_gap(prog[f"grad_{net}"], g_ref, keep))
        change = max(change, worst_gap(prog[f"change_{net}"], ref[f"change_{net}"], keep))
    return {"first_loss_rel_gap": loss, "grad_norm_gap": grad, "update_norm_gap": change}


def control(cell, seed: int, device, n_steps: int) -> dict:
    """The control: the reference in the program's place, computed in TF32
    (the precision below the configuration's float32 with TF32 off), over
    the first steps, compared as a run compares the program."""
    body_np = body_ref.body_arrays()
    mesh_np = body_ref.mesh_arrays(body_np)
    n = n_steps or cell.traffic["check"]["steps"]
    with tf32(False):
        ref, _ = reference_steps(cell.config, cell.traffic, seed, device, body_np, mesh_np, n)
    with tf32(True):
        low, _ = reference_steps(cell.config, cell.traffic, seed, device, body_np, mesh_np, n)
    return compare(low, ref)


def step_flops(config: dict) -> float:
    """Nominal operations of one train step: a network whose weights train
    counts 3 times its forward, a frozen one that passes a gradient back 2
    times, a forward with no gradient once. G (background, sources with their
    decoder, the targets) trains; D runs frozen on the fake in G's loss and
    trains on the fake and the real in its own step; VGG19 and Sphere20a pass
    the fake's gradient back and see the real without one. G is counted at
    64^2 on the host and scaled by area; the others at their own sizes on the
    meta device."""
    S, ns = config["image_size"], config["num_source"]
    S0 = 64
    gen = RefGenerator(config["Generator"], config["fusion"]).eval()
    g0 = ys.count_flops(gen, lambda: gen.forward_train(
        torch.zeros(1, 1, S0, S0, 4), torch.zeros(1, ns, S0, S0, 6), torch.zeros(1, 1, S0, S0, 6),
        torch.zeros(1, 1, ns, S0, S0, 2))) * (S / S0) ** 2
    with torch.device("meta"):
        nets = reference_nets(config, "meta")
        d = ys.count_flops(nets["D"], lambda: nets["D"](torch.zeros(1, S, S, 6)))
        v = ys.count_flops(nets["vgg"], lambda: nets["vgg"](torch.zeros(1, S, S, 3)))
        f = ys.count_flops(nets["face"], lambda: nets["face"](torch.zeros(1, 112, 96, 3)))
    return 3 * g0 + 2 * d + 3 * 2 * d + 3 * v + 3 * f


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> tuple:
    config, traffic = cell.config, cell.traffic
    n_first = traffic["check"]["steps"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    body_np = body_ref.body_arrays()
    mesh_np = body_ref.mesh_arrays(body_np)
    prog = Program(config, seed, device, body_np, mesh_np, net_weights(config, seed, device))
    pool = Pool(traffic, geo.Body(body_np, device), seed, config["image_size"], config["num_source"], device)
    first = first_steps(prog, pool, n_first)
    sync(device)
    setup_s = time.perf_counter() - t_start

    prof = tr.Profiler(device) if trace else None
    if prof is not None:
        prof.start()
    sync(device)
    t0 = time.perf_counter()
    k = n_first
    traced = None
    while time.perf_counter() < t0 + seconds:
        prog.step(pool.batch(k))
        k += 1
        if prof is not None and time.perf_counter() - t0 >= traffic["trace_seconds"]:
            break  # a traced run reports the traced steps alone
    sync(device)
    window_s = time.perf_counter() - t0
    steps = k - n_first
    if prof is not None:
        kernels, t_stop = prof.stop()
        traced = {"kernels": kernels, "window_s": t_stop - t0, "steps": steps, "first": n_first}
    if trace:
        batch = pool.batch(k)
        syncs = host_syncs(lambda: prog.step(batch), device)
    peak = peak_bytes(device)

    del prog, pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref, start = reference_steps(config, traffic, seed, device, body_np, mesh_np, n_first)
    numbers = compare(program_changes(first, start), ref)
    print(f"reference: {n_first} steps in {time.perf_counter() - t_ref:.1f} s; losses "
          f"{first['losses']} against {ref['losses']}", file=sys.stderr)
    limits = config["limits"]
    checks = {k_: {"value": v, "limit": limits[k_]} for k_, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": steps, "failed": 0, "metrics": {},
              "device": device_info(device, peak)}
    if not trace:
        print(f"steps in the window: {steps} in {window_s:.3f} s", file=sys.stderr)
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = {"train_steps_per_s": steps / window_s, "setup_s": setup_s}
        result["metrics"] = {k_: {"value": v, "unit": units[k_]} for k_, v in values.items() if k_ in units}
        return result, checks

    body = geo.Body(body_np, device)
    pool = Pool(traffic, body, seed, config["image_size"], config["num_source"], device)
    S, ns = config["image_size"], config["num_source"]
    k3 = 0.0
    with torch.no_grad():
        for b in range(traced["first"], traced["first"] + traced["steps"]):
            theta = pool.batch(b)["smpls"][0]
            k3 += ys.raster_fim_bound_s(geo.face_verts_of(body, theta[:ns]), S)
            k3 += ys.raster_fim_bound_s(geo.face_verts_of(body, theta[ns:]), S)
    counters = {"steps": traced["steps"], "host_syncs_per_step": syncs,
                "step_flops": step_flops(config), "k3_bound_s": k3}
    run_ = tr.Run(cell=cell.name, config=config, traffic=traffic, counters=counters,
                  kernels=traced["kernels"], spans=[], window_s=traced["window_s"])
    result["device"]["busy_s"] = tr.busy_seconds(traced["kernels"])
    result["device"]["window_s"] = traced["window_s"]
    result["breakdown"] = {"device_ops": tr.top_device_ops(traced["kernels"]),
                           "idle_gaps": tr.idle_gaps(traced["kernels"], [])}
    result["run"] = run_
    return result, checks
