"""Runs a JAX training driver of `scripts/` in-process up to its first update
and hands back what it computed, for the port's driver tests (holds no test).

`run_jax_script(name, argv, until)` imports `scripts/<name>.py` and calls its
`main()` with `argv`, with:

  * every `jax.random` sampler recorded in call order (kind, shape, value;
    inside a jitted function through an ordered `jax.debug.callback`), and
    every call of a `jax.jit`-wrapped function marked in the same log, so
    the draws of one batch maker can be replayed to the port
    (`draws_between`, `Replay`);
  * `jax.value_and_grad`'s function kept, with the values of its arguments
    and its result (the driver's own loss and gradient on its batch);
  * `optax.apply_updates`' parameters and updates kept;
  * the run stopped when the jitted function named `until` returns (or,
    with `before=True`, when it is called, its arguments kept);
  * the template body replaced by the small synthetic one, and its assets by
    synthetic ones, as the drivers' own `--smoke` runs do where they take it.
"""
from __future__ import annotations

import functools
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import optax

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
KINDS = ("uniform", "normal", "bernoulli", "randint", "dirichlet")
NU, NV = 16, 14  # the drivers' --smoke body


class Stop(Exception):
    pass


def _name(fn) -> str:
    if isinstance(fn, functools.partial):
        return _name(fn.func)
    return getattr(fn, "__name__", type(fn).__name__)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def run_jax_script(name: str, argv: list[str], until: str, before: bool = False, path: str | None = None) -> dict:
    """Returns {"log": [...], "loss_fn": (fn, value_and_grad kwargs),
    "vg": (args, result) as numpy trees, "updates": (params, updates) as
    numpy trees, "stopped": (args, fn) of `until` when `before`}. `path`:
    the driver's file when it is not `scripts/<name>.py` (a copy whose
    repository root is a temporary directory)."""
    from ipercore_tpu.models import mesh as jmesh
    from ipercore_tpu.models import smpl as jsmpl

    spec = importlib.util.spec_from_file_location(f"jax_driver_{name}",
                                                  path or os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = {"log": [], "loss_fn": None, "vg": None, "updates": None, "stopped": None, "until": None}
    log = out["log"]
    real_jit, real_vg, real_apply = jax.jit, jax.value_and_grad, optax.apply_updates
    real_load_assets = jmesh.load_assets

    def jit(fn=None, **kw):
        if fn is None:
            return lambda f: jit(f, **kw)
        jitted = real_jit(fn, **kw)

        def call(*a, **k):
            log.append(("call", _name(fn)))
            if before and _name(fn) == until:
                out["stopped"] = (a, fn)
                raise Stop
            res = jitted(*a, **k)
            jax.effects_barrier()  # the callbacks of this call land before the next marker
            if _name(fn) == until:
                out["until"] = (a, fn)
                raise Stop
            return res

        return call

    def value_and_grad(fn, **kw):
        inner = real_vg(fn, **kw)

        def call(*a):
            res = inner(*a)
            out["loss_fn"] = (fn, kw)
            jax.debug.callback(lambda a_, r_: out.__setitem__("vg", (_host(a_), _host(r_))), a, res,
                               ordered=True)
            return res

        return call

    def apply_updates(params, updates):
        jax.debug.callback(lambda p, u: out.__setitem__("updates", (_host(p), _host(u))), params, updates,
                           ordered=True)
        return real_apply(params, updates)

    def record(kind, v):
        log.append(("draw", kind, tuple(v.shape), np.asarray(v)))

    with pytest.MonkeyPatch.context() as m:
        for kind in KINDS:
            def wrap(*a, _orig=getattr(jax.random, kind), _kind=kind, **kw):
                v = _orig(*a, **kw)
                if isinstance(v, jax.core.Tracer):
                    jax.debug.callback(functools.partial(record, _kind), v, ordered=True)
                else:
                    record(_kind, v)
                return v

            m.setattr(jax.random, kind, wrap)
        m.setattr(jax, "jit", jit)
        m.setattr(jax, "value_and_grad", value_and_grad)
        m.setattr(optax, "apply_updates", apply_updates)
        m.setattr(jsmpl, "template_model", lambda *a, **k: jsmpl.synthetic_model(nu=NU, nv=NV))
        m.setattr(jmesh, "load_assets", lambda model, *a, **k: real_load_assets(
            model, uv_map_path="/nonexistent", part_path="/nonexistent"))
        m.setattr(sys, "argv", [f"{name}.py"] + list(argv))
        try:
            mod.main()
        except Stop:
            pass
        else:
            raise AssertionError(f"{name} ran to its end without calling {until}")
    return out


def closure_of(fn, name: str):
    """The variable `name` that the function `fn` closes over."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))[name]


def eager_with_draws(fn, *args):
    """(fn(*args) run op by op (functions it calls that are jitted stay
    so), its `jax.random` draws in call order)."""
    draws = []
    with pytest.MonkeyPatch.context() as m:
        for kind in KINDS:
            def wrap(*a, _orig=getattr(jax.random, kind), _kind=kind, **kw):
                v = _orig(*a, **kw)
                draws.append((_kind, tuple(v.shape), np.asarray(v)))
                return v

            m.setattr(jax.random, kind, wrap)
        res = fn(*args)
    return res, draws


def draws_of_calls(log: list, name: str, end: str) -> list:
    """The draws from the first call of `name` (a pool rendered chunk by
    chunk) up to the first call of `end` (jitted functions that `name` calls
    while it is traced mark the log too, and are passed over)."""
    i0 = next(i for i, e in enumerate(log) if e[0] == "call" and e[1] == name)
    draws = []
    for e in log[i0:]:
        if e[0] == "call" and e[1] == end:
            break
        if e[0] == "draw":
            draws.append(e[1:])
    return draws


def load_jax_script(name: str):
    """The JAX driver `scripts/<name>.py` as a module (its `main()` not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name.replace('/', '_')}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def draws_between(log: list, start: str, end: str | None = None, nth: int = 0) -> list:
    """The draws after the `nth` call of `start` and before the next call of
    `end` (or of `start`), as (kind, shape, value)."""
    seen, i0 = -1, None
    for i, e in enumerate(log):
        if e[0] == "call" and e[1] == start:
            seen += 1
            if seen == nth:
                i0 = i + 1
                break
    assert i0 is not None, f"no call {nth} of {start}"
    draws = []
    for e in log[i0:]:
        if e[0] == "call" and e[1] in (start, end):
            break
        if e[0] == "draw":
            draws.append(e[1:])
    return draws


class Replay:
    """A `Draws`-shaped object that hands back recorded JAX draws in order,
    checking each call's kind and shape."""

    device = torch.device("cpu")

    def __init__(self, draws):
        self.draws, self.i = draws, 0

    def _next(self, kind, shape):
        assert self.i < len(self.draws), f"the port drew more than JAX's {len(self.draws)} times"
        k, s, v = self.draws[self.i]
        assert (kind, tuple(shape)) == (k, s), f"draw {self.i}: port {kind}{tuple(shape)}, JAX {k}{s}"
        self.i += 1
        return torch.as_tensor(np.array(v))

    def uniform(self, shape, lo=0.0, hi=1.0):
        return self._next("uniform", shape)

    def normal(self, shape):
        return self._next("normal", shape)

    def bernoulli(self, p, shape):
        return self._next("bernoulli", shape)

    def randint(self, shape, lo, hi):
        return self._next("randint", shape)

    def dirichlet(self, alpha, shape):
        return self._next("dirichlet", tuple(shape) + (len(alpha),))

    def used_up(self) -> bool:
        return self.i == len(self.draws)


def within_of_largest(got, want, tol: float = 1e-5) -> float:
    """Largest |got - want| over want's largest magnitude; asserts it is
    within `tol`."""
    a = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    b = np.asarray(want, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
    assert err <= tol, err
    return err


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def grads_against_jax(net, loss_of, jgrads_torch: dict) -> dict:
    """The port's f32 gradient of `loss_of(module, dtype)` against JAX's (in
    the port's layout), relative L2 over all parameters: within 1e-4, or,
    where f32 itself is further from the exact gradient than that (a deep
    net from seeded weights), the port at least as close to its float64
    gradient (a float64 copy of `net`) as JAX is, times 1.5, and within 1e-2
    of JAX. Computed with torch's oneDNN CPU convolutions off: their f32
    gradients land about 1e-3 from float64 on these nets (torch's plain
    convolutions 2e-6, XLA's 2e-7)."""
    import copy

    from ipercore_tpu_torch.scripts import _common as cm

    cat = lambda d: np.concatenate([np.asarray(d[k].detach().cpu(), np.float64).ravel() for k in jgrads_torch])
    with torch.backends.mkldnn.flags(enabled=False):
        g_t = cat(cm.grads_of(net, loss_of(net, torch.float32)))
    g_j = cat(jgrads_torch)
    out = {"port_vs_jax": rel_l2(g_t, g_j)}
    if out["port_vs_jax"] > 1e-4:
        net64 = copy.deepcopy(net).double()
        g_64 = cat(cm.grads_of(net64, loss_of(net64, torch.float64)))
        out.update(port_vs_f64=rel_l2(g_t, g_64), jax_vs_f64=rel_l2(g_j, g_64))
        assert out["port_vs_f64"] <= 1.5 * out["jax_vs_f64"] and out["port_vs_jax"] <= 1e-2, out
    return out


def drawn_clip(n: int, h: int, w: int, seed: int, scene: int = 256) -> np.ndarray:
    """(n, h, w, 3) frames in [-1, 1] of a static camera: one scene of the
    segmenter's training distribution (`compose_scene` on the template body
    at scene², resized to h²) whose person walks from the left edge to the
    right one over the scene's background plate (resized to h x w)."""
    from ipercore_tpu_torch.data.datasets import resize_linear
    from ipercore_tpu_torch.models import smpl as tsmpl
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.tools import synth_data as sd

    model = tsmpl.template_model(device="cpu")
    sb = sd.compose_scene(sd.Draws(torch.Generator().manual_seed(seed), "cpu"), model,
                          load_assets(model, device="cpu"), 1, scene, studio_frac=0.35, garment_frac=0.5,
                          natural_frac=0.65)
    img, alpha = resize_linear(sb.img, (1, h, h, 3))[0], resize_linear(sb.alpha, (1, h, h, 1))[0]
    bg = resize_linear(sb.bg, (1, h, w, 3))[0]
    frames = []
    for i in range(n):
        x0 = int(round(-0.3 * h + i * (w - 0.4 * h) / max(n - 1, 1)))  # the square's left edge
        lo, hi = max(x0, 0), min(x0 + h, w)
        a = torch.zeros(h, w, 1)
        p = torch.zeros(h, w, 3)
        a[:, lo:hi], p[:, lo:hi] = alpha[:, lo - x0:hi - x0], img[:, lo - x0:hi - x0]
        frames.append(p * a + bg * (1 - a))
    return torch.stack(frames).clamp(-1, 1).numpy()


def write_frames(frame_dir: str, frames: np.ndarray, ids) -> None:
    """Each frame as `akun_<id>.png` (8-bit), where the clip's extracted
    frames are read from."""
    from ipercore_tpu_torch.utils import video as vid

    os.makedirs(frame_dir, exist_ok=True)
    for f, i in zip(frames, ids):
        vid.save_image(os.path.join(frame_dir, f"akun_{i:04d}.png"), f)


# the default weight-file paths of both packages' runners, by weight name
WEIGHT_PATHS = {
    "person_seg": ("tools.mattors", "DEFAULT_WEIGHTS"), "matting_gca": ("tools.mattors", "GCA_WEIGHTS"),
    "openpose": ("tools.pose2d", "OPENPOSE_DEFAULT_WEIGHTS"), "spin": ("tools.pose3d", "SPIN_DEFAULT_WEIGHTS"),
    "mobilenet_openpose": ("tools.pose2d_mobilenet", "MOBILENET_DEFAULT_WEIGHTS"),
    "inpaintor": ("tools.inpaintors", "INPAINT_DEFAULT_WEIGHTS"), "esrgan": ("tools.inpaintors", "SR_DEFAULT_WEIGHTS"),
    "inpaintor_refine": ("tools.inpaintors", "REFINE_DEFAULT_WEIGHTS"),
    "schp": ("tools.parsers", "SCHP_DEFAULT_WEIGHTS"),
    "vgg_perceptual": ("models.networks.criterions", "DEFAULT_VGG_WEIGHTS"),
}


def point_weights(m, paths: dict) -> None:
    """Both packages' default weight paths of each name in `paths` set to
    its path (None: a path that does not exist), through the MonkeyPatch `m`."""
    import importlib

    for name, path in paths.items():
        mod, attr = WEIGHT_PATHS[name]
        for pkg in ("ipercore_tpu", "ipercore_tpu_torch"):
            m.setattr(importlib.import_module(f"{pkg}.{mod}"), attr, path or os.path.join(ROOT, "no", f"{name}.npz"))


def jax_scripts_module(name: str):
    """The JAX drivers' own import of `scripts/<name>.py` by its bare name
    (`from eval_real_photos import ...`), with `scripts/` on the path."""
    import importlib

    scripts = os.path.join(ROOT, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)
