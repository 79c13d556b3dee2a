"""The training half of the port against the JAX package: `LWBGenerator.forward`
(the training-style call), `flow_composition.forward`, the optimizer (held
against optax), the keypoint boxes, the trainer registry, one
`train_step` (losses, G and D gradients, updated parameters and both Adam
states) and one `eval_step` (metrics within 1e-4 relative, panel rows within
1e-4), on the rig of `tests/test_trainers/test_lwg_trainer.py`: S = 64,
ns = nt = 2, `patch_global_body_head` with ndf 8, a narrow VGG, Sphere20a,
the synthetic body. The JAX step is jitted once per configuration.

Tolerances, stated where they are used:
  * losses: 1e-4 relative;
  * gradients (the clipped gradient, first moment / (1 - b1)): for D every
    element within 1e-4 of its largest magnitude; for G the whole within 2 %
    (L2, relative) and 99 % of the elements within 1e-3 of the largest
    magnitude. The VGG's 2x2 max pooling routes a window's gradient to its
    largest element, and where two are within an f32 rounding of each other
    the two packages may pick different ones (on this rig one window of the
    second slice does: torch in f32 differs there from torch in f64, JAX in
    f32 agrees with f64), which moves whole gradient patches by ~1 % of the
    largest value;
  * updated parameters: Adam's first step moves each weight by about
    lr * sign(g), so a weight whose gradient is near 0 may move the other way:
    every element within 2 * lr, 97 % within 1e-6; the square root of the
    second moment like the gradient.
"""
import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ipercore_tpu.models import flow_composition as jfc
from ipercore_tpu.models import smpl as jsmpl
from ipercore_tpu.models.mesh import load_assets as jload_assets
from ipercore_tpu.models.networks import build_discriminator as jbuild_dis
from ipercore_tpu.models.networks import build_generator as jbuild_gen
from ipercore_tpu.models.networks import criterions as JC
from ipercore_tpu.trainers import lwg_trainer as JT
from ipercore_tpu.trainers import resolve_trainer as jresolve
from ipercore_tpu_torch.models import flow_composition as tfc
from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.models.networks import build_discriminator as tbuild_dis
from ipercore_tpu_torch.models.networks import build_generator as tbuild_gen
from ipercore_tpu_torch.models.networks import criterions as TC
from ipercore_tpu_torch.trainers import TRAINER_REGISTRY, resolve_trainer
from ipercore_tpu_torch.trainers import lwg_trainer as TT
from ipercore_tpu_torch.utils import checkpoint as tckpt

from tests.test_torch_common import flatten_flax, n, t

S = 64
NS, NT, BS = 2, 2, 1
CFG = {
    "BGNet": {"num_filters": [8, 16, 16, 32], "n_res_block": 1},
    "SIDNet": {"num_filters": [8, 16, 32], "n_res_block": 1},
    "TSFNet": {"num_filters": [8, 16, 32], "n_res_block": 1},
}
DIS_CFG = {"ndf": 8, "n_layers": 2, "max_nf_mult": 8, "use_sigmoid": False}
NARROW_VGG = ((4,), (8,), (8,), (8,), (8,))


def _batch(seed=0, aug=False):
    rng = np.random.RandomState(seed)
    smpls = np.zeros((BS, NS + NT, 85), np.float32)
    smpls[:, :, 0] = 1.2
    smpls[:, :, 3:75] = rng.randn(BS, NS + NT, 72) * 0.05
    b = {
        "images": rng.uniform(-1, 1, (BS, NS + NT, S, S, 3)).astype(np.float32),
        "smpls": smpls,
        "masks": (rng.rand(BS, NS + NT, S, S, 1) > 0.6).astype(np.float32),
        "bg": rng.uniform(-1, 1, (BS, S, S, 3)).astype(np.float32),
    }
    if aug:
        b["aug_bg"] = rng.uniform(-1, 1, (BS, S, S, 3)).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def rig():
    jm = jsmpl.synthetic_model(nu=20, nv=18)
    jcomp = jfc.make_composer(jm, jload_assets(jm, uv_map_path="/nonexistent", part_path="/nonexistent"),
                              image_size=S, out_dilate_ks=5)
    tm = tsmpl.synthetic_model(nu=20, nv=18, device="cpu")
    tcomp = tfc.make_composer(tm, tload_assets(tm, device="cpu", synthetic=True), image_size=S,
                              out_dilate_ks=5)
    jgen = jbuild_gen("AttLWB-SPADE", CFG)
    jdis = jbuild_dis("patch_global_body_head", DIS_CFG)
    jvgg = JC.VGGFeatures(slices=NARROW_VGG)
    vgg_params = jax.jit(jvgg.init)(jax.random.PRNGKey(1), jnp.zeros((1, S, S, 3)))
    jface = JC.SphereFaceFeatures()
    face_params = jax.jit(jface.init)(jax.random.PRNGKey(2), jnp.zeros((1, 112, 96, 3)))
    jstate = JT.create_train_state(jax.random.PRNGKey(0), jgen, jdis, jcomp, JT.TrainConfig(), ns=NS, nt=NT)

    tgen = tbuild_gen("AttLWB-SPADE", CFG, device="cpu")
    tdis = tbuild_dis("patch_global_body_head", DIS_CFG, device="cpu")
    tvgg = TC.VGGFeatures(slices=NARROW_VGG).eval().requires_grad_(False)
    tckpt.load_generator_params(tvgg, flatten_flax(vgg_params))
    tface, _ = TC.build_face_net("sphere20a", device="cpu")
    tckpt.load_generator_params(tface, flatten_flax(face_params))
    params_G = tckpt.flax_params_to_torch(flatten_flax(jstate.params_G), like=tgen.state_dict())
    params_D = tckpt.flax_params_to_torch(flatten_flax(jstate.params_D), like=tdis.state_dict())
    return dict(jcomp=jcomp, tcomp=tcomp, jgen=jgen, jdis=jdis, jvgg=jvgg, vgg_params=vgg_params,
                jface=jface, face_params=face_params, jstate=jstate, tgen=tgen, tdis=tdis,
                tvgg=tvgg, tface=tface, params_G=params_G, params_D=params_D)


def _jax_step(rig, cfg, batch):
    step = jax.jit(functools.partial(
        JT.train_step, comp=rig["jcomp"], generator=rig["jgen"], discriminator=rig["jdis"],
        vgg=rig["jvgg"], vgg_params=rig["vgg_params"], face=rig["jface"],
        face_params=rig["face_params"], cfg=cfg, ns=NS))
    return step(rig["jstate"], {k: jnp.asarray(v) for k, v in batch.items()})


def _torch_step(rig, cfg, batch):
    state = TT.create_train_state(rig["tgen"], rig["tdis"], cfg, params_G=dict(rig["params_G"]),
                                  params_D=dict(rig["params_D"]))
    return TT.train_step(state, {k: t(v) for k, v in batch.items()}, rig["tcomp"], rig["tgen"],
                         rig["tdis"], rig["tvgg"], rig["tface"], cfg, ns=NS)


_COMP_KEYS = ("input_G_bg", "input_G_src", "input_G_tsf", "Tst", "Ttt")


@contextlib.contextmanager
def _same_geometry(rig, batch):
    """Within the block both packages' train steps take one composition, JAX's
    (jitted) for this batch, instead of composing their own: their networks,
    losses and optimizers are held against each other on identical inputs.
    (The composition alone is `test_flow_composition_forward_matches_jax`;
    the projected vertices differ there by 1 ulp, and an L1 loss's gradient
    sign(a - b) turns such differences into gradient differences of ~1 %.)"""
    want = jax.jit(lambda *a: jfc.forward(rig["jcomp"], *a[:4], src_mask=a[4], ref_mask=a[5]))(
        *(jnp.asarray(x) for x in (batch["images"][:, :NS], batch["images"][:, NS:], batch["smpls"][:, :NS],
                                   batch["smpls"][:, NS:], batch["masks"][:, :NS], batch["masks"][:, NS:])))
    arrays = {k: np.asarray(want[k]) if want[k] is not None else None for k in _COMP_KEYS}
    j2d = np.asarray(want["ref_info"]["j2d"])
    jout = {k: jnp.asarray(v) if v is not None else None for k, v in arrays.items()}
    jout["ref_info"] = {"j2d": jnp.asarray(j2d)}
    tout = {k: t(v) if v is not None else None for k, v in arrays.items()}
    tout["ref_info"] = {"j2d": t(j2d)}
    originals = (JT.fc.forward, TT.fc.forward)
    JT.fc.forward = lambda *a, **k: jout
    TT.fc.forward = lambda *a, **k: tout
    try:
        yield
    finally:
        JT.fc.forward, TT.fc.forward = originals


CFG_MAIN = dict()
CFG_VARIANT = dict(use_gan=False, use_face=False, aug_bg=True)


@pytest.fixture(scope="module")
def steps(rig):
    """One step of each configuration in both packages on the same geometry
    (the JAX step compiled once per configuration), and one of the main
    configuration with each package composing its own ("composed")."""
    out = {}
    for name, kw in (("main", CFG_MAIN), ("variant", CFG_VARIANT)):
        batch = _batch(0, aug=kw.get("aug_bg", False))
        jcfg, tcfg = JT.TrainConfig(**kw), TT.TrainConfig(**kw)
        with _same_geometry(rig, batch):
            out[name] = (_jax_step(rig, jcfg, batch), _torch_step(rig, tcfg, batch), tcfg, batch)
    batch = _batch(0)
    out["composed"] = (_jax_step(rig, JT.TrainConfig(), batch), _torch_step(rig, TT.TrainConfig(), batch),
                       TT.TrainConfig(), batch)
    return out


def _adam_of(opt_state):
    """(count, mu, nu) of the ScaleByAdamState inside an optax state."""
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(
        x, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _as_torch_layout(tree, like):
    return {k: n(v) for k, v in tckpt.flax_params_to_torch(flatten_flax(tree), like=like).items()}


def _check_update(j_params, j_opt, t_params, t_opt, like, lr=1e-4, b1=0.5, b2=0.999):
    """Gradients (the first moment over 1 - b1), second moments, updated
    parameters and counts of one step (tolerances in the module note)."""
    jad = _adam_of(j_opt)
    assert int(jad.count) == int(t_opt.count) == 1
    assert int(j_opt.notfinite_count) == int(t_opt.notfinite_count) == 0
    j_mu, j_nu = _as_torch_layout(jad.mu, like), _as_torch_layout(jad.nu, like)
    j_p = _as_torch_layout(j_params, like)
    cat = lambda d: np.concatenate([np.asarray(d[k], np.float64).ravel() for k in like])
    g_j = cat(j_mu) / (1 - b1)
    g_t = cat({k: n(v) for k, v in t_opt.mu.items()}) / (1 - b1)
    scale = np.abs(g_j).max()
    d = np.abs(g_t - g_j)
    assert np.linalg.norm(g_t - g_j) <= 2e-2 * np.linalg.norm(g_j), np.linalg.norm(g_t - g_j) / np.linalg.norm(g_j)
    assert (d <= 1e-3 * scale).mean() >= 0.99, (d <= 1e-3 * scale).mean()
    # nu = (1 - b2) g^2 of the same clipped gradient
    rt_j = np.sqrt(cat(j_nu) / (1 - b2))
    rt_t = np.sqrt(cat({k: n(v) for k, v in t_opt.nu.items()}) / (1 - b2))
    assert (np.abs(rt_t - rt_j) <= 1e-3 * scale).mean() >= 0.99
    dp = np.abs(cat({k: n(v) for k, v in t_params.items()}) - cat(j_p))
    assert dp.max() <= 2 * lr * 1.001, dp.max()
    assert (dp <= 1e-6).mean() >= 0.97, (dp <= 1e-6).mean()
    return g_t, g_j


def test_train_step_losses_match_jax(steps):
    """Also with each package composing its own inputs."""
    for name, ((_, jm), (_, tm), _, _) in steps.items():
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=f"{name} {k}")
    assert float(steps["variant"][1][1]["g_adv"]) == 0 and float(steps["variant"][1][1]["g_face"]) == 0


@pytest.mark.parametrize("name", ["main", "variant"])
def test_train_step_updates_match_jax(steps, rig, name):
    (js, _), (ts, _), cfg, _ = steps[name]
    assert int(js.step) == int(ts.step) == 1
    _check_update(js.params_G, js.opt_G, ts.params_G, ts.opt_G, rig["tgen"].state_dict())
    if cfg.use_gan:
        # no max pooling in D: its gradients agree element by element
        g_t, g_j = _check_update(js.params_D, js.opt_D, ts.params_D, ts.opt_D, rig["tdis"].state_dict())
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-4 * np.abs(g_j).max())
    else:  # D is left as it was
        assert all(torch.equal(ts.params_D[k], rig["params_D"][k]) for k in ts.params_D)
        assert int(ts.opt_D.count) == 0


def test_remat_gives_the_same_step(rig, steps):
    (_, _), (ts, tm), cfg, batch = steps["composed"]
    rs, rm = _torch_step(rig, cfg._replace(remat=True), batch)
    for k in tm:
        assert float(rm[k]) == float(tm[k]), k
    for k in ts.params_G:
        torch.testing.assert_close(rs.opt_G.mu[k], ts.opt_G.mu[k], rtol=0, atol=1e-7)
        torch.testing.assert_close(rs.params_G[k], ts.params_G[k], rtol=0, atol=0)


def test_bfloat16_step_runs_close_to_f32(rig, steps):
    (_, _), (ts, tm), cfg, batch = steps["composed"]
    bs, bm = _torch_step(rig, cfg._replace(compute_dtype="bfloat16"), batch)
    for k in tm:
        assert np.isfinite(float(bm[k])), k
        assert abs(float(bm[k]) - float(tm[k])) <= 0.05 * abs(float(tm[k])) + 1e-3, k
    assert all(v.dtype == torch.float32 for v in bs.params_G.values())
    moved = max(float((bs.params_G[k] - rig["params_G"][k]).abs().max()) for k in bs.params_G)
    assert moved > 0


@pytest.fixture(scope="module")
def evals(rig):
    """`eval_step` with its panel rows in both packages on one geometry (the
    JAX one jitted once)."""
    batch = _batch(1)
    jeval = jax.jit(functools.partial(
        JT.eval_step, comp=rig["jcomp"], generator=rig["jgen"], discriminator=rig["jdis"],
        vgg=rig["jvgg"], vgg_params=rig["vgg_params"], face=rig["jface"],
        face_params=rig["face_params"], cfg=JT.TrainConfig(), ns=NS, return_images=True))
    state = TT.create_train_state(rig["tgen"], rig["tdis"], TT.TrainConfig(), params_G=dict(rig["params_G"]),
                                  params_D=dict(rig["params_D"]))
    tbatch = {k: t(v) for k, v in batch.items()}
    with _same_geometry(rig, batch):
        want = jeval(rig["jstate"], {k: jnp.asarray(v) for k, v in batch.items()})
        got = TT.eval_step(state, tbatch, rig["tcomp"], rig["tgen"], rig["tdis"], rig["tvgg"], rig["tface"],
                           TT.TrainConfig(), ns=NS, return_images=True)
        plain = TT.eval_step(state, tbatch, rig["tcomp"], rig["tgen"], rig["tdis"], rig["tvgg"], rig["tface"],
                             TT.TrainConfig(), ns=NS)
    return want, got, plain, state, tbatch


def test_eval_step_matches_jax(evals):
    """Metrics within 1e-4 relative; panel rows within 1e-4."""
    (jm, jimg), (tm, timg), plain, _, _ = evals
    assert set(tm) == set(jm) == set(plain) == {"val_g_rec", "val_g_tsf", "val_g_face", "val_g_adv",
                                                 "val_g_mask", "val_g_total"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
        assert float(plain[k]) == float(tm[k]), k
    assert set(timg) == set(jimg) == {"src", "ref", "fake_tsf", "fake_bg"}
    for k in jimg:
        assert timg[k].shape == (BS, S, S, 3)
        np.testing.assert_allclose(n(timg[k]), np.asarray(jimg[k]), rtol=0, atol=1e-4, err_msg=k)


def test_eval_step_takes_no_gradient_and_honours_the_switches(rig, evals):
    _, (tm, _), _, state, tbatch = evals
    assert all(not v.requires_grad for v in tm.values())
    off = TT.eval_step(state, tbatch, rig["tcomp"], rig["tgen"], rig["tdis"], rig["tvgg"], None,
                       TT.TrainConfig(use_gan=False, use_face=False), ns=NS)
    assert float(off["val_g_face"]) == float(off["val_g_adv"]) == 0
    assert float(off["val_g_rec"]) == pytest.approx(float(tm["val_g_rec"]), rel=1e-6)


def test_train_step_does_not_touch_the_modules_or_its_input_state(rig, steps):
    assert all(torch.equal(v, rig["params_G"][k]) for k, v in rig["params_G"].items())
    before = {k: v.clone() for k, v in rig["tgen"].state_dict().items()}
    (_, _), (ts, _), cfg, batch = steps["composed"]
    _torch_step(rig, cfg, batch)
    assert all(torch.equal(v, before[k]) for k, v in rig["tgen"].state_dict().items())
    assert not any(v.requires_grad for v in ts.params_G.values())


# --- the generator's training-style forward and the composition ---------------

@pytest.mark.parametrize("temporal,nt,only_tsf", [(False, 2, False), (False, 1, True), (True, 3, False)])
def test_generator_forward_matches_jax(temporal, nt, only_tsf):
    rng = np.random.RandomState(3)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    ins = [u(1, 1, S, S, 4), u(1, 2, S, S, 6), u(1, nt, S, S, 6), u(1, nt, 2, S, S, 2),
           u(1, nt - 1, S, S, 2) if temporal else None]
    jgen = jbuild_gen("AttLWB-SPADE", CFG, temporal=temporal)
    jin = [jnp.asarray(a) if a is not None else None for a in ins]
    params = jax.jit(lambda r: jgen.init(r, *jin, False))(jax.random.PRNGKey(5))
    want = jax.jit(lambda p, *a: jgen.apply(p, *a, only_tsf))(params, *jin)
    tgen = tbuild_gen("AttLWB-SPADE", CFG, temporal=temporal, device="cpu")
    tckpt.load_generator_params(tgen, flatten_flax(params))
    got = tgen(*[t(a) if a is not None else None for a in ins], only_tsf=only_tsf)
    assert len(got) == len(want) == (3 if only_tsf else 5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-4, rtol=0)


def _close_frac(a, b, frac=0.995, tol=1e-3, mean_tol=1e-4):
    """The setup tests' bar: >= 99.5 % of values within 1e-3 and mean abs
    difference < 1e-4 (a silhouette-edge pixel may take another face)."""
    a, b = n(a), np.asarray(b)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert (d <= tol).mean() >= frac and d.mean() < mean_tol, ((d <= tol).mean(), d.mean())


def test_flow_composition_forward_matches_jax(rig, monkeypatch):
    """The JAX composition (temporal, so Ttt too) is handed the port's SMPL
    details (LBS is held against JAX at 1e-5 in `test_torch_smpl_mesh.py`;
    under jit XLA rounds the vertices of most faces by 1 ulp otherwise) and
    runs un-jitted around its raster, which is jitted alone as in the raster
    tests (inside one jit over the whole composition XLA contracts the
    barycentrics in another order): then fim and wim are equal bit for bit,
    the rest within the setup tests' bar."""
    temporal = True
    b = _batch(1)
    srcs = (b["images"][:, :NS], b["images"][:, NS:], b["smpls"][:, :NS], b["smpls"][:, NS:],
            b["masks"][:, :NS], b["masks"][:, NS:])
    details = [tsmpl.get_details(rig["tcomp"].model, t(th.reshape(-1, 85))) for th in srcs[2:4]]
    calls = iter([{k: jnp.asarray(n(v)) for k, v in d.items()} for d in details])
    monkeypatch.setattr(jfc.smpl_mod, "get_details", lambda *a, **k: next(calls))
    monkeypatch.setattr(jfc.rz, "rasterize_batch", jax.jit(jfc.rz.rasterize_batch, static_argnums=(1, 2)))
    want = jfc.forward(rig["jcomp"], *(jnp.asarray(x) for x in srcs[:4]), src_mask=jnp.asarray(srcs[4]),
                       ref_mask=jnp.asarray(srcs[5]), temporal=temporal)
    got = tfc.forward(rig["tcomp"], *(t(x) for x in srcs[:4]), src_mask=t(srcs[4]), ref_mask=t(srcs[5]),
                      temporal=temporal)
    for info in ("src_info", "ref_info"):
        np.testing.assert_array_equal(n(got[info]["f2pts"]), np.asarray(want[info]["f2pts"]))
        np.testing.assert_array_equal(n(got[info]["fim"]), np.asarray(want[info]["fim"]))
        np.testing.assert_array_equal(n(got[info]["wim"]), np.asarray(want[info]["wim"]))
    for k in ("input_G_bg", "input_G_src", "input_G_tsf", "uv_img", "Tst"):
        _close_frac(got[k], want[k])
    assert got["Ttt"].shape == (BS, NT - 1, S, S, 2)
    _close_frac(got["Ttt"], want["Ttt"])


def test_make_trans_flow_matches_jax(rig):
    b = _batch(2)
    td = tsmpl.get_details(rig["tcomp"].model, t(b["smpls"][0]))
    tinfo = [tfc.render_smpl_info(rig["tcomp"], td["verts"][i], td["cam"][i])
             for i in (slice(0, 2), slice(2, 3), slice(3, 4))]
    tT, tTtt = tfc.make_trans_flow(rig["tcomp"], tinfo[0], tinfo[1], 1, 2, temp_info=tinfo[2])

    def jax_flows(smpls):
        jd = jsmpl.get_details(rig["jcomp"].model, smpls)
        jinfo = [jfc.render_smpl_info(rig["jcomp"], jd["verts"][i], jd["cam"][i])
                 for i in (slice(0, 2), slice(2, 3), slice(3, 4))]
        return jfc.make_trans_flow(rig["jcomp"], jinfo[0], jinfo[1], 1, 2, temp_info=jinfo[2])

    jT, jTtt = jax.jit(jax_flows)(jnp.asarray(b["smpls"][0]))
    assert tT.shape == (1, 2, S, S, 2) and tTtt.shape == (1, 1, S, S, 2)
    _close_frac(tT, jT)
    _close_frac(tTtt, jTtt)


# --- optimizer, schedule, boxes, registry ----------------------------------------

def test_optimizer_matches_optax_with_clip_skip_and_schedule():
    """Steps: small gradients, large ones (the clip triggers), a NaN and an
    inf (both skipped: nothing moves, the Adam count stays), then finite
    again, over a constant-then-linear schedule. Within 1e-6 relative."""
    rng = np.random.RandomState(4)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    kw = dict(lr_g=1e-2, niters_no_decay=2, niters_decay=3)
    jtx, _ = JT.make_optimizers(JT.TrainConfig(**kw))
    ttx, _ = TT.make_optimizers(TT.TrainConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jtx.init(jp)
    tp = {k: t(v) for k, v in params.items()}
    ts = ttx.init(tp)
    grads = []
    for scale in (0.1, 50.0, None, None, 0.3, 0.2):
        g = {k: rng.randn(*v.shape).astype(np.float32) * (scale or 1) for k, v in params.items()}
        grads.append(g)
    grads[2]["a"][1, 2] = np.nan
    grads[3]["b"][0] = np.inf
    assert np.sqrt(sum((g ** 2).sum() for g in grads[1].values())) > 10  # clipped
    for i, g in enumerate(grads):
        upd, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = ttx.apply({k: t(v) for k, v in g.items()}, ts, tp)
        jad = _adam_of(js)
        assert int(ts.count) == int(jad.count) == [1, 2, 2, 2, 3, 4][i]
        assert int(ts.notfinite_count) == int(js.notfinite_count)
        assert int(ts.total_notfinite) == int(js.total_notfinite)
        assert bool(ts.last_finite) == bool(js.last_finite)
        for k in params:
            np.testing.assert_allclose(n(tp[k]), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(n(ts.mu[k]), np.asarray(jad.mu[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(n(ts.nu[k]), np.asarray(jad.nu[k]), rtol=1e-6, atol=1e-9)
    assert int(ts.total_notfinite) == 2


def test_schedule_matches_optax():
    for kw in (dict(niters_no_decay=10, niters_decay=10), dict(niters_no_decay=0, niters_decay=4),
               dict(niters_no_decay=5, niters_decay=0)):
        jsched = JT._schedule(1e-4, JT.TrainConfig(**kw))
        tsched = TT._schedule(1e-4, TT.TrainConfig(**kw))
        for c in range(0, 25):
            want = float(jsched(jnp.asarray(c, jnp.int32))) if callable(jsched) else jsched
            got = float(tsched(torch.tensor(c, dtype=torch.int32))) if callable(tsched) else tsched
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (kw, c)


def test_keypoint_boxes_match_jax():
    j2d = np.random.RandomState(5).uniform(-1.1, 1.1, (3, 19, 2)).astype(np.float32)
    np.testing.assert_allclose(n(TT.cal_head_bbox_by_kps(t(j2d))),
                               np.asarray(JT.cal_head_bbox_by_kps(jnp.asarray(j2d))), atol=1e-7)
    np.testing.assert_allclose(n(TT.cal_body_bbox_by_kps(t(j2d))),
                               np.asarray(JT.cal_body_bbox_by_kps(jnp.asarray(j2d))), atol=1e-7)


def test_trainer_registry_matches_jax():
    for name in TRAINER_REGISTRY:
        assert resolve_trainer(name) == jresolve(name)
    with pytest.raises(KeyError, match="unknown trainer"):
        resolve_trainer("nope")
