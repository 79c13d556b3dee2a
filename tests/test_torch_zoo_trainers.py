"""The two trainers of the generator zoo against the JAX package's:
`LWGFrontTrainer` (AttLWB-Front: no BGNet, the real background stands in)
and `BaselineTrainer` (InputConcat: no source stream). For each, one
`train_step` and one `eval_step` on the rig of `test_torch_trainer.py` (64²,
ns = nt = 2, `patch_global_body_head` ndf 8, a narrow VGG, Sphere20a, the
synthetic body, one composition for both packages), the train checkpoint of
the stepped state across the packages both ways. (The fusion generators'
steps are `test_torch_zoo_fusion_steps.py`.) (`services/train.train` with
`BaselineTrainer` is `test_torch_zoo_train_service.py`.)

Tolerances: losses 1e-4 relative; the clipped gradients (first moment over
1 - b1) within 1 % (L2, relative) with 99 % of the elements within 1e-3 of
the largest, D's element by element within 1e-4 of the largest; parameters
within 2 * lr, 97 % within 1e-6; checkpoints bit for bit.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ipercore_tpu.models import flow_composition as jfc
from ipercore_tpu.models import smpl as jsmpl
from ipercore_tpu.models.mesh import load_assets as jload_assets
from ipercore_tpu.models.networks import build_discriminator as jbuild_dis
from ipercore_tpu.models.networks import build_generator as jbuild_gen
from ipercore_tpu.models.networks import criterions as JC
from ipercore_tpu.trainers import lwg_trainer as JT
from ipercore_tpu.trainers import resolve_trainer as jresolve
from ipercore_tpu.utils import checkpoint as jckpt
from ipercore_tpu_torch.models import flow_composition as tfc
from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.models.networks import build_discriminator as tbuild_dis
from ipercore_tpu_torch.models.networks import build_generator as tbuild_gen
from ipercore_tpu_torch.models.networks import criterions as TC
from ipercore_tpu_torch.trainers import resolve_trainer
from ipercore_tpu_torch.trainers import lwg_trainer as TT
from ipercore_tpu_torch.utils import checkpoint as tckpt

from tests.test_torch_common import NARROW_CFG, flatten_flax, n, t, unflatten_to_jax
from tests.test_torch_train_service import _assert_same_state
from tests.test_torch_trainer import CFG, NARROW_VGG, NS, S, _adam_of, _as_torch_layout, _batch, _same_geometry
from tests.test_torch_trainer import DIS_CFG as TRAINER_DIS_CFG

TRAINERS = ["LWGFrontTrainer", "BaselineTrainer"]
LR = 1e-4


@pytest.fixture(scope="module")
def base_rig():
    """The rig of `test_torch_trainer.py` without its generator."""
    jm = jsmpl.synthetic_model(nu=20, nv=18)
    jcomp = jfc.make_composer(jm, jload_assets(jm, uv_map_path="/nonexistent", part_path="/nonexistent"),
                              image_size=S, out_dilate_ks=5)
    tm = tsmpl.synthetic_model(nu=20, nv=18, device="cpu")
    tcomp = tfc.make_composer(tm, tload_assets(tm, device="cpu", synthetic=True), image_size=S, out_dilate_ks=5)
    jdis = jbuild_dis("patch_global_body_head", TRAINER_DIS_CFG)
    jvgg = JC.VGGFeatures(slices=NARROW_VGG)
    vgg_params = jax.jit(jvgg.init)(jax.random.PRNGKey(1), jnp.zeros((1, S, S, 3)))
    jface = JC.SphereFaceFeatures()
    face_params = jax.jit(jface.init)(jax.random.PRNGKey(2), jnp.zeros((1, 112, 96, 3)))
    tdis = tbuild_dis("patch_global_body_head", TRAINER_DIS_CFG, device="cpu")
    tvgg = TC.VGGFeatures(slices=NARROW_VGG).eval().requires_grad_(False)
    tckpt.load_generator_params(tvgg, flatten_flax(vgg_params))
    tface, _ = TC.build_face_net("sphere20a", device="cpu")
    tckpt.load_generator_params(tface, flatten_flax(face_params))
    return dict(jcomp=jcomp, tcomp=tcomp, jdis=jdis, jvgg=jvgg, vgg_params=vgg_params, jface=jface,
                face_params=face_params, tdis=tdis, tvgg=tvgg, tface=tface)


def _pair(rig, case, bias_noise=False):
    """(JAX generator, JAX train state, port generator, port train state) of
    trainer `case`'s generator, or of the generator `case` names, both from
    the port's seeded weights (G seed 0, D seed 1) with fresh optimizer
    states. `bias_noise` adds N(0, 0.05) to G's biases outside BGNet (BGNet's
    input is 0 in this rig, and with biases its instance norms would
    normalise maps that are constant up to rounding)."""
    name = case
    if case in TRAINERS:
        name = resolve_trainer(case)["default_gen"]
        assert name == jresolve(case)["default_gen"]
    jgen = jbuild_gen(name, CFG)
    tgen = tbuild_gen(name, CFG, num_source=NS, device="cpu")
    flat_G, flat_D = tckpt.seeded_flat_params(tgen, 0), tckpt.seeded_flat_params(rig["tdis"], 1)
    if bias_noise:
        rng = np.random.RandomState(0)
        flat_G = {k: v + rng.randn(*v.shape).astype(np.float32) * 0.05
                  if k.endswith("bias") and not k.startswith("params/bg_net/") else v
                  for k, v in flat_G.items()}
    params_G, params_D = unflatten_to_jax(flat_G), unflatten_to_jax(flat_D)
    tx_g, tx_d = JT.make_optimizers(JT.TrainConfig())
    jstate = JT.LWGTrainState(params_G=params_G, params_D=params_D, opt_G=tx_g.init(params_G),
                              opt_D=tx_d.init(params_D), step=jnp.zeros((), jnp.int32))
    tstate = TT.create_train_state(
        tgen, rig["tdis"], TT.TrainConfig(),
        params_G=tckpt.flax_params_to_torch(flat_G, like=tgen.state_dict()),
        params_D=tckpt.flax_params_to_torch(flat_D, like=rig["tdis"].state_dict()))
    return jgen, jstate, tgen, tstate


@pytest.fixture(scope="module")
def runs(base_rig):
    """For each trainer: one train step and one eval step (with panels) in both
    packages, each batch on one composition, each JAX function jitted once."""
    rig = base_rig
    pairs = {trainer: _pair(rig, trainer) for trainer in TRAINERS}
    out = {trainer: dict(tgen=p[2], jstate=p[1]) for trainer, p in pairs.items()}
    cfg = TT.TrainConfig()
    for what, batch in (("step", _batch(0)), ("eval", _batch(1))):
        tbatch = {k: t(v) for k, v in batch.items()}
        with _same_geometry(rig, batch):
            for trainer, (jgen, jstate, tgen, tstate) in pairs.items():
                kw = dict(comp=rig["jcomp"], generator=jgen, discriminator=rig["jdis"], vgg=rig["jvgg"],
                          vgg_params=rig["vgg_params"], face=rig["jface"], face_params=rig["face_params"],
                          cfg=JT.TrainConfig(), ns=NS)
                args = (tbatch, rig["tcomp"], tgen, rig["tdis"], rig["tvgg"], rig["tface"], cfg)
                if what == "step":
                    jfn = jax.jit(functools.partial(JT.train_step, **kw))
                    got = TT.train_step(tstate, *args, ns=NS)
                else:
                    jfn = jax.jit(functools.partial(JT.eval_step, return_images=True, **kw))
                    got = TT.eval_step(tstate, *args, ns=NS, return_images=True)
                out[trainer][what] = (jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()}), got)
    return out


@pytest.mark.parametrize("trainer", TRAINERS)
def test_train_step_losses_match_jax(runs, trainer):
    (_, jm), (_, tm) = runs[trainer]["step"]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    if trainer == "LWGFrontTrainer":
        # the real background stands in for the predicted one: its term is 0,
        # so rec is (L1(src) + 0) / 2 * 10
        assert float(tm["g_rec"]) > 0


def _check(j_params, j_opt, t_params, t_opt, like, elementwise=False):
    jad = _adam_of(j_opt)
    assert int(jad.count) == int(t_opt.count) == 1
    cat = lambda d: np.concatenate([np.asarray(d[k], np.float64).ravel() for k in like])
    g_j = cat(_as_torch_layout(jad.mu, like)) / 0.5
    g_t = cat({k: n(v) for k, v in t_opt.mu.items()}) / 0.5
    scale = np.abs(g_j).max()
    assert np.linalg.norm(g_t - g_j) <= 1e-2 * np.linalg.norm(g_j), np.linalg.norm(g_t - g_j) / np.linalg.norm(g_j)
    assert (np.abs(g_t - g_j) <= 1e-3 * scale).mean() >= 0.99
    if elementwise:
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-4 * scale)
    dp = np.abs(cat({k: n(v) for k, v in t_params.items()}) - cat(_as_torch_layout(j_params, like)))
    assert dp.max() <= 2 * LR * 1.001, dp.max()
    assert (dp <= 1e-6).mean() >= 0.97, (dp <= 1e-6).mean()


@pytest.mark.parametrize("trainer", TRAINERS)
def test_train_step_updates_match_jax(runs, base_rig, trainer):
    (js, _), (ts, _) = runs[trainer]["step"]
    assert int(js.step) == int(ts.step) == 1
    _check(js.params_G, js.opt_G, ts.params_G, ts.opt_G, runs[trainer]["tgen"].state_dict())
    _check(js.params_D, js.opt_D, ts.params_D, ts.opt_D, base_rig["tdis"].state_dict(), elementwise=True)


@pytest.mark.parametrize("trainer", TRAINERS)
def test_eval_step_matches_jax(runs, trainer):
    """Metrics within 1e-4 relative, panel rows within 1e-4; without BGNet
    the panel's background is the real one."""
    (jm, jimg), (tm, timg) = runs[trainer]["eval"]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    for k in jimg:
        np.testing.assert_allclose(n(timg[k]), np.asarray(jimg[k]), rtol=0, atol=1e-4, err_msg=k)
    if trainer == "LWGFrontTrainer":
        np.testing.assert_array_equal(n(timg["fake_bg"]), _batch(1)["bg"])


@pytest.mark.parametrize("trainer", TRAINERS)
def test_train_checkpoints_cross_the_packages(runs, base_rig, tmp_path, trainer):
    """The stepped states, written by one package and read by the other, in
    both directions, bit for bit (parameters and optax's leaves)."""
    (js, _), (ts, _) = runs[trainer]["step"]
    gen, dis = runs[trainer]["tgen"], base_rig["tdis"]
    jckpt.save_train_ckpt(str(tmp_path / "jax"), 1, js.params_G, js.params_D, opt_G=js.opt_G, opt_D=js.opt_D)
    like = TT.create_train_state(gen, dis, TT.TrainConfig())
    got = tckpt.load_train_ckpt(str(tmp_path / "jax"), 1, like, gen, dis)
    _assert_same_state(got, js, gen, dis, False)
    tckpt.save_train_ckpt(str(tmp_path / "port"), 1, ts, gen, dis)
    back = jckpt.load_train_ckpt(str(tmp_path / "port"), 1, runs[trainer]["jstate"])
    assert int(back.step) == 1
    _assert_same_state(ts, back, gen, dis, False)


def test_every_trainer_of_the_registry_is_served():
    """`train` no longer refuses a trainer: all four of the registry build
    their generator (InputConcat with the service's ns)."""
    from ipercore_tpu_torch.trainers import TRAINER_REGISTRY

    assert sorted(TRAINER_REGISTRY) == ["BaselineTrainer", "LWGAugBGTrainer", "LWGFrontTrainer", "LWGTrainer"]
    for name, spec in TRAINER_REGISTRY.items():
        gen = tbuild_gen(spec["default_gen"], NARROW_CFG, num_source=3, device="meta")
        assert (name == "LWGFrontTrainer") == (not hasattr(gen, "bg_net")), name
