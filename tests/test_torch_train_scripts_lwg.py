"""The port's generator pretrainer (`ipercore_tpu_torch/scripts/
train_lwg_pretrain.py`) against `scripts/train_lwg_pretrain.py` itself, run
in-process up to its first train step (`tests/torch_script_harness.py`) at
its smoke size (batch 1, ns = nt = 2, 64², the synthetic body) and its
published widths (AttLWB-SPADE, `patch_global_body_head` ndf 64, VGG19,
Sphere20a).

Tolerances, stated where they are used:
  * `make_identity_batch` on JAX's recorded draws: every value within 1e-5
    of its field's largest magnitude, the masks exact;
  * one train step of the driver's configuration in f32 (its default is
    bf16, which the port runs as autocast; D at n_layers 2, below) from
    JAX's initial state on the driver's batch, both packages on JAX's
    composition: losses within 1e-4
    relative; G's and D's updates as `tests/test_torch_trainer.py` holds
    them (`_check_update`: the clipped gradients within 2 % L2 and 99 % of
    the elements within 1e-3 of the largest, parameters within 2 * lr and
    97 % within 1e-6);
  * the saved generator: f16, read strictly by JAX's `load_params` and by
    the port's generator loader.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.models.networks import build_generator
from ipercore_tpu_torch.scripts import train_lwg_pretrain
from ipercore_tpu_torch.trainers import lwg_trainer as TT
from ipercore_tpu_torch.utils.checkpoint import flax_params_to_torch, load_flat_npz, load_generator_params

from tests.test_torch_common import flatten_flax, n, t
from tests.torch_script_harness import NU, NV, Replay, draws_between, run_jax_script, within_of_largest

B, S, NS = 1, 64, 2


# The driver's D (`patch_global_body_head`, n_layers 4) has no output on the
# head crop of a 64² frame (16² after four stride-2 layers and two 4x4 ones:
# JAX returns an empty map, whose mean is NaN, and PyTorch refuses the
# convolution), so the step is held with D at n_layers 2; everything else is
# the driver's.
SMALL_D = {"ndf": 64, "n_layers": 2, "max_nf_mult": 8}


@pytest.fixture(scope="module")
def lwg_run():
    from ipercore_tpu.models.networks import build_discriminator as jbuild_dis
    from ipercore_tpu.trainers import lwg_trainer as JT

    run = run_jax_script("train_lwg_pretrain", ["--smoke", "--ckpt_dir", "/nonexistent/lwg"],
                         until="train_step", before=True)
    (state, batch), step = run["stopped"]
    kw = step.keywords
    jdis = jbuild_dis(train_lwg_pretrain.DIS_NAME, SMALL_D)
    state = JT.create_train_state(jax.random.PRNGKey(1), kw["generator"], jdis, kw["comp"], kw["cfg"], ns=NS,
                                  nt=2, params_G=state.params_G)
    step = functools.partial(step.func, **{**kw, "discriminator": jdis})
    return run, state, {k: np.asarray(v) for k, v in batch.items()}, step


@pytest.fixture(scope="module")
def port_rig(lwg_run):
    """The port's rig at f32 with JAX's initial parameters."""
    _, state, _, step = lwg_run
    tm = tsmpl.synthetic_model(nu=NU, nv=NV, device="cpu")
    ta = tload_assets(tm, device="cpu", synthetic=True)
    rig = train_lwg_pretrain.Rig(tm, ta, S, "cpu", compute_dtype="float32", dis_cfg=SMALL_D)
    load_generator_params(rig.vgg, flatten_flax(step.keywords["vgg_params"]))
    load_generator_params(rig.face, flatten_flax(step.keywords["face_params"]))
    pG = flax_params_to_torch(flatten_flax(state.params_G), like=rig.gen.state_dict())
    pD = flax_params_to_torch(flatten_flax(state.params_D), like=rig.dis.state_dict())
    return tm, ta, rig, TT.create_train_state(rig.gen, rig.dis, rig.cfg, params_G=pG, params_D=pD)


def test_identity_batch_matches_jax(lwg_run, port_rig):
    run, _, batch, _ = lwg_run
    tm, ta = port_rig[:2]
    replay = Replay(draws_between(run["log"], "make_identity_batch", "train_step"))
    got = train_lwg_pretrain.make_identity_batch(replay, tm, ta, B, S)
    assert replay.used_up()
    assert set(got) == set(batch)
    for k in batch:
        within_of_largest(got[k], batch[k])
    np.testing.assert_array_equal(n(got["masks"]), batch["masks"])
    assert 0.0 < float(1 - got["masks"].mean()) < 0.7


def test_train_step_matches_jax(lwg_run, port_rig):
    """Both steps run on JAX's composition of the batch (`test_torch_trainer.
    _same_geometry`): the projected vertices differ by an ulp between the
    packages, and the L1 losses' sign turns that into gradient noise."""
    from tests.test_torch_trainer import _check_update, _same_geometry

    _, jstate, batch, step = lwg_run
    tm, ta, rig, tstate = port_rig
    assert rig.cfg.aug_bg and step.keywords["cfg"].aug_bg and step.keywords["cfg"].compute_dtype == "bfloat16"
    jcfg = step.keywords["cfg"]._replace(compute_dtype="float32")
    jstep = jax.jit(functools.partial(step.func, **{**step.keywords, "cfg": jcfg}))
    with _same_geometry({"jcomp": step.keywords["comp"]}, batch):
        js, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm_ = train_lwg_pretrain.train_step(rig, tstate, {k: t(v) for k, v in batch.items()})
    assert set(tm_) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm_[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    _check_update(js.params_G, js.opt_G, ts.params_G, ts.opt_G, rig.gen.state_dict())
    _check_update(js.params_D, js.opt_D, ts.params_D, ts.opt_D, rig.dis.state_dict())


def test_generator_save_loads_in_both_packages(lwg_run, port_rig, tmp_path):
    from ipercore_tpu.utils.checkpoint import load_params as jload_params

    _, jstate, _, _ = lwg_run
    rig, tstate = port_rig[2], port_rig[3]
    path = train_lwg_pretrain.save(str(tmp_path / "lwg_pretrained_G.npz"), rig, tstate.params_G)
    flat = load_flat_npz(path)
    assert all(v.dtype == np.float16 for v in flat.values())
    back = jload_params(path, like=jstate.params_G)
    for k, v in flatten_flax(back).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k].astype(np.float32))
    gen = build_generator("AttLWB-SPADE", train_lwg_pretrain.GEN_CFG, device="cpu")
    load_generator_params(gen, flat)
    for k, v in gen.state_dict().items():
        np.testing.assert_array_equal(n(v), n(tstate.params_G[k].half().float()))
