"""The port's Body-25 trainer (`ipercore_tpu_torch/scripts/train_openpose.py`)
against `scripts/train_openpose.py` itself, run in-process up to its first
update (`tests/torch_script_harness.py`) at its smoke size (batch 2, 64²
scenes and input, the synthetic body), resumed from the port's seeded
weights (so JAX's loader reads the port's file, `__meta__` included).

Tolerances, stated where they are used:
  * the batch (input, heatmap and PAF targets, weights) on JAX's recorded
    draws: every value within 1e-5 of its field's largest magnitude;
  * the driver's own loss (in its jitted step) and the port's `loss_fn` on
    the driver's batch with the same parameters: loss and both terms within 1e-4 relative;
    gradients as `grads_against_jax` states (1e-4 relative, or as close to
    float64 as JAX's where f32 itself is further than that);
  * one step of clip -> Adam on the driver's batch: every parameter within
    2 * lr of JAX's and 99 % within 1e-6.
"""
import numpy as np
import pytest

import jax

from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.scripts import train_openpose
from ipercore_tpu_torch.tools.pose2d import OpenPoseBody25, OpenPoseRunner
from ipercore_tpu_torch.utils.checkpoint import flax_params_to_torch, load_flat_npz

from tests.test_torch_common import flatten_flax, n, t
from tests.torch_script_harness import (NU, NV, Replay, draws_between, grads_against_jax, run_jax_script,
                                        within_of_largest)

B, S, LR = 2, 64, 2e-4
SMOKE = train_openpose.Recipe(scene_size=S, input_size=S, motion_blur=0.0)


@pytest.fixture(scope="module")
def body():
    tm = tsmpl.synthetic_model(nu=NU, nv=NV, device="cpu")
    return tm, tload_assets(tm, device="cpu", synthetic=True)


@pytest.fixture(scope="module")
def op_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("openpose") / "openpose.npz")
    train_openpose.save(path, train_openpose.build("cpu"), S)
    return path, run_jax_script("train_openpose", ["--smoke", "--resume", "--out", path], until="train_step")


def _torch_tree(tree, module):
    return flax_params_to_torch(flatten_flax(tree), like=module.state_dict())


def test_openpose_batch_matches_jax(op_run, body):
    _, run = op_run
    replay = Replay(draws_between(run["log"], "train_step"))
    got = train_openpose.make_batch(replay, *body, B, SMOKE)
    assert replay.used_up()
    args, _ = run["vg"]
    for a, b in zip(got[:5], args[1:]):
        within_of_largest(a, b)
    assert got[1].shape == (B, S // 8, S // 8, 26) and got[2].shape == (B, S // 8, S // 8, 52)


def test_openpose_loss_and_step_match_jax(op_run):
    path, run = op_run
    args, ((jloss, _), _) = run["vg"]
    net = OpenPoseBody25()
    net.load_state_dict(_torch_tree(args[0], net), strict=True)
    (jl, ja), jgrads = run["vg"][1]
    batch = tuple(np.asarray(a) for a in args[1:])
    loss, aux = train_openpose.loss_fn(net, tuple(t(v) for v in batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(ja[k]), rtol=1e-4, err_msg=k)
    grads_against_jax(net, lambda m, dt: train_openpose.loss_fn(m, tuple(t(v, dt) for v in batch))[0],
                      _torch_tree(jgrads, net))

    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    tx = cm.adam(LR, clip=1.0)
    _, tloss, _ = train_openpose.train_step(net, tx, cm.init_state(tx, net),
                                            tuple(t(v) for v in batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    jparams, jupdates = run["updates"]
    want = _torch_tree(jax.tree_util.tree_map(lambda p, u: p + u, jparams, jupdates), net)
    got = dict(net.named_parameters())
    assert max(float((got[k] - before[k]).abs().max()) for k in before) > 0
    d = np.concatenate([np.abs(n(got[k]) - n(want[k])).ravel() for k in want])
    assert d.max() <= 2 * LR * 1.001, d.max()
    assert (d <= 1e-6).mean() >= 0.99, (d <= 1e-6).mean()


def test_openpose_save_loads_in_both_packages(op_run):
    """JAX resumed from the port's file (its strict `load_params`, above);
    the port's runner loads it, with the training size stamped."""
    path, run = op_run
    flat = load_flat_npz(path)
    assert int(flat["__meta__/input_size"]) == S
    assert all(v.dtype == np.float16 for k, v in flat.items() if not k.startswith("__meta__"))
    args, _ = run["vg"]
    for k, v in flatten_flax(args[0]).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k].astype(np.float32))
    runner = OpenPoseRunner(weights_path=path, device="cpu")
    assert runner.trained and runner.trained_size == S
