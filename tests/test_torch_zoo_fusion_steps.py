"""The train step `personalize` takes with a fusion generator, against the
JAX package's: one `train_step` each of `AttLWB-AdaIN`, `AddLWB` and
`SoftGateAddLWB` (the AdaIN, add / avg and soft-gate fusions; avg differs
from add only by a division) on the rig of `test_torch_zoo_trainers.py`,
from the port's seeded weights with non-zero biases; and where the two
packages' AdaIN gradients part.

Why the biases: with zero ones, a pixel that every source warps out of gets
an attention output of 0 in every channel. Its std over channels is 0, and
JAX's gradient through `jnp.std` is NaN there, so `apply_if_finite` skips
JAX's whole G update, while PyTorch's `std` backward gives 0
(`test_adain_gradient_at_zero_variance`).

Tolerances: `test_torch_zoo_trainers.py`'s (losses 1e-4 relative; G's
clipped gradients within 1 % L2 with 99 % of the elements within 1e-3 of the
largest, D's element by element within 1e-4 of the largest; parameters
within 2 * lr, 97 % within 1e-6).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ipercore_tpu.models.networks import blocks as JB
from ipercore_tpu_torch.models.networks import blocks as TB

from tests.test_torch_common import n, t
from tests.test_torch_trainer import NS, _batch, _same_geometry
from tests.test_torch_zoo_trainers import JT, TT, _check, _pair, base_rig  # noqa: F401 (base_rig: a fixture)

FUSION_GENERATORS = ["AttLWB-AdaIN", "AddLWB", "SoftGateAddLWB"]


@pytest.fixture(scope="module")
def steps(base_rig):
    """For each generator: (JAX state, JAX metrics), (port state, port
    metrics) after one train step on one composition, and the port's G."""
    rig = base_rig
    batch = _batch(0)
    tbatch = {k: t(v) for k, v in batch.items()}
    out = {}
    with _same_geometry(rig, batch):
        for name in FUSION_GENERATORS:
            jgen, jstate, tgen, tstate = _pair(rig, name, bias_noise=True)
            jfn = jax.jit(functools.partial(
                JT.train_step, comp=rig["jcomp"], generator=jgen, discriminator=rig["jdis"], vgg=rig["jvgg"],
                vgg_params=rig["vgg_params"], face=rig["jface"], face_params=rig["face_params"],
                cfg=JT.TrainConfig(), ns=NS))
            want = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            got = TT.train_step(tstate, tbatch, rig["tcomp"], tgen, rig["tdis"], rig["tvgg"], rig["tface"],
                                TT.TrainConfig(), ns=NS)
            out[name] = (want, got, tgen)
    return out


@pytest.mark.parametrize("name", FUSION_GENERATORS)
def test_fusion_train_step_matches_jax(steps, base_rig, name):
    (js, jm), (ts, tm), tgen = steps[name]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    assert int(js.step) == int(ts.step) == 1
    _check(js.params_G, js.opt_G, ts.params_G, ts.opt_G, tgen.state_dict())
    _check(js.params_D, js.opt_D, ts.params_D, ts.opt_D, base_rig["tdis"].state_dict(), elementwise=True)


def test_adain_gradient_at_zero_variance():
    """Where the attention output is constant over channels, its std is 0:
    JAX's gradient through `jnp.std` is NaN there (and `apply_if_finite`
    then skips the whole G update), PyTorch's `std` backward gives 0. The
    port keeps PyTorch's; both agree at every other pixel."""
    rng = np.random.RandomState(0)
    c, x = rng.randn(1, 2, 2, 8).astype(np.float32), rng.randn(1, 2, 2, 8).astype(np.float32)
    x[0, 0, 0] = 0.0

    def jloss(x):
        return jnp.sum(JB.adain(jnp.asarray(c), jnp.std(x, axis=-1, keepdims=True, ddof=1),
                                jnp.mean(x, axis=-1, keepdims=True)) ** 2)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tx = t(x).requires_grad_(True)
    (TB.adain(t(c), tx.std(dim=-1, keepdim=True, unbiased=True), tx.mean(dim=-1, keepdim=True)) ** 2).sum().backward()
    gt = n(tx.grad)
    assert np.isnan(gj[0, 0, 0]).all() and (gt[0, 0, 0] == 0).all()
    np.testing.assert_allclose(gt.reshape(4, 8)[1:], gj.reshape(4, 8)[1:], rtol=1e-5, atol=1e-5)
