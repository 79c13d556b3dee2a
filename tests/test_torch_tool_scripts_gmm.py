"""The port's GMM pose-prior fit (`ipercore_tpu_torch/scripts/
fit_gmm_prior.py`) against `scripts/fit_gmm_prior.py` itself at a small
`--n` and `--k`, both writing into a temporary directory.

The JAX driver's `jax.random` draws are recorded in call order and replayed
to the port's sampler. Tolerances: the samples within 1e-6 of their largest
magnitude; the fitted means, covariances and weights within 1e-5 (the k-means
runs in float64 numpy in both); the two NLLs of the printed JSON within 0.01
(both print them rounded to 2 decimals). The port's own run (its own draws)
writes a prior that `load_gmm_prior` reads, and the tracked
`assets/gmm_prior.npz` is left as it was.
"""
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from ipercore_tpu_torch.scripts import fit_gmm_prior as G
from ipercore_tpu_torch.tools.pose3d import fit_gmm_raw, load_gmm_prior
from ipercore_tpu_torch.tools.synth_data import natural_pose

from tests.test_torch_common import ROOT
from tests.torch_script_harness import Replay, eager_with_draws, load_jax_script

N, K = 512, 4
TRACKED = os.path.join(ROOT, "assets", "gmm_prior.npz")


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gmm") / "gmm_jax.npz")
    mod = load_jax_script("fit_gmm_prior")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sys, "argv", ["fit_gmm_prior.py", "--n", str(N), "--k", str(K), "--out", out])
        _, draws = eager_with_draws(mod.main)
    with np.load(out) as z:
        fit = {k: z[k] for k in z.files}
    return fit, draws


def test_gmm_fit_matches_jax(jax_fit, capsys):
    fit, draws = jax_fit
    replay = Replay(draws)
    body = G.pose_samples(replay, N, 0.7, 0.25)[:, 3:]
    means, covs, weights = fit_gmm_raw(body.numpy(), k=K)
    np.testing.assert_allclose(means, fit["means"], atol=1e-5)
    np.testing.assert_allclose(covs, fit["covars"], atol=1e-5)
    np.testing.assert_allclose(weights, fit["weights"], atol=1e-12)
    assert means.shape == (K, 69) and covs.shape == (K, 69, 69)

    hold = natural_pose(replay, 256)[:, 3:]
    assert replay.used_up()
    got = G.check_nll(means, covs, weights, hold)
    capsys.readouterr()
    want = G.check_nll(fit["means"], fit["covars"], fit["weights"], hold)
    for k in ("nll_natural_holdout", "nll_tpose"):
        assert abs(got[k] - want[k]) <= 0.01, (k, got, want)


def test_gmm_printed_line_matches_jax(jax_fit, tmp_path, capsys):
    """The JAX driver's JSON line against the port's check on the JAX fit and
    the replayed hold-out poses."""
    fit, draws = jax_fit
    mod = load_jax_script("fit_gmm_prior")
    out = str(tmp_path / "again.npz")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sys, "argv", ["fit_gmm_prior.py", "--n", str(N), "--k", str(K), "--out", out])
        eager_with_draws(mod.main)
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    replay = Replay(draws)
    G.pose_samples(replay, N, 0.7, 0.25)
    got = G.check_nll(fit["means"], fit["covars"], fit["weights"], natural_pose(replay, 256)[:, 3:])
    for k in ("nll_natural_holdout", "nll_tpose"):
        assert abs(got[k] - jline[k]) <= 0.01 + 1e-9, (k, got, jline)
    assert (jline["k"], jline["n"]) == (K, N)


def test_gmm_driver_writes_a_readable_prior_and_leaves_the_tracked_one(tmp_path, capsys):
    before = _sha(TRACKED)
    out = str(tmp_path / "gmm.npz")
    result = G.main(["--n", str(N), "--k", str(K), "--out", out, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["out"] == out
    prior = load_gmm_prior(out, device="cpu")
    assert prior.means.shape == (K, 69) and torch.isfinite(prior.precisions).all()
    assert np.isfinite([result["nll_natural_holdout"], result["nll_tpose"]]).all()
    assert _sha(TRACKED) == before
