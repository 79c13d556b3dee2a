"""The port's perception-stack check (`ipercore_tpu_torch/scripts/
verify_perception.py`) against `scripts/verify_perception.py` itself at
`--frames 2 --size 64`, on the small synthetic body (both packages' template
body replaced by it, with synthetic assets) and with the trained weights of
git history as both packages' default weight files, so that every branch
runs: SPIN, Body-25 + SMPLify (4 steps in both: the fits drift apart beyond
about 6, ROADMAP Queue 3), the GCA mattor, the two inpaintor stages, ESRGAN,
SCHP and Mobilenet.

The drawn sequence takes the JAX driver's recorded draws, all of them in
their order and shapes, and its face-index map (K1, here its plain version)
equals JAX's render of the same bodies. The port's run replays those draws.
Tolerances on the printed JSON: every `*_trained` flag and the false-skirt
flag equal; pixel errors within 0.05 pixel; IoUs, L1 and PSNRs
(dB) within 2e-3 of their printed values; `wall_s` not compared.
"""
import contextlib
import io
import json
import sys

import numpy as np
import pytest
import torch

from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.scripts import verify_perception as V

from tests.test_torch_common import history_weights
from tests.torch_script_harness import Replay, eager_with_draws, load_jax_script, point_weights

T, S, ITERS = 2, 64, 4
NAMES = ("spin", "openpose", "person_seg", "matting_gca", "inpaintor", "inpaintor_refine", "esrgan", "schp",
         "mobilenet_openpose")


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    import ipercore_tpu.models.mesh as jmesh
    import ipercore_tpu.models.smpl as jsmpl
    import ipercore_tpu.tools.pose3d as jpose3d
    import ipercore_tpu_torch.tools.pose3d as tpose3d

    weights = {k: history_weights(k, tmp_path_factory) for k in NAMES}
    jmod = load_jax_script("verify_perception")
    real_assets = jmesh.load_assets
    argv = ["--frames", str(T), "--size", str(S)]
    with pytest.MonkeyPatch.context() as m:
        point_weights(m, weights)
        m.setattr(jsmpl, "template_model", lambda *a, **k: jsmpl.synthetic_model(nu=20, nv=18))
        m.setattr(jmesh, "load_assets", lambda model, *a, **k: real_assets(
            model, uv_map_path="/nonexistent", part_path="/nonexistent"))
        m.setattr(tsmpl, "template_model", lambda *a, device="cuda", **k: tsmpl.synthetic_model(
            nu=20, nv=18, device=device))
        m.setattr(V, "load_assets", lambda model, device="cuda": tload_assets(model, device=device, synthetic=True))
        for mod in (jpose3d, tpose3d):
            fit = mod.smplify_refine
            m.setattr(mod, "smplify_refine", lambda *a, _fit=fit, _mod=mod, **k: _fit(
                *a, cfg=_mod.SMPLifyConfig()._replace(n_iters=ITERS), **k))
        m.setattr(sys, "argv", ["verify_perception.py"] + argv)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, draws = eager_with_draws(jmod.main)
        jline = json.loads(buf.getvalue().strip().splitlines()[-1])
        # the port's run draws the same sequence: JAX's draws replayed to it
        m.setattr(V.sd, "Draws", lambda *a, **k: Replay(draws))
        return jline, V.main(argv + ["--device", "cpu"]), draws


def test_drawn_sequence_matches_jax(checks):
    """The port's sequence takes JAX's draws in JAX's order and shapes (all
    of them), and its K1 render of the interpolated bodies is JAX's
    `render_fim` of the same thetas."""
    import jax.numpy as jnp

    import ipercore_tpu.models.smpl as jsmpl
    from ipercore_tpu.models.mesh import load_assets as jload_assets
    from ipercore_tpu.tools import synth_data as jsd

    _, _, draws = checks
    model = tsmpl.synthetic_model(nu=20, nv=18, device="cpu")
    assets = tload_assets(model, device="cpu", synthetic=True)
    replay = Replay(draws)
    seq = V.sequence(replay, model, assets, T, S)
    assert replay.used_up()
    assert seq["frames"].shape == (T, S, S, 3) and torch.isfinite(seq["frames"]).all()
    jm = jsmpl.synthetic_model(nu=20, nv=18)
    ja = jload_assets(jm, uv_map_path="/nonexistent", part_path="/nonexistent")
    fim = np.asarray(jsd.render_fim(jm, jnp.asarray(seq["theta_gt"].numpy()), S * 2, f2uvs=ja.f2uvs))
    tfim = V.sd.render_fim(model, seq["theta_gt"], S * 2, f2uvs=assets.f2uvs)
    np.testing.assert_array_equal(tfim.numpy(), fim)
    assert (fim >= 0).mean() > 0.01


def test_perception_report_matches_jax(checks):
    jline, tline, _ = checks
    assert set(tline) == set(jline), sorted(set(tline) ^ set(jline))
    for k in ("spin_trained", "openpose_trained", "mattor_trained", "inpaintor_trained", "schp_trained",
              "mobilenet_trained"):
        assert tline[k] is jline[k] is True, k
    assert tline["schp_false_skirt"] == jline["schp_false_skirt"]
    for k, v in jline.items():
        if k in ("wall_s", "metric") or isinstance(v, bool):
            continue
        tol = 0.05 if "px" in k else 2e-3
        assert abs(tline[k] - v) <= tol + 1e-9, (k, tline[k], v)
