"""The port's three pseudo-labellers (`ipercore_tpu_torch/scripts/
pseudo_label_{pose,seg,theta}.py`) against the JAX drivers themselves,
chained as they are run (pose, then seg reading the pose labels beside its
output, then theta reading them), on a drawn static-camera clip of 10 frames
of 1080x1920 (a synthetic person walking across a plate, `tests/
torch_script_harness.drawn_clip`) written as PNGs into a temporary
`FRAME_DIR` (both packages' frame directory pointed there, the held-out band
moved to frame 10), with the trained weights of git history (`tests/test_torch_common.history_weights`)
as both packages' default weight files, each driver writing into a
temporary directory. SMPLify runs `--iters 4` on the small synthetic body:
the two packages' fits drift apart beyond about 6 steps (ROADMAP Queue 3).

Tolerances: the kept frames, joint masks and pseudo-masks equal; boxes within
0.5 pixel; the 8-bit crops (stored f16) within 2e-3; the keypoint labels
within 1e-4 (crop NDC); thetas within 1e-4 and the stored mean and median
reprojection errors (4 decimals) within 1e-4; the other stats equal but the
mean deviation, within 0.01 pixel.
"""
import json
import os
import sys

import numpy as np
import pytest

from ipercore_tpu_torch.scripts import eval_real_photos as treal
from ipercore_tpu_torch.scripts import pseudo_label_pose as tpose
from ipercore_tpu_torch.scripts import pseudo_label_seg as tseg
from ipercore_tpu_torch.scripts import pseudo_label_theta as ttheta

from tests.test_torch_common import history_weights
from tests.torch_script_harness import (drawn_clip, jax_scripts_module, load_jax_script, point_weights,
                                        write_frames)

N = 10  # frames before the held-out band
ITERS = 4


@pytest.fixture(scope="module")
def labelled(tmp_path_factory):
    """{package: {stage: (printed stats, npz dict)}} of the three drivers."""
    import ipercore_tpu.models.smpl as jsmpl
    import ipercore_tpu_torch.models.smpl as tsmpl

    frame_dir = str(tmp_path_factory.mktemp("real_frames"))
    write_frames(frame_dir, drawn_clip(N, 1080, 1920, seed=23), range(N))
    weights = {k: history_weights(k, tmp_path_factory) for k in ("person_seg", "openpose", "spin")}
    out = {}
    with pytest.MonkeyPatch.context() as m:
        point_weights(m, dict(weights, matting_gca=None))
        m.setattr(jax_scripts_module("eval_real_photos"), "FRAME_DIR", frame_dir)
        m.setattr(treal, "FRAME_DIR", frame_dir)
        m.setattr(jsmpl, "template_model", lambda *a, **k: jsmpl.synthetic_model(nu=20, nv=18))
        m.setattr(tsmpl, "template_model", lambda *a, device="cuda", **k: tsmpl.synthetic_model(
            nu=20, nv=18, device=device))
        for mod in (tpose, tseg):
            m.setattr(mod, "VAL_BAND_START", N)
        jdir, tdir = tmp_path_factory.mktemp("jax_labels"), tmp_path_factory.mktemp("torch_labels")
        jmods = {s: load_jax_script(f"pseudo_label_{s}") for s in ("pose", "seg", "theta")}
        for s in ("pose", "seg"):
            m.setattr(jmods[s], "VAL_BAND_START", N)
        m.setattr(jmods["theta"], "IN_NPZ", str(jdir / "akun_pseudo.npz"))
        m.setattr(jmods["theta"], "OUT_NPZ", str(jdir / "akun_theta.npz"))
        argv = {"pose": ["--out", "{d}/akun_pseudo.npz"], "seg": ["--out", "{d}/akun_seg.npz"],
                "theta": ["--iters", str(ITERS)]}
        targv = {"theta": ["--in_npz", "{d}/akun_pseudo.npz", "--out", "{d}/akun_theta.npz"]}
        files = {"pose": "akun_pseudo.npz", "seg": "akun_seg.npz", "theta": "akun_theta.npz"}
        for pkg, d in (("jax", jdir), ("torch", tdir)):
            out[pkg] = {}
            for s in ("pose", "seg", "theta"):
                args = [a.format(d=d) for a in argv[s]]
                if pkg == "jax":
                    m.setattr(sys, "argv", [f"pseudo_label_{s}.py"] + args)
                    jmods[s].main()
                    stats = None
                else:
                    args += [a.format(d=d) for a in targv.get(s, [])] + ["--device", "cpu"]
                    stats = {"pose": tpose, "seg": tseg, "theta": ttheta}[s].main(args)
                path = os.path.join(str(d), files[s])
                assert os.path.exists(path), path
                with np.load(path, allow_pickle=True) as z:
                    out[pkg][s] = (stats, {k: z[k] for k in z.files})
    return out


def test_pose_labels_match_jax(labelled):
    _, j = labelled["jax"]["pose"]
    stats, t = labelled["torch"]["pose"]
    assert stats["n_kept"] == len(j["frames"]) > 0
    np.testing.assert_array_equal(t["frames"], j["frames"])
    np.testing.assert_array_equal(t["valid"], j["valid"])
    np.testing.assert_allclose(t["boxes"], j["boxes"], atol=0.5)
    np.testing.assert_allclose(t["origins"], j["origins"], atol=0.5)
    np.testing.assert_allclose(t["crops"].astype(np.float32), j["crops"].astype(np.float32), atol=2e-3)
    np.testing.assert_allclose(t["kps_ndc"], j["kps_ndc"], atol=1e-4)
    jm, tm = json.loads(str(j["meta"])), json.loads(str(t["meta"]))
    assert abs(jm.pop("mean_dev_px") - tm.pop("mean_dev_px")) <= 0.01
    assert jm == tm


def test_seg_pseudo_masks_match_jax(labelled):
    _, j = labelled["jax"]["seg"]
    stats, t = labelled["torch"]["seg"]
    assert stats["kept"] == len(j["frames"]) > 0
    np.testing.assert_array_equal(t["frames"], j["frames"])
    np.testing.assert_array_equal(t["masks"], j["masks"])
    np.testing.assert_allclose(t["imgs"].astype(np.float32), j["imgs"].astype(np.float32), atol=2e-3)
    assert json.loads(str(t["meta"])) == json.loads(str(j["meta"]))


def test_theta_labels_match_jax(labelled):
    _, j = labelled["jax"]["theta"]
    stats, t = labelled["torch"]["theta"]
    assert stats["kept"] == len(j["frames"])
    np.testing.assert_array_equal(t["frames"], j["frames"])
    np.testing.assert_allclose(t["theta"], j["theta"], atol=1e-4)
    jm, tm = json.loads(str(j["meta"])), json.loads(str(t["meta"]))
    for k in ("err_mean", "err_med"):
        assert abs(jm.pop(k) - tm.pop(k)) <= 1e-4 + 1e-9, k
    assert jm == tm
