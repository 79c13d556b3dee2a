"""The port's `eval_pose` (`ipercore_tpu_torch/scripts/eval_real_photos.py`:
Body-25 and Mobilenet PCK@0.1, SPIN's reprojection and the SPIN + SMPLify
chain on the images with Body-25 annotations) against the JAX driver's
`eval_pose` (`scripts/eval_real_photos.py`), on the drawn frames of
`tests/test_torch_tool_scripts_real_photos.py` (annotated clip frames 0, 60,
160 and 180 in a temporary `FRAME_DIR`) and the trained weights of git
history as both packages' default weight files. The chain's SMPLify runs 4
steps on the small synthetic body in both packages (ROADMAP Queue 3: the
fits drift apart beyond about 6).

Tolerances on the reports (both round as the JAX driver does): the same
images, keys and joint counts; PCKs within 1e-3; error fractions within 2e-3.
"""
import pytest

from ipercore_tpu_torch.scripts import eval_real_photos as treal

from tests.test_torch_common import history_weights
from tests.test_torch_tool_scripts_real_photos import FRAMES, _agree
from tests.torch_script_harness import drawn_clip, load_jax_script, point_weights, write_frames

ITERS = 4


@pytest.fixture(scope="module")
def pose_reports(tmp_path_factory):
    import ipercore_tpu.models.smpl as jsmpl
    import ipercore_tpu.tools.pose3d as jpose3d
    import ipercore_tpu_torch.models.smpl as tsmpl
    import ipercore_tpu_torch.tools.pose3d as tpose3d

    frame_dir = str(tmp_path_factory.mktemp("real_frames"))
    write_frames(frame_dir, drawn_clip(len(FRAMES), 540, 960, seed=23), FRAMES)
    weights = {k: history_weights(k, tmp_path_factory) for k in ("openpose", "spin", "mobilenet_openpose")}
    jmod = load_jax_script("eval_real_photos")
    with pytest.MonkeyPatch.context() as m:
        point_weights(m, weights)
        m.setattr(jmod, "FRAME_DIR", frame_dir)
        m.setattr(treal, "FRAME_DIR", frame_dir)
        m.setattr(jsmpl, "template_model", lambda *a, **k: jsmpl.synthetic_model(nu=20, nv=18))
        m.setattr(tsmpl, "template_model", lambda *a, device="cuda", **k: tsmpl.synthetic_model(
            nu=20, nv=18, device=device))
        for mod in (jpose3d, tpose3d):
            fit = mod.smplify_refine_multi
            m.setattr(mod, "smplify_refine_multi", lambda *a, _fit=fit, _mod=mod, **k: _fit(
                *a, cfg=_mod.SMPLifyConfig()._replace(n_iters=ITERS), **k))
        return jmod.eval_pose(), treal.eval_pose(device="cpu")


def test_real_photo_pose_matches_jax(pose_reports):
    j, t = pose_reports
    assert set(j) == {"akun_0000", "akun_0060", "akun_0160"}
    for rec in j.values():
        assert {"pose2d_pck01", "spin_pck01", "refined_pck01"} <= set(rec), rec
    _agree(t, j)
