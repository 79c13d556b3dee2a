"""The port's real-photo evaluation (`ipercore_tpu_torch/scripts/
eval_real_photos.py`: `main --mask`, hence `eval_masks`; `eval_pose` is held
in `tests/test_torch_tool_scripts_real_pose.py`) against
`scripts/eval_real_photos.py` itself, on four drawn
540x960 frames written as the annotated clip frames 0, 60, 160 and 180
into a temporary `FRAME_DIR` (the other annotated frames absent in both),
matplotlib's sample image, and the trained weights of git history as both
packages' default weight files.

Tolerances on the printed JSON (both round as the JAX driver does): the same
keys, images and roles; boxes within 0.5 pixel; box IoUs, coverages, false
positives, mask IoUs and alpha MADs within 2e-3.
"""
import contextlib
import io
import json
import sys

import numpy as np
import pytest

from ipercore_tpu_torch.scripts import eval_real_photos as treal

from tests.test_torch_common import history_weights
from tests.torch_script_harness import drawn_clip, load_jax_script, point_weights, write_frames

FRAMES = (0, 60, 160, 180)


def _agree(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            _agree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _agree(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        tol = 0.5 if "/box[" in path else 1e-3 if "pck" in path else 2e-3
        assert abs(float(got) - want) <= tol, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    frame_dir = str(tmp_path_factory.mktemp("real_frames"))
    write_frames(frame_dir, drawn_clip(len(FRAMES), 540, 960, seed=23), FRAMES)
    seg = history_weights("person_seg", tmp_path_factory)
    jmod = load_jax_script("eval_real_photos")
    out = {}
    with pytest.MonkeyPatch.context() as m:
        point_weights(m, {"person_seg": seg, "matting_gca": None})
        m.setattr(jmod, "FRAME_DIR", frame_dir)
        m.setattr(treal, "FRAME_DIR", frame_dir)
        argv = ["--weights", seg, "--mask"]
        m.setattr(sys, "argv", ["eval_real_photos.py"] + argv)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jmod.main()
        out["jax"] = json.loads(buf.getvalue().strip().splitlines()[-1])
        out["torch"] = treal.main(argv + ["--device", "cpu"])
    return out


def test_real_photo_boxes_match_jax(reports):
    j, t = reports["jax"], reports["torch"]
    on_disk = [k for k, v in j.items() if isinstance(v, dict) and "box_iou" in v]
    assert {f"akun_{f:04d}" for f in FRAMES} | {"grace_hopper"} == set(on_disk)
    assert j["trump_still"] == t["trump_still"] == "input absent"
    assert "pose" not in t and "pose" not in j
    _agree({k: v for k, v in t.items() if k not in ("mask", "weights")},
           {k: v for k, v in j.items() if k not in ("mask", "weights")})
    assert any(v["box"] is not None for k, v in j.items() if k in on_disk)


def test_real_photo_masks_match_jax(reports):
    j, t = reports["jax"]["mask"], reports["torch"]["mask"]
    assert set(j) == {"akun_0060", "akun_0160", "grace_hopper"}
    _agree(t, j)
    assert np.isfinite([v["mask_iou"] for v in t.values()]).all()
