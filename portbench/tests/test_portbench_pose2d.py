"""The pose cell's driver on the host at a tiny size, past the look for a
card: the untouched program comes out correct, altered heads and heads
without the flip merge come out not correct, a traced run reads all five
metrics; on the card, the TF32 control fails a limit."""
import copy
import time

import pytest
import torch

from portbench.lib import manifest

CPU = torch.device("cpu")
SEED = 2 ** 31 + 21
CELL = "pose2d_video.openpose_body25_368x656"


@pytest.fixture
def pose_cell():
    """The pose cell cut to a size the host runs in seconds: 72x128 frames
    to 48x80, batches of 4, clips of 5-11 frames, a pool of 8 frames. The
    network keeps its widths."""
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = manifest.load_cell(CELL)
    cell.config = dict(copy.deepcopy(cell.config), frame=[72, 128], input=[48, 80], batch=4)
    cell.traffic = dict(cell.traffic, clip_frames={"min": 5, "max": 11, "pairs": 2}, chunk=4,
                        pool=dict(cell.traffic["pool"], frames=8, grid=[3, 4]), trace_seconds=0.5)
    return cell


def run(cell, trace=False, seconds=1.5):
    return manifest.load_driver(cell.traffic).run(cell, SEED, seconds, trace, CPU, time.perf_counter())


def test_pose_runs_correct(pose_cell):
    result, checks = run(pose_cell)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert checks["head_max_rel_err"]["value"] < 1e-5 and checks["nonfinite"]["value"] == 0


@pytest.mark.parametrize("fault", ["altered_heads", "no_flip_merge"])
def test_pose_with_broken_heads_is_not_correct(pose_cell, monkeypatch, fault):
    """Heads moved by a hundredth of their scale, or the network's plain
    heads in place of the flip merge, inside the timed calls."""
    from ipercore_tpu_torch.tools import pose2d

    real = pose2d.OpenPoseRunner._apply

    def broken(self, x):
        paf, hm = real(self, x)
        if fault == "altered_heads":
            return paf + 1e-2 * paf.abs().max(), hm
        return tuple(t[:len(x)] for t in self.net(torch.cat([x, x.flip(2)])))

    monkeypatch.setattr(pose2d.OpenPoseRunner, "_apply", broken)
    result, checks = run(pose_cell)
    assert not result["correct"] and checks["head_max_rel_err"]["value"] > 1e-3


def test_pose_traced_run_reads_its_metrics(pose_cell):
    result, _ = run(pose_cell, trace=True)
    r = result.pop("run")
    values = {m["name"]: manifest.load_reader(m["name"])(r) for m in pose_cell.per_layer}
    assert set(values) == {"stem_ms_per_frame.pose2d", "stages_ms_per_frame.pose2d",
                           "decode_ms_per_frame.pose2d", "device_idle_share.pose2d", "mfu.pose2d"}
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert values["stem_ms_per_frame.pose2d"] > 0 and values["stages_ms_per_frame.pose2d"] > 0
    assert result["breakdown"]["device_ops"] and result["device"]["busy_s"] > 0


@pytest.mark.card
def test_the_tf32_control_fails_a_limit(card, pose_cell):
    cell = pose_cell
    cell.config.update(frame=[540, 960], input=[184, 328], batch=8)
    numbers = manifest.load_driver(cell.traffic).control(cell, 2 ** 31 + 3, card, 2)
    limits = cell.config["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers
