"""Whole runs of each driver on the host at tiny sizes, past the look for a
card: the untouched program comes out correct, and a broken timed path comes
out not correct."""
import time

import pytest
import torch

from portbench.lib import manifest

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def run(cell, trace=False, seconds=1.5):
    result, checks = manifest.load_driver(cell.traffic).run(cell, SEED, seconds, trace, CPU, time.perf_counter())
    return result, checks


@pytest.mark.parametrize("name", ["imitate.attlwb_spade_512", "imitate.addlwb_512", "subjects.attlwb_spade_512"])
def test_imitation_runs_correct(tiny, name):
    result, checks = run(tiny(name))
    assert result["correct"], checks
    assert result["attempted"] >= 1 and set(result["metrics"]) == {"frames_per_s", "chunk_gap_ms_p95", "setup_s"}
    assert checks["frame_max_abs_err"]["value"] < 1e-5


def test_imitation_with_an_altered_frame_is_not_correct(tiny, monkeypatch):
    from ipercore_tpu_torch.models import imitator as imit

    real = imit.synthesize_frames

    def altered(*a, **k):
        preds, masks = real(*a, **k)
        return preds + 0.05, masks

    monkeypatch.setattr(imit, "synthesize_frames", altered)
    result, checks = run(tiny("imitate.addlwb_512"))
    assert not result["correct"] and checks["frame_max_abs_err"]["value"] > 0.04


def test_imitation_traced_run_reads_its_metrics(tiny):
    cell = tiny("subjects.attlwb_spade_512")
    result, _ = run(cell, trace=True)
    r = result.pop("run")
    values = {m["name"]: manifest.load_reader(m["name"])(r) for m in cell.per_layer}
    assert values["setup_source_ms.subjects"] > 0 and 0 <= values["device_idle_share.subjects"] < 100
    assert result["breakdown"]["device_ops"] and result["device"]["busy_s"] > 0


def test_personalization_runs_correct(tiny):
    result, checks = run(tiny("personalize.attlwb_spade_512"), seconds=1.0)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"train_steps_per_s", "setup_s"}


def test_a_train_step_that_returns_its_state_unchanged_is_not_correct(tiny, monkeypatch):
    from ipercore_tpu_torch.trainers import lwg_trainer as T

    real = T.train_step

    def unchanged(state, *a, **k):
        _, metrics = real(state, *a, **k)
        return state, metrics

    monkeypatch.setattr(T, "train_step", unchanged)
    result, checks = run(tiny("personalize.attlwb_spade_512"), seconds=1.0)
    assert not result["correct"] and checks["update_norm_gap"]["value"] == pytest.approx(1.0)
