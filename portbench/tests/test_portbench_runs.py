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


def sharded(tiny):
    """The sharded cell at the tiny size, its clips cut to 3 pairs over 10-30
    frames (the CPU taken as each of the four cards)."""
    cell = tiny("imitate_sharded.attlwb_spade_512.x4")
    cell.traffic = dict(cell.traffic, clip_frames={"min": 10, "max": 30, "pairs": 3})
    return cell


def test_sharded_imitation_runs_correct(tiny):
    result, checks = run(sharded(tiny), seconds=2.0)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and set(result["metrics"]) == {"frames_per_s", "chunk_gap_ms_p95", "setup_s"}
    assert checks["frame_max_abs_err"]["value"] < 1e-5


@pytest.mark.parametrize("fault", ["altered", "exchange_left_out"])
def test_sharded_imitation_with_a_broken_card_slice_is_not_correct(tiny, monkeypatch, fault):
    """Inside a sharded call each card's slice is one `synthesize_frames`
    call, in card order: every slice altered, or the slices of every card
    but the first never gathered (zeros in their place), come out not
    correct."""
    from ipercore_tpu_torch.models import imitator as imit
    from ipercore_tpu_torch.parallel import inference

    real_call, real_slice = inference.sharded_synthesize, imit.synthesize_frames
    state = {"card": None, "broken": 0}

    def call(*a, **k):
        state["card"] = 0
        try:
            return real_call(*a, **k)
        finally:
            state["card"] = None

    def broken(*a, **k):
        preds, masks = real_slice(*a, **k)
        card = state["card"]
        if card is None:  # the warm-up's calls outside a sharded call
            return preds, masks
        state["card"] += 1
        if fault == "altered":
            state["broken"] += 1
            return preds + 0.05, masks
        if card == 0:
            return preds, masks
        state["broken"] += 1
        return torch.zeros_like(preds), masks

    monkeypatch.setattr(inference, "sharded_synthesize", call)
    monkeypatch.setattr(imit, "synthesize_frames", broken)
    result, checks = run(sharded(tiny), seconds=2.0)
    assert state["broken"] and not result["correct"] and checks["frame_max_abs_err"]["value"] > 0.04


def test_sharded_imitation_traced_run_reads_its_metrics(tiny):
    cell = sharded(tiny)
    result, _ = run(cell, trace=True, seconds=2.0)
    r = result.pop("run")
    values = {m["name"]: manifest.load_reader(m["name"])(r) for m in cell.per_layer}
    # the host has no copies between cards to read, and the idle share and mfu have a window
    assert values["replica_copy_ms_per_call.imitate_sharded"] is None
    assert 0 <= values["device_idle_share.imitate_sharded"] < 100 and values["mfu.imitate_sharded"] > 0
    assert result["breakdown"]["device_ops"] and result["device"]["busy_s"] > 0
