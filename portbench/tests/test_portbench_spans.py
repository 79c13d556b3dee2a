"""The program's spans in the benchmark: kernels go under the span that
launched them, not the one they ran in; idle gaps go under the innermost span
by nesting, whatever the order of the lists; the readers of the program's
spans, on synthetic runs and on tiny traced runs on the host;
and a program without spans gives no value."""
import time

import pytest
import torch

from ipercore_tpu_torch.utils import logging as plog
from portbench.lib import manifest
from portbench.lib import program_spans as ps
from portbench.lib.trace import Run

MS = 1_000_000


def span(name, a, b, id_=0, parent=None, **attrs):
    return plog.Span(name, a * MS, b * MS, id_, parent, id_, 1, attrs)


# chunk 0 runs on the device while chunk 1 is launched
PROGRAM = [
    span("stream.enqueue", 0, 10, chunk=0), span("synth.geometry", 1, 4), span("synth.generator", 4, 9),
    span("stream.enqueue", 10, 20, chunk=1), span("synth.geometry", 11, 14), span("synth.generator", 14, 19),
    span("stream.fetch", 20, 60),
]
# the window's clips: 45 frames + 3 padded, and 45 + 3
CLIPS = [span("stream.run", 0, 65, frames=45, padded=3), span("stream.run", 70, 130, frames=45, padded=3)]
HARNESS = [("request", 0, 70 * MS), ("stream", 0, 65 * MS), ("fetch_wait", 20 * MS, 61 * MS)]


def test_kernels_fall_under_the_span_that_launched_them():
    # (name, start, end, correlation id): chunk 0's kernels run while chunk 1 launches
    kernels = [("k1", 5 * MS, 9 * MS, 1), ("gen0", 12 * MS, 30 * MS, 2), ("k2", 30 * MS, 32 * MS, 3),
               ("gen1", 32 * MS, 55 * MS, 4), ("copy", 56 * MS, 57 * MS, 5), ("lost", 58 * MS, 59 * MS, 6)]
    launches = {1: 2 * MS, 2: 5 * MS, 3: 12 * MS, 4: 15 * MS, 5: 21 * MS}
    spans = PROGRAM + HARNESS
    under = ps.launched_under(kernels, launches, spans)
    assert under == ["synth.geometry", "synth.generator", "synth.geometry", "synth.generator",
                     "stream.fetch", "unattributed"]
    by = ps.device_by_span(kernels, launches, spans)
    assert by == pytest.approx({"synth.geometry": 0.006, "synth.generator": 0.041, "stream.fetch": 0.001,
                                "unattributed": 0.001})


def test_a_launch_from_another_thread_falls_under_the_open_span():
    spans = [span("train.step", 0, 100), span("train.g_backward", 40, 80)]
    assert ps.launched_under([("bwd", 90 * MS, 95 * MS, 7)], {7: 50 * MS}, spans) == ["train.g_backward"]


def test_idle_gaps_take_the_innermost_span_whatever_the_list_order():
    kernels = [("a", 0, 2 * MS), ("b", 3 * MS, 21 * MS), ("c", 23 * MS, 30 * MS), ("d", 61 * MS, 62 * MS),
               ("e", 66 * MS, 67 * MS), ("f", 72 * MS, 73 * MS), ("g", 80 * MS, 81 * MS)]
    want = {"synth.geometry": 0.001, "stream.fetch": 0.002 + 0.031, "stream": 0.004, "request": 0.005,
            "host": 0.007}
    assert ps.idle_by_span(kernels, PROGRAM + HARNESS) == pytest.approx(want)
    # the benchmark's spans listed first, or last: the same
    assert ps.idle_by_span(kernels, HARNESS + PROGRAM) == pytest.approx(want)


def test_nesting_prefers_the_later_and_then_the_shorter_span():
    nest = ps.Nesting([("outer", 0, 10), ("inner", 0, 5), ("late", 3, 4)])
    assert [nest.innermost(t) for t in (0, 3, 4, 7, 10)] == ["inner", "late", "inner", "outer", "host"]


@pytest.fixture
def program(monkeypatch):
    """The program's store replaced by given spans."""
    def give(spans):
        monkeypatch.setattr(plog, "take_spans", lambda: list(spans))
    return give


def read(name, run):
    return manifest.load_reader(name)(run)


def test_imitation_readers(program):
    program(PROGRAM + CLIPS)
    run = Run(cell="imitate.addlwb_512", config={}, traffic={}, spans=HARNESS)
    assert read("enqueue_ms_per_chunk.imitate", run) == pytest.approx(10.0)
    assert read("fetch_wait_ms_per_chunk.imitate", run) == pytest.approx(40.0)
    assert read("padded_frame_share.imitate", run) == pytest.approx(100 * 6 / 96)


def test_trainer_readers(program):
    steps = []
    for k, t0 in enumerate((0, 100)):
        steps += [span("train.step", t0, t0 + 90, 10 * k), span("train.compose", t0, t0 + 10),
                  span("train.g_forward", t0 + 10, t0 + 40), span("train.g_backward", t0 + 40, t0 + 60),
                  span("train.g_adam", t0 + 60, t0 + 66), span("train.d_step", t0 + 66, t0 + 80),
                  span("train.d_adam", t0 + 80, t0 + 84)]
    program(steps)
    # gaps: 8 ms in g_adam and 2 ms in d_adam of step 0, 4 ms between the steps (host), 6 ms in
    # compose of step 1
    kernels = [("a", 0, 61 * MS), ("b", 69 * MS, 81 * MS), ("c", 83 * MS, 92 * MS), ("d", 96 * MS, 100 * MS),
               ("e", 106 * MS, 190 * MS)]
    run = Run(cell="personalize.attlwb_spade_512", config={}, traffic={}, kernels=kernels)
    assert read("optimizer_ms_per_step.personalize", run) == pytest.approx(10.0)
    assert read("trainer_idle_ms_per_step.personalize", run) == pytest.approx((8 + 2 + 6) / 2)


def test_a_program_without_spans_gives_no_values(monkeypatch):
    monkeypatch.delattr(plog, "take_spans")
    run = Run(cell="c", config={}, traffic={}, kernels=[("a", 0, 1)], spans=HARNESS)
    for name in ("enqueue_ms_per_chunk.imitate", "fetch_wait_ms_per_chunk.imitate", "padded_frame_share.imitate",
                 "trainer_idle_ms_per_step.personalize", "optimizer_ms_per_step.personalize"):
        assert read(name, run) is None, name


NEW = {"imitate.addlwb_512": ("enqueue_ms_per_chunk.imitate", "fetch_wait_ms_per_chunk.imitate",
                              "padded_frame_share.imitate"),
       "personalize.attlwb_spade_512": ("trainer_idle_ms_per_step.personalize",
                                        "optimizer_ms_per_step.personalize")}


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_traced_run_reads_the_programs_spans(tiny, name):
    cell = tiny(name)
    plog.take_spans()
    result, _ = manifest.load_driver(cell.traffic).run(cell, 2 ** 31 + 91, 1.5, True, torch.device("cpu"),
                                                       time.perf_counter())
    run = result.pop("run")
    values = {m["name"]: manifest.load_reader(m["name"])(run) for m in cell.per_layer}
    assert all(values[k] is not None and values[k] >= 0 for k in NEW[name]), values
    assert ps.spans_of(run) and plog.take_spans() == []
