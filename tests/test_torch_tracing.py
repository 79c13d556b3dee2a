"""The port's tracing (`utils/logging.py`): spans record only while
`torch.profiler` records, nest with parents and request ids, share the
profiler's clock and empty the store when taken; counters count always; and
the spans at the layer boundaries (`StreamingSynthesizer.run`,
`synthesize_frames`, `setup_source`, `train_step`) come in the numbers and
order their docstrings give. On the CPU at 64² with a narrow AttLWB-SPADE and
the small synthetic body."""
import math
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ipercore_tpu_torch.models import flow_composition as tfc
from ipercore_tpu_torch.models import imitator as timit
from ipercore_tpu_torch.models import smpl as tsmpl
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.models.networks import build_discriminator, build_generator
from ipercore_tpu_torch.models.networks import criterions as TC
from ipercore_tpu_torch.parallel.streaming import StreamingSynthesizer
from ipercore_tpu_torch.trainers import lwg_trainer as TT
from ipercore_tpu_torch.utils import checkpoint as tckpt
from ipercore_tpu_torch.utils import logging as tlog

S, NS = 64, 2
CFG = {
    "BGNet": {"num_filters": [8, 16, 16, 32], "n_res_block": 1},
    "SIDNet": {"num_filters": [8, 16, 32], "n_res_block": 1},
    "TSFNet": {"num_filters": [8, 16, 32], "n_res_block": 1},
}
DIS_CFG = {"ndf": 8, "n_layers": 2, "max_nf_mult": 8, "use_sigmoid": False}


def _theta(count, seed):
    rng = np.random.RandomState(seed)
    th = np.zeros((count, 85), np.float32)
    th[:, 0] = 1.2
    th[:, 3:75] = rng.randn(count, 72) * 0.05
    return th


@pytest.fixture(scope="module")
def rig():
    torch.manual_seed(0)
    model = tsmpl.synthetic_model(nu=20, nv=18, device="cpu")
    comp = tfc.make_composer(model, tload_assets(model, device="cpu", synthetic=True), image_size=S,
                             out_dilate_ks=5)
    gen = build_generator("AttLWB-SPADE", CFG, device="cpu")
    tckpt.load_generator_params(gen, tckpt.seeded_flat_params(gen, 0))
    src_img = torch.as_tensor(np.random.RandomState(0).uniform(-1, 1, (1, NS, S, S, 3)).astype(np.float32))
    src_smpl = torch.as_tensor(_theta(NS, 1)[None])
    return dict(comp=comp, gen=gen, src_img=src_img, src_smpl=src_smpl,
                cache=timit.setup_source(comp, gen, src_img, src_smpl))


@pytest.fixture
def recording():
    """An empty store, and torch.profiler recording (host activity) in the test."""
    tlog.take_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def test_off_by_default_records_nothing():
    tlog.take_spans()
    assert tlog.span("a") is tlog.span("b", chunk=1) is tlog._NO_SPAN
    with tlog.span("a"):
        with tlog.span("b"):
            pass
    assert tlog.take_spans() == []


def test_spans_nest_with_parents_and_request_ids_and_the_store_empties(recording):
    seen = {}

    def other_thread():
        with tlog.span("worker"):
            seen["tid"] = threading.get_native_id()

    with tlog.span("request", n=3):
        with tlog.span("child", chunk=0):
            with tlog.span("grandchild"):
                pass
        worker = threading.Thread(target=other_thread)
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        with tlog.span("child", chunk=1):
            pass
    with tlog.span("next"):
        pass
    spans = {(s.name, s.attrs.get("chunk")): s for s in tlog.take_spans()}
    assert tlog.take_spans() == []
    top, c0, c1 = spans["request", None], spans["child", 0], spans["child", 1]
    g, w, nxt = spans["grandchild", None], spans["worker", None], spans["next", None]
    assert top.parent is None and top.request == top.id and top.attrs == {"n": 3}
    assert c0.parent == c1.parent == top.id and g.parent == c0.id
    assert {c0.request, c1.request, g.request} == {top.id}
    assert w.parent is None and w.request == w.id != top.id and w.thread == seen["tid"] != top.thread
    assert nxt.request == nxt.id not in (top.id, w.id)
    assert top.start_ns <= c0.start_ns <= g.start_ns <= g.end_ns <= c0.end_ns <= c1.start_ns
    assert c1.end_ns <= top.end_ns <= nxt.start_ns


def test_a_span_holds_the_profilers_record_of_its_op():
    tlog.take_spans()
    x = torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tlog.span("sum"):
            x.sum()
    (s,) = tlog.take_spans()
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::sum"]
    assert ops and all(s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns for e in ops)


def test_the_store_keeps_the_newest_spans(recording, monkeypatch):
    import collections

    monkeypatch.setattr(tlog, "_spans", collections.deque(maxlen=3))
    for i in range(5):
        with tlog.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in tlog.take_spans()] == [2, 3, 4]


def test_counters_count_always_and_reset():
    tlog.reset_counts(["test.a", "test.b"])
    tlog.count("test.a")
    tlog.count("test.a", 4)
    tlog.count("test.b", 0)
    got = tlog.counts()
    assert got["test.a"] == 5 and got["test.b"] == 0
    got["test.a"] = 99  # a copy
    tlog.reset_counts(["test.a"])
    assert tlog.counts()["test.a"] == 0


def test_counters_and_spans_lose_nothing_across_threads():
    import sys

    tlog.take_spans()
    tlog.reset_counts(["test.threads"])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                tlog.count("test.threads")
                with tlog.span("t"):
                    pass

        with profile(activities=[ProfilerActivity.CPU]):
            workers = [threading.Thread(target=work) for _ in range(16)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    spans = tlog.take_spans()
    assert tlog.counts()["test.threads"] == 16 * 500 == len(spans)
    assert len({s.id for s in spans}) == len(spans) and all(s.parent is None for s in spans)


@pytest.mark.parametrize("frames,chunk", [(5, 2), (4, 2), (7, 8)])
def test_streaming_records_a_span_per_chunk_and_counts_padding(rig, recording, frames, chunk):
    out = StreamingSynthesizer(rig["comp"], rig["gen"], rig["cache"], chunk=chunk).run(_theta(frames, 2))
    assert len(out) == frames
    spans = tlog.take_spans()
    n_chunks, pad = math.ceil(frames / chunk), (-frames) % chunk
    names = [s.name for s in spans]
    assert names.count("stream.enqueue") == names.count("stream.fetch") == n_chunks
    assert names.count("synth.geometry") == names.count("synth.generator") == n_chunks
    (run,) = [s for s in spans if s.name == "stream.run"]
    assert run.parent is None and run.attrs == {"frames": frames, "padded": pad}
    assert all(s.request == run.id for s in spans)
    enq = sorted((s for s in spans if s.name == "stream.enqueue"), key=lambda s: s.start_ns)
    assert [s.attrs["chunk"] for s in enq] == list(range(n_chunks))
    for s in spans:
        if s.name.startswith("synth."):
            assert s.parent in {e.id for e in enq}


def test_setup_source_records_its_steps_in_order(rig, recording):
    timit.setup_source(rig["comp"], rig["gen"], rig["src_img"], rig["src_smpl"])
    spans = sorted(tlog.take_spans(), key=lambda s: s.start_ns)
    assert [s.name for s in spans] == ["setup.source", "setup.body", "setup.render", "setup.process",
                                       "setup.bgnet", "setup.srcnet"]
    assert all(s.parent == spans[0].id for s in spans[1:])


def test_targets_are_prepared_under_one_span(rig, recording):
    smpls = timit.prepare_target_smpls(rig["comp"].model, rig["cache"], _theta(6, 3))
    (s,) = tlog.take_spans()
    assert s.name == "prepare.targets" and s.parent is None and smpls.shape == (6, 85)


def test_train_step_records_its_six_phases_in_order(rig, recording):
    comp, gen = rig["comp"], rig["gen"]
    dis = build_discriminator("patch_global_body_head", DIS_CFG, device="cpu")
    vgg = TC.VGGFeatures(slices=((4,), (8,), (8,), (8,), (8,))).eval().requires_grad_(False)
    face, _ = TC.build_face_net("sphere20a", device="cpu")
    cfg = TT.TrainConfig()
    state = TT.create_train_state(gen, dis, cfg)
    rng = np.random.RandomState(4)
    batch = {"images": torch.as_tensor(rng.uniform(-1, 1, (1, NS + 1, S, S, 3)).astype(np.float32)),
             "smpls": torch.as_tensor(_theta(NS + 1, 5)[None]),
             "masks": torch.as_tensor((rng.rand(1, NS + 1, S, S, 1) > 0.6).astype(np.float32)),
             "bg": torch.as_tensor(rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32))}
    TT.train_step(state, batch, comp, gen, dis, vgg, face, cfg, ns=NS)
    spans = sorted(tlog.take_spans(), key=lambda s: s.start_ns)
    step = spans[0]
    assert step.name == "train.step" and step.parent is None
    phases = [s for s in spans if s.parent == step.id]
    assert [s.name for s in phases] == ["train.compose", "train.g_forward", "train.g_backward",
                                        "train.g_adam", "train.d_step", "train.d_adam"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
    assert all(s.request == step.id for s in spans)
