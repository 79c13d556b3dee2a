"""The train service's host side against the JAX package: the datasets (all
four classes, `build_dataset`, the splits, rank sharding), the copy of
`jax.image.resize(..., "linear")`, `prefetch`, `MetricsLogger`,
`save_train_panel`, the live dashboard and `profile_trace`.

Tolerances: SMPLs and ids equal; images, masks and backgrounds within 1e-6
(the JAX package resizes with `jax.image.resize`, the port with its numpy
copy, whose contraction order differs); the resize copy within 1e-5 of
`jax.image.resize`; panels and logs equal.
"""
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from ipercore_tpu.data import datasets as jds
from ipercore_tpu.data.prefetch import prefetch as jprefetch
from ipercore_tpu.utils import logging as jlogging
from ipercore_tpu.utils.visualizer import save_train_panel as jpanel
from ipercore_tpu_torch.data import datasets as tds
from ipercore_tpu_torch.data.prefetch import prefetch as tprefetch
from ipercore_tpu_torch.utils import logging as tlogging
from ipercore_tpu_torch.utils import video as tvid
from ipercore_tpu_torch.utils.visualizer import save_train_panel as tpanel

from tests.test_torch_common import write_train_video

S = 64
NS, NT = 2, 1


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Three videos (one with masks at 48², one with masks at 64², a
    background and front ids, one bare), one too short to train on, a
    `train.txt` naming two of them and no `val.txt`; and a folder of
    backgrounds of other sizes and shapes."""
    r = str(tmp_path_factory.mktemp("dataset"))
    write_train_video(r, "v0", 6, seed=1, mask_size=48)
    write_train_video(r, "v1", 5, seed=2, mask_size=S, background=True, front_ids=(3,))
    write_train_video(r, "v2", 4, seed=3)
    write_train_video(r, "short", 2, seed=4)
    with open(os.path.join(r, "train.txt"), "w") as f:
        f.write("v0\nv1\n\nshort\n")
    bgs = os.path.join(r, "backgrounds")
    os.makedirs(bgs)
    rng = np.random.RandomState(5)
    for i, (h, w) in enumerate([(40, 56), (70, 50), (64, 64), (100, 90)]):
        tvid.save_image(os.path.join(bgs, f"bg_{i}.png"), rng.uniform(-1, 1, (h, w, 3)).astype(np.float32))
    return r


def _same_batch(a: dict, b: dict, keys) -> None:
    assert set(a) == set(b) == set(keys)
    for k in keys:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if k == "smpls":
            np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=0, atol=1e-6, err_msg=k)


def _batches(ds, n, **kw):
    it = ds.iterate(**kw)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("split", ["train", "val"])
def test_processed_video_batches_match_jax(root, split):
    """`train` reads `train.txt` (the short video is passed over); `val` has
    no `val.txt`, so every video is listed."""
    kw = dict(dataset_dirs=[root], image_size=S, num_source=NS, time_step=NT, split=split)
    j, t = jds.build_dataset("ProcessedVideo", **kw), tds.build_dataset("ProcessedVideo", **kw)
    assert [v["proc"] for v in t.videos] == [v["proc"] for v in j.videos]
    assert len(t) == (2 if split == "train" else 3)
    for a, b in zip(_batches(t, 3, batch_size=2, seed=3), _batches(j, 3, batch_size=2, seed=3)):
        _same_batch(a, b, ("images", "smpls", "masks", "bg"))
        assert a["images"].shape == (2, NS + NT, S, S, 3) and a["masks"].shape == (2, NS + NT, S, S, 1)


def test_samples_and_draw_order_match_jax(root):
    """`sample` (offsets included) and the random draws: the same generator
    state after each sample."""
    kw = dict(dataset_dirs=[root], image_size=S, num_source=NS, time_step=2, split="val")
    j, t = jds.ProcessedVideoDataset(**kw), tds.ProcessedVideoDataset(**kw)
    rj, rt = np.random.RandomState(11), np.random.RandomState(11)
    for vid_idx in (None, None, 1, None):
        a, b = t.sample(rt, vid_idx), j.sample(rj, vid_idx)
        _same_batch({k: a[k] for k in ("images", "smpls", "masks", "bg")},
                    {k: b[k] for k in ("images", "smpls", "masks", "bg")}, ("images", "smpls", "masks", "bg"))
        assert (a["offsets"] is None) == (b["offsets"] is None)
        assert rt.randint(1 << 30) == rj.randint(1 << 30)


def test_personalized_dataset_matches_jax_and_refuses_a_split(root):
    proc = os.path.join(root, "primitives", "v1", "processed")
    j = jds.build_dataset("Personalized", processed_dir=proc, image_size=S, num_source=NS, time_step=NT)
    t = tds.build_dataset("Personalized", processed_dir=proc, image_size=S, num_source=NS, time_step=NT)
    for a, b in zip(_batches(t, 2, batch_size=2, seed=0), _batches(j, 2, batch_size=2, seed=0)):
        _same_batch(a, b, ("images", "smpls", "masks", "bg"))
    for build in (jds.build_dataset, tds.build_dataset):
        with pytest.raises(TypeError):
            build("Personalized", processed_dir=proc, image_size=S, split="val")
    with pytest.raises(KeyError, match="unknown dataset"):
        tds.build_dataset("nope")


def test_background_crops_match_jax(root):
    """Random square crops of non-square images, flipped at random, resized
    up and down."""
    bgs = os.path.join(root, "backgrounds")
    j, t = jds.BackgroundDataset(bgs, S), tds.BackgroundDataset(bgs, S)
    assert len(t) == len(j) == 4
    rj, rt = np.random.RandomState(2), np.random.RandomState(2)
    for _ in range(8):
        a, b = t.sample(rt), j.sample(rj)
        assert a.shape == (S, S, 3) and a.dtype == np.float32
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    empty = tds.BackgroundDataset(os.path.join(root, "missing"), S)
    assert len(empty) == 0 and not empty.sample(rt).any()


def test_video_background_batches_match_jax(root):
    kw = dict(dataset_dirs=[root], image_size=S, num_source=NS, time_step=NT,
              background_dir=os.path.join(root, "backgrounds"))
    j, t = jds.build_dataset("ProcessedVideo+Place2", **kw), tds.build_dataset("ProcessedVideo+Place2", **kw)
    assert len(t) == len(j) == 2
    for a, b in zip(_batches(t, 2, batch_size=3, seed=4), _batches(j, 2, batch_size=3, seed=4)):
        _same_batch(a, b, ("images", "smpls", "masks", "bg", "aug_bg"))


@pytest.mark.parametrize("mode", ["ProcessedVideo", "ProcessedVideo+Place2"])
def test_rank_rows_concatenate_to_the_global_batch(root, mode):
    """Two ranks of 2 rows each: their rows, concatenated, are JAX's batch of
    4 from the same seed, round after round."""
    kw = dict(dataset_dirs=[root], image_size=S, num_source=NS, time_step=NT, split="val",
              background_dir=os.path.join(root, "backgrounds"))
    if mode == "ProcessedVideo":
        kw.pop("background_dir")
    t = tds.build_dataset(mode, **kw)
    want = _batches(jds.build_dataset(mode, **kw), 3, batch_size=4, seed=9)
    ranks = [_batches(t, 3, batch_size=2, seed=9, rank=r, world=2) for r in (0, 1)]
    for i, b in enumerate(want):
        got = {k: np.concatenate([ranks[0][i][k], ranks[1][i][k]]) for k in ranks[0][i]}
        _same_batch(got, b, tuple(b))


@pytest.mark.parametrize("shape,out", [((37, 53, 3), (64, 64, 3)), ((128, 96, 1), (64, 64, 1)),
                                       ((3, 100, 80, 1), (3, 64, 64, 1)), ((33, 33, 3), (128, 128, 3)),
                                       ((512, 512, 3), (64, 64, 3)), ((8, 8, 2), (8, 8, 2))])
def test_resize_linear_matches_jax_image_resize(shape, out):
    x = np.random.RandomState(0).uniform(-1, 1, shape).astype(np.float32)
    got = tds.resize_linear(x, out)
    assert got.shape == out and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jax.image.resize(x, out, "linear")), rtol=0, atol=1e-5)


def test_prefetch_keeps_order_and_reraises():
    assert list(tprefetch(iter(range(50)), depth=3)) == list(jprefetch(iter(range(50)), depth=3))

    def broken():
        yield 1
        yield 2
        raise ValueError("decode failed")

    it = tprefetch(broken(), depth=1)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(ValueError, match="decode failed"):
        next(it)


def test_metrics_logger_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jlogging.time, "time", lambda: 1234.5)
    monkeypatch.setattr(tlogging.time, "time", lambda: 1234.5)
    rows = [dict(step=0, g_total=3.14159265, d_total=0.5), dict(step=7, g_total=1e-7, name="x")]
    for mod, name in ((jlogging, "j"), (tlogging, "t")):
        log = mod.MetricsLogger(str(tmp_path / name / "log.jsonl"))
        for r in rows:
            log.log(**r)
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] and out[0] == "[metrics] step=0 g_total=3.142 d_total=0.5"
    assert (tmp_path / "t" / "log.jsonl").read_text() == (tmp_path / "j" / "log.jsonl").read_text()
    assert json.loads((tmp_path / "t" / "log.jsonl").read_text().splitlines()[1]) == {"t": 1234.5, **rows[1]}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with tlogging.profile_trace(str(tmp_path / "trace")):
        with tlogging.span("outer", chunk=2):
            with tlogging.span("inner"):
                torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        trace = json.load(f)
    spans = {e["name"]: e for e in trace["traceEvents"] if e.get("cat") == "span"}
    assert set(spans) == {"outer", "inner"} and spans["outer"]["args"]["chunk"] == 2
    assert spans["inner"]["args"]["parent"] == spans["outer"]["args"]["id"]
    assert spans["outer"]["ts"] <= spans["inner"]["ts"] and spans["inner"]["dur"] <= spans["outer"]["dur"]
    ops = [e for e in trace["traceEvents"] if e.get("name") == "aten::sum" and e.get("ph") == "X"]
    assert ops and all(spans["inner"]["ts"] <= e["ts"] <= spans["inner"]["ts"] + spans["inner"]["dur"]
                       for e in ops)
    assert tlogging.take_spans() == []
    with tlogging.profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


def test_train_panel_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    rows = {"src": rng.uniform(-1.2, 1.2, (3, 16, 16, 3)).astype(np.float32),
            "mask": rng.uniform(0, 1, (3, 16, 16, 1)).astype(np.float32),
            "gray": rng.uniform(-1, 1, (3, 16, 16)).astype(np.float32)}
    a = tpanel(str(tmp_path / "t" / "panel.png"), rows)
    b = jpanel(str(tmp_path / "j" / "panel.png"), rows)
    pa, pb = tvid.read_png(a), tvid.read_png(b)
    assert pa.shape == (48, 48, 3)
    np.testing.assert_array_equal(pa, pb)


def test_live_dashboard_serves_metrics_and_panels(tmp_path):
    from ipercore_tpu_torch.utils.live_dashboard import LiveDashboard, render_page
    from ipercore_tpu.utils.live_dashboard import render_page as jrender_page

    log = tmp_path / "train_log.jsonl"
    with open(log, "w") as f:
        for i in range(20):
            f.write(json.dumps({"t": i, "step": i, "g_total": 3.0 - 0.1 * i, "d_total": 1.0 + 0.01 * i}) + "\n")
    panels = tmp_path / "panels"
    panels.mkdir()
    tvid.save_image(str(panels / "panel_iter_00000001.png"), np.zeros((8, 8, 3), np.float32))
    assert render_page(str(log), str(panels)) == jrender_page(str(log), str(panels))

    dash = LiveDashboard(str(log), str(panels), port=0).start()
    try:
        base = f"http://127.0.0.1:{dash.port}"
        page = urllib.request.urlopen(base + "/", timeout=10).read().decode()
        assert "g_total" in page and "polyline" in page and "panel_iter_00000001.png" in page
        png = urllib.request.urlopen(base + "/panel/panel_iter_00000001.png", timeout=10).read()
        assert png[:4] == b"\x89PNG"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/panel/../train_log.jsonl", timeout=10)
        assert e.value.code == 404
    finally:
        dash.stop()
