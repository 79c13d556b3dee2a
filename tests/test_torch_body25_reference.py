"""Body-25 in the port against the benchmark's plain reference
(`portbench/reference/pose2d.py`): `OpenPoseRunner.heads` and
`decode_tracked` on 1080p-shaped uint8 frames cut to 72x128 and resized to
48x80, at the published widths, with one seeded state dict loaded into
both; `run_tracked` is `decode_tracked(*heads())` bit for bit; a clip whose
tail is shorter than the batch (padded with its last frame, here to the
batch); the `pose2d.*` spans under the profiler.

Tolerances, set from float32 before the run: heads and scores 1e-5 of the
reference heads' largest magnitude (about 40 layers of float32 sums in
another order and layout; the two differ by under 1e-6 here), keypoints
1e-5 in [-1, 1] of the map, left out where the heads' tolerance may move them
more (`reference.pose2d.unsettled`: near an argmax tie, or a centre of mass
over a mass near 0).
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ipercore_tpu_torch.ops.sampling import resize_image
from ipercore_tpu_torch.tools import pose2d as TP
from ipercore_tpu_torch.utils import logging as tlog
from portbench.lib.weights import seeded_state_dict
from portbench.reference import pose2d as R

FRAMES, H, W, SIZE = 3, 72, 128, (48, 80)
TOL = 1e-5


@pytest.fixture(scope="module")
def rig():
    """(runner, the frames in [-1, 1] at the input size, the reference's
    outputs), the port's and the reference's networks from one seeded state
    dict."""
    with torch.device("meta"):
        shapes = R.Body25()
    sd = seeded_state_dict(shapes, 2 ** 31 + 5, "cpu")
    runner = TP.OpenPoseRunner(device="cpu")
    runner.net.load_state_dict(sd, strict=True)
    net = R.Body25().eval()
    net.load_state_dict(sd, strict=True)
    g = torch.Generator().manual_seed(5)
    low = torch.randn((FRAMES, 3, 3, 4), generator=g)
    img = torch.nn.functional.interpolate(low, size=(H, W), mode="bicubic", align_corners=False)
    frames = ((torch.tanh(img) + 1) * 127.5).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    x = resize_image(frames.float() / 127.5 - 1.0, *SIZE)
    return runner, x, R.clip_outputs(net, frames, SIZE, 0)


def test_heads_and_decode_tracked_match_the_reference(rig):
    runner, x, want = rig
    paf, hm = runner.heads(x, batch_size=2)  # a batch of 2 and a tail of 1
    assert paf.shape == (FRAMES, 6, 10, 52) and hm.shape == (FRAMES, 6, 10, 26)
    s = want["scale"]
    assert float(np.abs(paf.numpy() - want["paf"]).max()) < TOL * s
    assert float(np.abs(hm.numpy() - want["hm"]).max()) < TOL * s
    kps, scores, valid = runner.decode_tracked(paf, hm, smooth=True)
    assert float(np.abs(scores - want["scores"]).max()) < TOL * s
    near = R.unsettled(want, TOL * s)
    assert near.sum() < near.size // 2
    assert float(np.abs(kps - want["kps"]).max(axis=-1)[~near].max()) < TOL
    assert not valid.any()  # seeded heatmaps stay under the 0.1 threshold


def test_run_tracked_is_decode_tracked_of_heads(rig):
    runner, x, _ = rig
    got = runner.run_tracked(x)
    want = runner.decode_tracked(*runner.heads(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_a_tail_batch_gives_the_frames_of_a_full_one(rig):
    runner, x, _ = rig
    assert TP.chunk_frames(FRAMES, 2) == [2, 2] and TP.chunk_frames(65) == [32, 32, 4]
    assert TP.chunk_frames(11) == [11] and TP.chunk_frames(43) == [32, 12]
    tail = runner.heads(x, batch_size=2)
    whole = runner.heads(x, batch_size=FRAMES)
    for t, w in zip(tail, whole):
        assert t.shape == w.shape
        assert float((t - w).abs().max()) < TOL * float(w.abs().max())


def test_pose2d_spans_come_in_order_with_their_attributes(rig):
    """`heads` on its own: a `pose2d.heads` span a chunk, each holding the
    network's three parts and the flip merge; `run_tracked`: all of it under
    one `pose2d.run`, with the fetch and the host decode after the heads."""
    runner, x, _ = rig
    tlog.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        runner.heads(x, batch_size=2)
        runner.run_tracked(x)
    spans = [s for s in tlog.take_spans() if s.name.startswith("pose2d.")]
    chunk = ["pose2d.stem", "pose2d.paf_stages", "pose2d.heatmap_stages", "pose2d.flip_merge", "pose2d.heads"]
    assert [s.name for s in spans] == chunk * 3 + ["pose2d.fetch", "pose2d.decode", "pose2d.run"]
    assert [(s.attrs["frames"], s.attrs["padded"]) for s in spans if s.name == "pose2d.heads"] == \
        [(2, 0), (1, 1), (FRAMES, 0)]
    by_id = {s.id: s for s in spans}
    for k in range(0, 15, 5):
        assert all(s.parent == spans[k + 4].id for s in spans[k:k + 4])
    assert spans[4].parent is None and spans[9].parent is None
    run = spans[-1]
    assert run.parent is None and run.attrs == {"frames": FRAMES, "batches": 1}
    assert all(by_id[s.parent] is run for s in (spans[14], spans[15], spans[16]))
    assert all(s.request == run.id for s in spans[10:])
    assert spans[14].end_ns <= spans[15].start_ns <= spans[15].end_ns <= spans[16].start_ns
    assert spans[16].attrs == {"frames": FRAMES, "peaks": 0, "people": 0}
