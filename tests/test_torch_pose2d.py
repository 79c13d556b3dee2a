"""2D pose and its host helpers in the port against the JAX package:
`tools/pose2d.py` (Body-25 with the repository's trained `openpose.npz`, the
flip test-time augmentation, the chunked runner and its three decode paths),
`tools/pose2d_mobilenet.py` (with `mobilenet_openpose.npz`),
`tools/pose2d_decode.py`, `tools/trackers.py`, `utils/keypoints.py` and the
2D-pose filters of `utils/smoothing.py`, on the same seeded numpy inputs.

Tolerances: network outputs 1e-4 (absolute), keypoints 1e-4 NDC, scores 1e-4,
`valid` equal; the host code (NMS, grouping, trackers, filters) equal to
float rounding (1e-6). The weight files come from git history
(`tests/test_torch_common.history_weights`). Each JAX network is built from
the same flat parameters (no Flax init) and compiled once per shape.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ipercore_tpu.tools import pose2d as JP
from ipercore_tpu.tools import pose2d_decode as JPD
from ipercore_tpu.tools import pose2d_mobilenet as JM
from ipercore_tpu.tools import trackers as JT
from ipercore_tpu.utils import keypoints as JK
from ipercore_tpu.utils import smoothing as JS
from ipercore_tpu_torch.tools import pose2d as TP
from ipercore_tpu_torch.tools import pose2d_decode as TPD
from ipercore_tpu_torch.tools import pose2d_mobilenet as TM
from ipercore_tpu_torch.tools import trackers as TT
from ipercore_tpu_torch.utils import keypoints as TK
from ipercore_tpu_torch.utils import smoothing as TS
from ipercore_tpu_torch.utils.checkpoint import load_flat_npz

from tests.test_tools.test_pose2d_decode import _scene_two_people
from tests.test_torch_common import history_weights, unflatten_to_jax

CLIP = 33  # frames: one chunk of 32 and a tail chunk of 1
SIZE = 64


def _flat32(path):
    return {k: v.astype(np.float32) for k, v in load_flat_npz(path).items() if not k.startswith("__meta__/")}


def _forward_once_on(runner, clip):
    """Run the runner's chunked forward (the JAX runner's `_forward`, the
    port's `heads`) on `clip` once and hand the same result to every later
    call on `clip` (other inputs, such as the jittered crops, still run the
    network): the decode paths below all start from the clip's forward."""
    name = "heads" if isinstance(runner, TP.OpenPoseRunner) else "_forward"
    real, memo = getattr(runner, name), {}

    def forward(images, batch_size=32):
        if images is not clip or batch_size != 32:
            return real(images, batch_size)
        if "out" not in memo:
            memo["out"] = real(images, batch_size)
        return memo["out"]

    setattr(runner, name, forward)


@pytest.fixture(scope="module")
def body25(tmp_path_factory):
    """(JAX runner, port runner, clip): both with the trained Body-25 weights,
    each running its network on the clip once."""
    path = history_weights("openpose", tmp_path_factory)
    jr = JP.OpenPoseRunner(params=unflatten_to_jax(_flat32(path)))
    tr = TP.OpenPoseRunner(weights_path=path, device="cpu")
    clip = np.random.RandomState(0).uniform(-1, 1, (CLIP, SIZE, SIZE, 3)).astype(np.float32)
    clip[:, 16:56, 24:40] = np.asarray([0.6, -0.2, 0.1], np.float32)  # a flat upright blob
    for runner in (jr, tr):
        _forward_once_on(runner, clip)
    return jr, tr, clip


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def test_runner_loads_the_weight_file_strictly_with_its_meta(body25, tmp_path_factory):
    _, tr, _ = body25
    assert tr.trained and tr.trained_size == 320
    flat = load_flat_npz(history_weights("openpose", tmp_path_factory))
    assert len(flat) == 328 and flat["params/model0/conv1_1/kernel"].dtype == np.float16
    sd = tr.net.state_dict()
    assert len(sd) == 327 and all(v.dtype == torch.float32 for v in sd.values())
    np.testing.assert_array_equal(sd["block02.Mprelu1_stage0_L2_0.weight"].numpy(),
                                  flat["params/block02/Mprelu1_stage0_L2_0/weight"].astype(np.float32))


@pytest.mark.parametrize("size", [64, 88])
def test_body25_forward_and_stages_match_jax(body25, size):
    jr, tr, _ = body25
    x = np.random.RandomState(size).uniform(-0.5, 0.5, (2, size, size + 8, 3)).astype(np.float32)
    want = JP.OpenPoseBody25().apply(jr.params, jnp.asarray(x), return_stages=True)
    with torch.inference_mode():
        got = tr.net(torch.from_numpy(x), return_stages=True)
    assert got[0].shape == (2, size // 8, (size + 8) // 8, 52) and got[1].shape[-1] == 26
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert len(got[2]) == 4 and len(got[3]) == 2
    for g, w in zip(got[2] + got[3], list(want[2]) + list(want[3])):
        _close(g, w)


def test_flip_tables_match_jax():
    perm, sign = TP._body25_paf_flip_tables()
    jperm, jsign = JP._body25_paf_flip_tables()
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(sign, jsign)
    np.testing.assert_array_equal(TP.BODY25_FLIP_JOINTS, JP.BODY25_FLIP_JOINTS)


def test_tta_forward_of_a_clip_with_a_tail_chunk_matches_jax(body25):
    """33 frames: a chunk of 32 and a tail of 1 (JAX pads it to 32)."""
    jr, tr, clip = body25
    jpaf, jhm = jr._forward(clip)
    tpaf, thm = tr.heads(clip)
    assert tpaf.shape == (CLIP, SIZE // 8, SIZE // 8, 52) and thm.shape == (CLIP, SIZE // 8, SIZE // 8, 26)
    _close(tpaf, jpaf)
    _close(thm, jhm)
    # the flip average is not the plain forward: TTA did run
    with torch.inference_mode():
        plain = tr.net(torch.from_numpy(clip[:2]) * 0.5)[1]
    assert float((plain - thm[:2]).abs().max()) > 1e-3


@pytest.mark.parametrize("path", ["run", "run_tracked", "run_tracked_unsmoothed"])
def test_runner_decodes_match_jax(body25, path):
    jr, tr, clip = body25
    kw = {"smooth": False} if path == "run_tracked_unsmoothed" else {}
    name = "run_tracked" if path.startswith("run_tracked") else "run"
    jk, js, jv = getattr(jr, name)(clip, **kw)
    tk, ts, tv = getattr(tr, name)(clip, **kw)
    assert tk.shape == (CLIP, 25, 2) and tk.dtype == np.float32
    _close(tk, jk)
    _close(ts, js)
    np.testing.assert_array_equal(tv, np.asarray(jv))


def test_run_tracked_robust_matches_jax_on_real_decodes(body25):
    jr, tr, clip = body25
    frames = clip[:3]
    want = jr.run_tracked_robust(frames)
    got = tr.run_tracked_robust(frames)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_run_tracked_robust_retry_logic_as_jax():
    """The JAX package's degenerate-decode case with `run_tracked` replaced:
    a degenerate first decode is retried over jittered crops and the winner
    maps back through the window affine; a healthy one is not retried."""
    rng = np.random.RandomState(0)
    good = np.zeros((25, 2), np.float32)
    good[:, 0] = rng.uniform(-0.2, 0.2, 25)
    good[:, 1] = np.linspace(-0.6, 0.6, 25)
    flat = np.zeros((25, 2), np.float32)
    flat[:, 1] = np.linspace(-0.6, 0.6, 25)
    conf = np.full((25,), 0.6, np.float32)
    img = np.random.RandomState(1).uniform(-1, 1, (2, 48, 40, 3)).astype(np.float32)

    def rig(cls, first):
        r = object.__new__(cls)
        calls = []

        def fake(self, images, smooth=True):
            calls.append(images.shape)
            k = first if len(calls) == 1 else good
            n = len(images)
            return (np.repeat(k[None], n, 0).copy(), np.repeat(conf[None], n, 0).copy(), np.ones((n, 25), bool))

        r.run_tracked = types.MethodType(fake, r)
        return r, calls

    for first, retried in ((flat, True), (good, False)):
        (jr, jcalls), (tr, tcalls) = rig(JP.OpenPoseRunner, first), rig(TP.OpenPoseRunner, first)
        want = JP.OpenPoseRunner.run_tracked_robust(jr, img)
        got = TP.OpenPoseRunner.run_tracked_robust(tr, img)
        assert jcalls == tcalls and (len(tcalls) > 1) == retried
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-6)
        tr_t, tcalls_t = rig(TP.OpenPoseRunner, first)  # a tensor input, as `run_tracked` takes
        for g, w in zip(TP.OpenPoseRunner.run_tracked_robust(tr_t, torch.from_numpy(img)), want):
            np.testing.assert_allclose(g, w, atol=1e-6)
        assert len(tcalls_t) == len(tcalls)
    np.testing.assert_allclose(got[0][0], good, atol=1e-6)


def test_affine_window_and_degenerate_test_match_jax():
    img = np.random.RandomState(2).uniform(-1, 1, (40, 56, 3)).astype(np.float32)
    for s, dx, dy in ((0.8, 0.0, 0.0), (1.25, 0.0, 0.0), (0.9, -0.1, 0.0), (1.1, 0.0, 0.1)):
        _close(TP._affine_window(img, s, dx, dy), JP._affine_window(img, s, dx, dy), 1e-5)
    rng = np.random.RandomState(3)
    for _ in range(20):
        kps = rng.uniform(-0.3, 0.3, (25, 2)).astype(np.float32) * rng.uniform(0.05, 2)
        conf = rng.uniform(0, 1, 25).astype(np.float32)
        assert TP._degenerate_decode(kps, conf) == JP._degenerate_decode(kps, conf)


def test_decode_single_person_matches_jax_with_ties():
    rng = np.random.RandomState(4)
    hm = rng.uniform(-0.2, 1, (3, 9, 11, 26)).astype(np.float32)
    hm[0, :, :, 2] = 0.5  # a flat map: every pixel ties, the first wins
    hm[1, 2, 3, 4] = hm[1, 7, 1, 4] = 5.0  # two equal peaks
    hm[2, 0, 10, 5] = 9.0  # a peak in a corner
    for n_joints in (None, 18):
        got = TP.decode_single_person(torch.from_numpy(hm), n_joints=n_joints)
        want = JP.decode_single_person(jnp.asarray(hm), n_joints=n_joints)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_body25_to_cocoplus_and_the_builder():
    kps = np.random.RandomState(5).rand(4, 25, 2).astype(np.float32)
    scores = np.random.RandomState(6).rand(4, 25).astype(np.float32)
    for g, w in zip(TP.body25_to_cocoplus(kps, scores), JP.body25_to_cocoplus(kps, scores)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(KeyError):
        TP.build_pose2d_estimator("nope", device="cpu")


def test_seeded_runners_are_untrained(tmp_path):
    absent = str(tmp_path / "absent.npz")
    op = TP.build_pose2d_estimator("body25", weights_path=absent, device="cpu")
    mb = TP.build_pose2d_estimator("mobilenet", weights_path=absent, device="cpu")
    assert isinstance(op, TP.OpenPoseRunner) and isinstance(mb, TM.MobilenetOpenPoseRunner)
    assert not op.trained and op.trained_size is None and not mb.trained
    assert float(op.net.model0.conv1_1.weight.detach().std()) > 0
    slopes = [p for n, p in op.net.named_parameters() if "prelu" in n.lower()]
    assert slopes and all(bool((p == 0.25).all()) for p in slopes)
    kps, scores, valid = op.run(np.zeros((1, 64, 64, 3), np.float32))
    assert kps.shape == (1, 25, 2) and np.isfinite(kps).all()


@pytest.mark.parametrize("path", ["heads", "run", "run_tracked"])
def test_mobilenet_matches_jax_with_trained_weights(tmp_path_factory, path):
    wpath = history_weights("mobilenet_openpose", tmp_path_factory)
    jr = JM.MobilenetOpenPoseRunner(params=unflatten_to_jax(_flat32(wpath)))
    tr = TM.MobilenetOpenPoseRunner(weights_path=wpath, device="cpu")
    assert tr.trained
    x = np.random.RandomState(7).uniform(-1, 1, (3, 72, 64, 3)).astype(np.float32)
    x[:, 10:60, 24:40] = np.asarray([0.2, 0.5, -0.4], np.float32)
    if path == "heads":
        want = jr._apply(jr.params, jnp.asarray(x)[..., ::-1] * 0.5)
        got = tr._apply(x)
        assert got[0].shape == (3, 9, 8, 19) and got[1].shape == (3, 9, 8, 38)
        _close(got[0], want[0])
        _close(got[1], want[1])
        return
    got, want = getattr(tr, path)(x), getattr(jr, path)(x)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))


# --- host code: trackers, multi-person decode, filters, formatters ------------

def test_trackers_match_jax():
    rng = np.random.RandomState(8)
    jt, tt = JT.build_tracker(), TT.build_tracker()
    for i in range(30):
        k = rng.randint(0, 4)
        xy = rng.uniform(0, 80, (k, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (k, 2))], 1).astype(np.float32)
        if i == 12:
            boxes = None
        g, w = tt(boxes), jt(boxes)
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
        if boxes is not None and len(boxes):
            np.testing.assert_array_equal(TT.box_iou(boxes[0], boxes), JT.box_iou(boxes[0], boxes))
            assert TT.get_largest_instance(boxes) == JT.get_largest_instance(boxes)
    tt.reset()
    assert tt.prev_box is None
    with pytest.raises(KeyError):
        TT.build_tracker("sort")


def test_multi_person_decode_matches_jax_on_two_people():
    hm, pafs, _ = _scene_two_people()
    for j in (0, 1, 8):
        np.testing.assert_array_equal(TPD.extract_peaks(hm[..., j]), JPD.extract_peaks(hm[..., j]))
    got, want = TPD.decode_multi_person(hm, pafs), JPD.decode_multi_person(hm, pafs)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["kps"], w["kps"])
        np.testing.assert_array_equal(g["scores"], w["scores"])
        assert g["n"] == w["n"] and g["score"] == w["score"]
    assert TPD.pick_largest_person(got)["score"] == JPD.pick_largest_person(want)["score"]
    assert TPD.pick_largest_person([]) is None
    # the COCO-18 tables, on the same fields
    peaks = [TPD.extract_peaks(hm[..., j]) for j in range(18)]
    coco = TPD.group_people(peaks, pafs[..., :38], TPD.COCO18_LIMBS, TPD.COCO18_PAF_IDS, 18)
    jcoco = JPD.group_people(peaks, pafs[..., :38], JPD.COCO18_LIMBS, JPD.COCO18_PAF_IDS, 18)
    assert [p["score"] for p in coco] == [p["score"] for p in jcoco]


def test_one_euro_filter_matches_jax_with_nan():
    rng = np.random.RandomState(9)
    tf, jf = TPD.OneEuroFilter(beta=0.3), JPD.OneEuroFilter(beta=0.3)
    for t in range(25):
        x = rng.randn(6, 2) * 2 + t
        if t in (5, 6):
            x[1, 0] = np.nan
        g, w = tf(x), jf(x)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, atol=1e-6)
    assert np.isnan(TPD.OneEuroFilter()(np.asarray([np.nan, 1.0])))[0]


@pytest.mark.parametrize("family", ["OpenPose-Body-25", "CocoWhole-Body-23", "Halpe-Body-26"])
def test_keypoint_formatters_match_jax(family):
    nj = {"OpenPose-Body-25": 25, "CocoWhole-Body-23": 23, "Halpe-Body-26": 26}[family]
    rng = np.random.RandomState(nj)
    stack = rng.uniform(0, 300, (12, nj * 3)).astype(np.float32)
    stack[:, 2::3] = rng.uniform(0, 1, (12, nj))
    tf, jf = TK.build_formatter(family), JK.build_formatter(family)
    assert tf.JOINT_TYPE == jf.JOINT_TYPE == family
    for im_shape in ((480, 320), None):
        for i in (0, 7):
            np.testing.assert_array_equal(
                tf.format_stacked_keypoints(i, {"pose_keypoints_2d": stack}, im_shape),
                jf.format_stacked_keypoints(i, {"pose_keypoints_2d": stack}, im_shape))
    frames = [{"pose_keypoints_2d": s} for s in stack]
    np.testing.assert_array_equal(tf.stack_keypoints(frames)["pose_keypoints_2d"],
                                  jf.stack_keypoints(frames)["pose_keypoints_2d"])
    got = TK.temporal_smooth_keypoints({"pose_keypoints_2d": stack, "other": stack[:, :3]})
    want = JK.temporal_smooth_keypoints({"pose_keypoints_2d": stack, "other": stack[:, :3]})
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5)


@pytest.mark.parametrize("mode", ["median", "low-pass"])
def test_pose2d_temporal_filter_undoes_a_swap_as_jax(mode):
    T, J = 21, 4
    base = np.stack([np.full((T,), 10.0), np.full((T,), 50.0), np.full((T,), 90.0),
                     np.full((T,), 130.0)], axis=1)
    kps = np.stack([base, np.full((T, J), 7.0), np.full((T, J), 0.9)], axis=-1).astype(np.float32)
    kps[:, :, :2] += np.random.RandomState(10).randn(T, J, 2).astype(np.float32)
    swapped = kps.copy()
    swapped[10, 0], swapped[10, 1] = kps[10, 1], kps[10, 0]
    got = TS.pose2d_temporal_filter(swapped, window_size=5, mode=mode)
    np.testing.assert_allclose(got, JS.pose2d_temporal_filter(swapped, window_size=5, mode=mode), atol=1e-6)
    if mode == "median":
        np.testing.assert_allclose(got[10], kps[10], atol=1e-6)
    with pytest.raises(ValueError):
        TS.pose2d_temporal_filter(swapped, mode="mean")


def test_smoothing_helpers_match_jax():
    rng = np.random.RandomState(11)
    kps = rng.randn(9, 5, 2).astype(np.float32)
    valid = rng.rand(9, 5) > 0.3
    valid[:, 0] = False
    np.testing.assert_allclose(TS.interpolate_invalid_kps(kps, valid), JS.interpolate_invalid_kps(kps, valid),
                               atol=1e-6)
    np.testing.assert_array_equal(TS.median_filter_time(kps, 3), JS.median_filter_time(kps, 3))
    init = rng.uniform(-0.2, 0.2, (8, 72)).astype(np.float32)
    opt = init + rng.uniform(-0.01, 0.01, (8, 72)).astype(np.float32)
    opt[3] += np.pi
    got = TS.pose_temporal_smooth(init, opt, threshold=10.0)
    np.testing.assert_allclose(got, JS.pose_temporal_smooth(init, opt, threshold=10.0), atol=1e-6)
    np.testing.assert_array_equal(got[3], init[3])
