"""Person detection, the person segmenter and the crop geometry in the port
against the JAX package: `tools/detection.py` (every box source and
`detect_person_boxes`), the segmenter of `tools/mattors.py` (with the
repository's trained `person_seg.npz`, whose refiner `run` also takes) and `tools/preprocessor.py`'s stage
1.1-1.2 geometry, on the same seeded numpy inputs.

Tolerances: segmenter probabilities 1e-4 (and >= 99.5 % of `run`'s masks
equal, its alphas within 1e-4), boxes 1e-3 px with the same
`method` string, crops 1e-5, host code equal. The trained pose net runs here
behind `SmallPose`, which shrinks the 368² frames `pose_person_boxes` hands
it to 64² in both packages, so that 48 frames of Body-25 stay a CPU-sized test.
"""
import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from ipercore_tpu.tools import detection as JD
from ipercore_tpu.tools import mattors as JMa
from ipercore_tpu.tools import pose2d as JP
from ipercore_tpu.tools import preprocessor as JPre
from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.tools import detection as TD
from ipercore_tpu_torch.tools import mattors as TMa
from ipercore_tpu_torch.tools import pose2d as TP
from ipercore_tpu_torch.tools import preprocessor as TPre
from ipercore_tpu_torch.utils.checkpoint import flax_params_to_torch, load_flat_npz, seeded_flat_params

from tests.test_tools.test_detection import _scene
from tests.test_torch_common import flatten_flax, history_weights, unflatten_to_jax

WORK = 128  # the segmenter's working grid here (256 by default)


def drawn_person(H: int, W: int, cx: float, cy: float, s: float) -> np.ndarray:
    """(H, W) bool silhouette of a standing person of height ~s: head, torso,
    arms and legs."""
    yy, xx = np.mgrid[:H, :W]
    m = (xx - cx) ** 2 + (yy - (cy - 0.42 * s)) ** 2 < (0.08 * s) ** 2
    m |= (abs(xx - cx) < 0.13 * s) & (yy > cy - 0.33 * s) & (yy < cy + 0.05 * s)
    for side in (-1, 1):
        m |= (abs(xx - cx - side * 0.06 * s) < 0.05 * s) & (yy >= cy + 0.05 * s) & (yy < cy + 0.5 * s)
        m |= (abs(xx - cx - side * 0.18 * s) < 0.04 * s) & (yy > cy - 0.3 * s) & (yy < cy + 0.02 * s)
    return m


def person_frames(n: int, H: int = 144, W: int = 192, seed: int = 0) -> np.ndarray:
    """`n` frames of a drawn person walking right over a static textured
    background, with camera noise, in [-1, 1]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    bg = (0.4 * np.sin(xx / 9.0)[..., None] * np.asarray([0.5, 0.3, 0.2])
          + 0.2 * rng.uniform(-1, 1, (H, W, 3)) - 0.2)
    tex = np.stack([0.3 + 0.2 * np.sin(yy / 5.0), -0.5 + 0.1 * np.cos(xx / 7.0), np.full((H, W), 0.6)], -1)
    out = np.empty((n, H, W, 3), np.float32)
    for i in range(n):
        m = drawn_person(H, W, 0.35 * W + 0.3 * W * i / max(n - 1, 1), 0.52 * H, 0.78 * H)
        out[i] = np.where(m[..., None], tex, bg) + 0.02 * rng.randn(H, W, 3)
    return np.clip(out, -1, 1)


def color_still() -> np.ndarray:
    """The JAX package's colour-model still (`test_color_model_still_box`)."""
    rng = np.random.RandomState(2)
    img = (rng.uniform(-1, 1, (120, 160, 3)) * 0.2 - 0.5).astype(np.float32)
    img[30:100, 60:95] = np.asarray([0.8, 0.1, -0.2], np.float32)
    return img[None]


class SmallPose:
    """A trained runner behind `pose_person_boxes`: its 368² frames (numpy
    or a tensor) go through `resize_linear` to 64² first."""

    trained = True

    def __init__(self, runner, size: int = 64):
        self.runner, self.size = runner, size

    def run_tracked(self, x, smooth=True):
        x = np.asarray(x)
        return self.runner.run_tracked(resize_linear(x, (len(x), self.size, self.size, 3)), smooth=smooth)


class Untrained:
    trained = False


class SkeletonPose:
    """The JAX package's fake trained runner: a confident standing skeleton
    (`test_pose_person_boxes_gating`)."""

    trained = True

    def run_tracked(self, x, smooth=False):
        n = len(x)
        kps = np.zeros((n, 25, 2), np.float32)
        scores = np.zeros((n, 25), np.float32)
        for j, y in zip([1, 2, 5, 9, 12, 10, 13, 11, 14, 8], np.linspace(-0.4, 0.8, 10)):
            kps[:, j] = [0.1, y]
            scores[:, j] = 0.8
        return kps, scores, scores > 0.1


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """Both packages' trained segmenter (the `seg` tree of `person_seg.npz`),
    trained Body-25 behind `SmallPose`, and untrained segmenters."""
    seg_path = history_weights("person_seg", tmp_path_factory)
    pose_path = history_weights("openpose", tmp_path_factory)
    absent = str(tmp_path_factory.mktemp("none") / "absent.npz")
    pose_flat = {k: v.astype(np.float32) for k, v in load_flat_npz(pose_path).items()
                 if not k.startswith("__meta__/")}
    return {
        "seg_path": seg_path,
        "jax": {"mattor": JMa.HumanMattor(weights_path=seg_path, image_size=64),
                "pose": SmallPose(JP.OpenPoseRunner(params=unflatten_to_jax(pose_flat))),
                "blank": JMa.HumanMattor(weights_path=absent, gca_weights_path=absent, image_size=64)},
        "port": {"mattor": TMa.HumanMattor(weights_path=seg_path, device="cpu"),
                 "pose": SmallPose(TP.OpenPoseRunner(weights_path=pose_path, device="cpu")),
                 "blank": TMa.HumanMattor(weights_path=absent, gca_weights_path=absent, device="cpu")},
    }


# --- the segmenter ------------------------------------------------------------

def test_segmenter_loads_the_seg_tree_and_matches_jax(nets):
    jm, tm = nets["jax"]["mattor"], nets["port"]["mattor"]
    assert tm.trained and jm.trained and not nets["port"]["blank"].trained
    assert set(tm.seg_params) == set(flatten_flax(jm.seg_params))
    trees, jtrees = TMa.load_default_weights(nets["seg_path"]), JMa.load_default_weights(nets["seg_path"])
    assert set(trees) == set(jtrees) == {"seg", "mat"}
    for top in trees:
        want_tree = flatten_flax(jtrees[top])
        assert set(trees[top]) == set(want_tree)
        for k, v in trees[top].items():
            assert v.dtype == np.float32
            np.testing.assert_array_equal(v, np.asarray(want_tree[k]))
    x = person_frames(2, 96, 128, seed=1)
    want = np.asarray(fnn.sigmoid(jm._seg(jm.seg_params, jnp.asarray(x))))
    got = torch.sigmoid(tm.segment(x)).numpy()
    assert got.shape == (2, 96, 128, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (want > 0.5).mean() > 0.03  # the trained net finds the drawn person
    # the matting half reads the file's `mat` tree too (a `MattingRefiner`,
    # as JAX builds without `matting_gca.npz`) and runs as JAX's
    assert isinstance(tm.mat, TMa.MattingRefiner) and isinstance(jm.mat, JMa.MattingRefiner)
    alpha, mask = tm.run(x)
    jalpha, jmask = jm.run(x)
    assert alpha.shape == mask.shape == (2, 96, 128, 1)
    assert (mask == np.asarray(jmask)).mean() >= 0.995
    assert (np.abs(alpha - np.asarray(jalpha)) <= 1e-4).mean() >= 0.995


def test_seeded_segmenter_is_untrained_with_slopes_and_shapes(nets, tmp_path):
    blank = nets["port"]["blank"]
    assert set(blank.seg_params) == set(nets["port"]["mattor"].seg_params)
    assert TMa.load_default_weights(str(tmp_path / "no.npz")) is None
    out = blank.segment(np.zeros((1, 32, 48, 3), np.float32))
    assert out.shape == (1, 32, 48, 1) and torch.isfinite(out).all()


@pytest.mark.parametrize("gca_trees", [("seg", "mat"), ("seg",)])
def test_segmenter_falls_back_to_the_gca_file_as_jax(nets, tmp_path, gca_trees):
    """Without `person_seg.npz`, the `seg` tree of `matting_gca.npz` when that
    file also holds a `mat` tree (JAX then runs the GCA refiner); else seeds."""
    seg = {f"seg/{k}": v.astype(np.float16) for k, v in nets["port"]["mattor"].seg_params.items()}
    mat = ({f"mat/{k}": v.astype(np.float16) for k, v in seeded_flat_params(TMa.GCAMattingRefiner(), 8).items()}
           if "mat" in gca_trees else {})
    gca = str(tmp_path / "gca.npz")
    np.savez(gca, **seg, **mat)
    absent = str(tmp_path / "absent.npz")
    jm = JMa.HumanMattor(weights_path=absent, gca_weights_path=gca, image_size=64)
    tm = TMa.HumanMattor(weights_path=absent, gca_weights_path=gca, device="cpu")
    assert tm.trained == jm.trained == ("mat" in gca_trees)
    if tm.trained:
        want = flatten_flax(jm.seg_params)
        assert set(tm.seg_params) == set(want)
        for k, v in tm.seg_params.items():
            np.testing.assert_array_equal(v, np.asarray(want[k]))


def test_conv_transpose_same_matches_flax_on_an_asymmetric_input():
    """Flax `ConvTranspose((4, 4), strides=(2, 2), padding="SAME")` against
    the carrier's layout in `nn.ConvTranspose2d(4, stride=2, padding=1)`:
    an input with no symmetry, so a one-pixel shift would show."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    layer = fnn.ConvTranspose(4, (4, 4), strides=(2, 2), padding="SAME")
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.arange(a.size).reshape(a.shape) / a.size, params)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    flat = {f"params/ConvTranspose_0/{k}": np.asarray(v) for k, v in params["params"].items()}
    deconv = torch.nn.ConvTranspose2d(3, 4, 4, stride=2, padding=1)
    wrapper = torch.nn.Module()
    wrapper.ConvTranspose_0 = deconv
    wrapper.load_state_dict(flax_params_to_torch(flat, like=wrapper.state_dict()))
    with torch.no_grad():
        got = deconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# --- host pieces ----------------------------------------------------------------

def test_foreground_model_and_components_match_jax():
    frames, _ = _scene()
    small_t, small_j = TD._resize(frames, TD.WORK), JD._resize(frames, JD.WORK)
    np.testing.assert_allclose(small_t, small_j, atol=1e-6)
    bg = TD.median_background(small_t)
    np.testing.assert_array_equal(bg, JD.median_background(small_t))
    fg = TD.foreground_masks(small_t, bg)
    np.testing.assert_array_equal(fg, JD.foreground_masks(small_t, bg))
    np.testing.assert_array_equal(TD.foreground_masks(small_t, bg, 0.3), JD.foreground_masks(small_t, bg, 0.3))
    np.testing.assert_array_equal(TD._clean(fg[0], it=2), JD._clean(fg[0], it=2))
    for g, w in zip(TD.PersonDetector().run(frames), JD.PersonDetector().run(frames)):
        np.testing.assert_array_equal(g, w)
    prob = np.zeros((128, 128), np.float32)
    prob[10:50, 40:60] = 0.95
    prob[55:100, 42:58] = 0.9
    prob[60:80, 100:120] = 0.9
    prob[100:110, 5:125] = 0.7
    for aspect_scale in (1.0, 1.4):
        got = TD.person_components(prob, min_area=32, aspect_scale=aspect_scale)
        want = JD.person_components(prob, min_area=32, aspect_scale=aspect_scale)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(TD._merge_aligned_components(*got), JD._merge_aligned_components(*want))
    assert TD.person_components(np.zeros((8, 8), np.float32))[0].shape == (0, 4)


def test_color_model_and_compactness_match_jax():
    img = color_still()[0]
    small = TD._resize(img[None], 96)[0]
    np.testing.assert_array_equal(TD.color_model_person_mask(small), JD.color_model_person_mask(small))
    for g, w in zip(TD.still_person_boxes(img[None]), JD.still_person_boxes(img[None])):
        np.testing.assert_array_equal(g, w)
    rng = np.random.RandomState(0)
    solid = np.zeros((64, 64), bool)
    solid[10:50, 20:40] = True
    for m in (solid, np.ones((64, 64), bool), rng.rand(64, 64) > 0.65, np.zeros((64, 64), bool)):
        assert TD.mask_is_compact(m) == JD.mask_is_compact(m)
    assert TD.mask_is_compact(solid)


def test_pose_person_boxes_match_jax(nets):
    frames = np.zeros((2, 128, 96, 3), np.float32)
    for j, t in ((Untrained(), Untrained()), (SkeletonPose(), SkeletonPose())):
        got = TD.pose_person_boxes(frames, pose2d=t, device="cpu")
        want = JD.pose_person_boxes(frames, pose2d=j)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)
    assert len(got[0]) == 1


def test_track_person_boxes_and_zoom_refine_match_jax(nets):
    frames, _ = _scene()
    np.testing.assert_array_equal(TD.track_person_boxes(frames), JD.track_person_boxes(frames))
    assert TD.track_person_boxes(frames[:1]) is None and JD.track_person_boxes(frames[:1]) is None
    people = person_frames(3)
    jdet = JD.SegmentationDetector(mattor=nets["jax"]["mattor"], work=WORK)
    tdet = TD.SegmentationDetector(mattor=nets["port"]["mattor"], work=WORK, device="cpu")
    np.testing.assert_allclose(tdet.run_probs(people), jdet.run_probs(people), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tdet.run_masks(people), jdet.run_masks(people))
    for g, w in zip(tdet.run(people), jdet.run(people)):
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)
    coarse = np.asarray([[40, 20, 110, 130], [60, 10, 150, 140], [5, 5, 60, 60]], np.float32)
    got, want = tdet.zoom_refine(people, coarse), jdet.zoom_refine(people, coarse)
    np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])


SCENES = {"moving": lambda: _scene()[0], "still": color_still, "person": lambda: person_frames(1),
          "person_clip50": lambda: person_frames(50, 96, 128)}
CASES = [(scene, w) for scene in sorted(SCENES) for w in ("trained", "none")] + [
    ("still", "skeleton"), ("person", "skeleton")]


@pytest.mark.parametrize("scene,weights", CASES)
def test_detect_person_boxes_matches_jax(nets, scene, weights):
    """Each scene with the trained segmenter and pose net, with neither, and
    the stills with no segmenter but the JAX tests' skeleton runner: the same
    boxes and the same winning source."""
    frames = SCENES[scene]()
    if weights == "trained":
        jseg, tseg = nets["jax"]["mattor"], nets["port"]["mattor"]
        jpose, tpose = nets["jax"]["pose"], nets["port"]["pose"]
    else:
        jseg, tseg = nets["jax"]["blank"], nets["port"]["blank"]
        jpose, tpose = (Untrained(), Untrained()) if weights == "none" else (SkeletonPose(), SkeletonPose())
    want, wmethod = JD.detect_person_boxes(frames, seg_detector=JD.SegmentationDetector(mattor=jseg, work=WORK),
                                           pose2d=jpose)
    got, gmethod = TD.detect_person_boxes(
        frames, seg_detector=TD.SegmentationDetector(mattor=tseg, work=WORK, device="cpu"), pose2d=tpose,
        device="cpu")
    assert gmethod == wmethod
    if want is None:
        assert got is None
        return
    assert got.shape == (len(frames), 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    expected = {("person", "trained"): "person_seg", ("person_clip50", "trained"): "person_seg",
                ("moving", "none"): "median_bg", ("still", "skeleton"): "pose2d+color_model"}
    assert expected.get((scene, weights), gmethod) == gmethod


def test_crop_geometry_matches_jax():
    frames = person_frames(4, 90, 160)
    H, W = frames.shape[1:3]
    active_t = active_j = None
    boxes = np.asarray([[50, 10, 80, 85], [55, 12, 90, 88], [60, 5, 95, 80], [20, 0, 40, 30]], np.float32)
    for b in boxes:
        active_t, active_j = TPre.update_active_boxes(b, active_t), JPre.update_active_boxes(b, active_j)
        np.testing.assert_array_equal(active_t, active_j)
    for factor in (1.0, 1.25, 3.0):
        np.testing.assert_array_equal(TPre.fmt_active_boxes(active_t, (H, W), factor),
                                      JPre.fmt_active_boxes(active_j, (H, W), factor))
    box = TPre.fmt_active_boxes(active_t, (H, W))
    for img, b, size in ((frames[0], box, 64), (frames[1], np.asarray([100, 20, 175, 60]), 48),
                         (frames[2], np.asarray([-5, -5, 30, 95]), 128)):
        got, ggeom = TPre.process_crop_img(img, b, size, device="cpu")
        want, wgeom = JPre.process_crop_img(img, b, size)
        assert got.shape == (size, size, 3) and ggeom == wgeom
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
