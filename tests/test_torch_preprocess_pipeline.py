"""The preprocessing pipeline and the three-stage runners of the port against
the JAX package, on a tiny raw clip in the JAX package's `preproc_smoke`
configuration (`tests/test_services/test_end_to_end.py`): noise frames as a
source of 4 and a reference of 5 PNG files, 64^2, the smoke body, a narrow
generator that both packages read from the same `load_path_G` file, and
personalization of 0 iterations (the JAX package draws its discriminator from
a PRNGKey, so trained weights could not agree).

Checked: `Preprocessor.execute`'s arrays (`smpls` within 1e-4, `masks` >= 99.5
% equal, `ft_ids` / `bk_ids` equal, `background.png` within 1e-3 before its
8-bit rounding, so within 1 LSB after), also with a trained mattor and
inpaintor handed to both packages; `digital_deform`'s offsets (2 Adam steps,
within 1e-5) and `post_update_opt`'s edits; the three-stage `run_imitator`'s
frames within `test_torch_services.py`'s bar (>= 99.5 % of 8-bit values
within 1); the SMPL overlay of stage 1.7 within 1e-5.
"""
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.test_torch_common import NARROW_CFG, history_weights, unflatten_to_jax
from tests.test_torch_mattors import _red_threshold_segmenter
from ipercore_tpu.models.networks import build_generator as jbuild
from ipercore_tpu.services import options as jopts
from ipercore_tpu.services import preprocess as jpre
from ipercore_tpu.services import run_imitator as jrun
from ipercore_tpu.services.meta_info import MetaProcess
from ipercore_tpu.services.process_info import ProcessInfo as JProcessInfo
from ipercore_tpu.tools import deformers as jdef
from ipercore_tpu.tools import inpaintors as jin
from ipercore_tpu.tools import mattors as jmt
from ipercore_tpu.tools import preprocessor as jproc
from ipercore_tpu.utils import checkpoint as jckpt
from ipercore_tpu.utils import video as jvid
from ipercore_tpu.utils import visualizer as jvis
from ipercore_tpu_torch.services import options as topts
from ipercore_tpu_torch.services import preprocess as tpre
from ipercore_tpu_torch.services import run_imitator as trun
from ipercore_tpu_torch.services.process_info import ProcessInfo as TProcessInfo
from ipercore_tpu_torch.tools import deformers as tdef
from ipercore_tpu_torch.tools import inpaintors as tin
from ipercore_tpu_torch.tools import mattors as tmt
from ipercore_tpu_torch.tools import preprocessor as tproc
from ipercore_tpu_torch.utils import visualizer as tvis

S = 64


def _opt(mod, root):
    cfg = mod.setup(None, [])
    cfg.update(image_size=S, num_source=2, time_step=1, output_dir=str(root), model_id="e2e", out_dilate_ks=5,
               Generator=NARROW_CFG, preproc_smoke=True, smoke_model=True,
               load_path_G=os.path.join(str(root), "G.npz"),
               src_path=f"path?={root}/raw_person_a,name?=person_a",
               ref_path=f"path?={root}/raw_dance_b,name?=dance_b,fps?=10")
    cfg.Discriminator.update(ndf=8, n_layers=2)
    cfg.Train.update(niters_or_epochs_no_decay=0, niters_or_epochs_decay=0, face_loss_path="random")
    return cfg


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """The raw clip (noise frames, as the JAX end-to-end test) and the
    narrow generator's parameters, copied for every run."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(0)
    for name, n in (("person_a", 4), ("dance_b", 5)):
        d = root / f"raw_{name}"
        d.mkdir()
        for i in range(n):
            jvid.save_image(str(d / f"{i:04d}.png"), rng.uniform(-1, 1, (S, S, 3)).astype(np.float32))
    gen = jbuild("AttLWB-SPADE", NARROW_CFG)
    z = jnp.zeros
    params = jax.jit(lambda r: gen.init(
        r, z((1, 1, 32, 32, 4)), z((1, 2, 32, 32, 6)), z((1, 1, 32, 32, 6)),
        z((1, 1, 2, 32, 32, 2)), None, False))(jax.random.PRNGKey(3))
    jckpt.save_params(str(root / "G.npz"), params)
    copies = iter(range(100))

    def copy():
        dst = tmp_path_factory.getbasetemp() / f"pipe{next(copies)}"
        shutil.copytree(root, dst)
        return dst

    return copy


def _two_steps(module, monkeypatch):
    """`digital_deform`'s offset fit cut to 2 Adam steps in `module`."""
    fit = module.run_sil2smpl_offsets
    monkeypatch.setattr(module, "run_sil2smpl_offsets", lambda opt, info, **kw: fit(opt, info, n_steps=2, **kw))


@pytest.fixture(scope="module")
def runs(raw):
    """The three-stage `run_imitator` of each package on its own copy."""
    mp = pytest.MonkeyPatch()
    try:
        _two_steps(jdef, mp)
        _two_steps(tdef, mp)
        out = {}
        for name, opts, fn in (("jax", jopts, jrun.run_imitator),
                               ("torch", topts, lambda o: trun.run_imitator(o, device="cpu"))):
            root = raw()
            opt = _opt(opts, root)
            out[name] = {"root": root, "opt": opt, "outputs": fn(opt)}
        return out
    finally:
        mp.undo()


def _info(root, name):
    return TProcessInfo.deserialize(MetaProcess(name, str(root)).processed_dir)


@pytest.mark.parametrize("name", ["person_a", "dance_b"])
def test_execute_arrays_match_jax(runs, name):
    j, t = _info(runs["jax"]["root"], name), _info(runs["torch"]["root"], name)
    assert t.check_has_been_processed() and j.check_has_been_processed()
    assert t.meta["valid_img_names"] == j.meta["valid_img_names"]
    assert t.meta["stages"]["detector"] == j.meta["stages"]["detector"]
    np.testing.assert_allclose(t.get_array("crop_geom"), j.get_array("crop_geom"), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.get_array("smpls"), j.get_array("smpls"), rtol=0, atol=1e-4)
    tm_, jm_ = t.get_array("masks"), j.get_array("masks")
    assert tm_.shape == jm_.shape == (len(t.meta["valid_img_names"]), S, S, 1)
    assert (np.abs(tm_ - jm_) < 1e-6).mean() >= 0.995
    assert 0 < tm_.mean() < 1  # the silhouette is in the matte
    np.testing.assert_array_equal(t.get_array("ft_ids"), j.get_array("ft_ids"))
    np.testing.assert_array_equal(t.get_array("bk_ids"), j.get_array("bk_ids"))
    for img in t.meta["valid_img_names"]:
        a = jvid.read_png(os.path.join(t.processed_dir, "images", img)).astype(int)
        b = jvid.read_png(os.path.join(j.processed_dir, "images", img)).astype(int)
        assert np.abs(a - b).max() <= 1


def test_background_matches_jax(runs):
    paths = [os.path.join(_info(runs[k]["root"], "person_a").processed_dir, "background.png") for k in ("jax", "torch")]
    assert all(os.path.exists(p) for p in paths)
    a, b = (jvid.read_png(p).astype(int) for p in paths)
    assert np.abs(a - b).max() <= 1
    assert not os.path.exists(os.path.join(_info(runs["torch"]["root"], "dance_b").processed_dir, "background.png"))


def test_digital_deform_and_post_update_opt_match_jax(runs):
    j, t = _info(runs["jax"]["root"], "person_a"), _info(runs["torch"]["root"], "person_a")
    assert t.has_run("deform") and t.get_array("links_ids") is None
    np.testing.assert_allclose(t.get_array("offsets"), j.get_array("offsets"), rtol=0, atol=1e-5)
    assert np.abs(t.get_array("offsets")).max() > 0
    jo, to = runs["jax"]["opt"], runs["torch"]["opt"]
    root_j, root_t = str(runs["jax"]["root"]), str(runs["torch"]["root"])
    assert to.src_path == jo.src_path.replace(root_j, root_t) and to.num_source == jo.num_source == 2
    assert to.ref_path == jo.ref_path.replace(root_j, root_t)
    txt = [open(os.path.join(r, "models", "e2e", "personalization.txt")).read() for r in (root_j, root_t)]
    assert txt[1] == txt[0].replace(root_j, root_t) and "person_a" in txt[1]


def test_post_update_opt_drops_an_invalid_source_as_jax(runs):
    for key, opts, fn in (("jax", jopts, jpre.post_update_opt), ("torch", topts, tpre.post_update_opt)):
        opt = _opt(opts, runs[key]["root"])
        opt.src_path += "|path?=/nonexistent_dir,name?=ghost"
        opt.num_source = 10
        fn(opt)
        runs[key]["ghost"] = (opt.src_path.replace(str(runs[key]["root"]), "<root>"), opt.num_source)
    assert runs["torch"]["ghost"] == runs["jax"]["ghost"]
    assert "ghost" not in runs["torch"]["ghost"][0] and runs["torch"]["ghost"][1] == 4


def test_three_stage_run_imitator_frames_match_jax(runs):
    frames = {}
    for key in ("jax", "torch"):
        out = runs[key]["outputs"]
        d = out[0] if os.path.isdir(out[0]) else os.path.dirname(out[0])
        names = sorted(f for f in os.listdir(d) if f.startswith("pred_"))
        frames[key] = np.stack([jvid.read_png(os.path.join(d, f)) for f in names]).astype(np.int32)
    assert frames["torch"].shape == frames["jax"].shape == (5, S, S, 3)
    assert (np.abs(frames["torch"] - frames["jax"]) <= 1).mean() >= 0.995
    pers = [os.path.join(str(runs[k]["root"]), "models", "e2e", "personalized.npz") for k in ("jax", "torch")]
    assert all(os.path.exists(p) for p in pers)


def test_execute_with_trained_mattor_and_inpaintor_matches_jax(raw, tmp_path_factory):
    """Stages 1.4 and 1.6 on their trained branches: the red-threshold
    segmenter with a seeded GCA refiner (the same file for both packages)
    and the published `inpaintor.npz`, handed to both Preprocessors."""
    from tests.test_torch_mattors import _perturbed

    wdir = tmp_path_factory.mktemp("w")
    gca = str(wdir / "matting_gca.npz")
    np.savez(gca, **{f"seg/{k}": v for k, v in _red_threshold_segmenter().items()},
             **{f"mat/{k}": v for k, v in _perturbed(tmt.GCAMattingRefiner(), 8).items()})
    missing = str(wdir / "none.npz")
    inpaint = {k: np.asarray(v, np.float32)
               for k, v in np.load(history_weights("inpaintor", tmp_path_factory)).items()}
    results = {}
    for key, proc, mt, inp in (("jax", jproc, jmt, jin), ("torch", tproc, tmt, tin)):
        root = raw()
        dev = {} if key == "jax" else {"device": "cpu"}
        pre = proc.Preprocessor(image_size=S, smoke=True, **dev)
        pre._mattor = mt.HumanMattor(weights_path=missing, gca_weights_path=gca, **dev)
        params = inpaint if key == "torch" else unflatten_to_jax(inpaint)
        pre._inpaintor = inp.SuperResolutionInpaintor(inpaint_params=params, control_size=S,
                                                       weights_path=missing, refine_weights_path=missing, **dev)
        # a red person drawn into the noise, so the segmenter sees one
        frames = []
        for i in range(4):
            img = np.random.RandomState(i).uniform(-1, 0.4, (S, S, 3)).astype(np.float32)
            img[10:56, 24 + i:40 + i, 0] = 0.9
            p = os.path.join(str(root), f"f{i}.png")
            jvid.save_image(p, img)
            frames.append(p)
        info = (JProcessInfo if key == "jax" else TProcessInfo)(os.path.join(str(root), "proc"), name="a")
        pre.execute(info, frames, os.path.join(str(root), "proc", "images"), is_src=True)
        results[key] = (info, jvid.read_png(os.path.join(str(root), "proc", "background.png")).astype(int))
    (ji, jb), (ti, tb) = results["jax"], results["torch"]
    assert (np.abs(ti.get_array("masks") - ji.get_array("masks")) < 1e-5).mean() >= 0.995
    assert np.abs(ti.get_array("masks") - ji.get_array("masks")).max() <= 1e-4
    assert ti.get_array("masks").min() < 0.5 < ti.get_array("masks").max()
    np.testing.assert_array_equal(ti.get_array("ft_ids"), ji.get_array("ft_ids"))
    assert np.abs(tb - jb).max() <= 1


def test_smpl_overlay_frames_match_jax(tmp_path):
    """Stage 1.7's overlay on the small synthetic body, and the frames that
    `write_visual_video` writes (a video or, without an encoder, the folder)."""
    from ipercore_tpu.models import smpl as jsmpl
    from ipercore_tpu.models.mesh import load_assets as jassets
    from ipercore_tpu_torch.models import smpl as tsmpl
    from ipercore_tpu_torch.models.mesh import load_assets as tassets

    jm, tm = jsmpl.synthetic_model(nu=20, nv=18), tsmpl.synthetic_model(nu=20, nv=18, device="cpu")
    rng = np.random.RandomState(6)
    imgs = rng.uniform(-1, 1, (3, S, S, 3)).astype(np.float32)
    theta = np.zeros((3, 85), np.float32)
    theta[:, 0] = 1.1
    theta[:, 3:75] = rng.randn(3, 72).astype(np.float32) * 0.2
    got = tvis.smpl_overlay_frames(imgs, theta, tm, tassets(tm, device="cpu", synthetic=True), device="cpu")
    want = jvis.smpl_overlay_frames(imgs, theta, jm, jassets(jm, uv_map_path="/nonexistent",
                                                             part_path="/nonexistent"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got - imgs).max() > 0.1  # the body is drawn
    out = tvis.write_visual_video(imgs, theta, str(tmp_path / "visual.mp4"), model=tm,
                                  assets=tassets(tm, device="cpu", synthetic=True), device="cpu")
    assert out in (str(tmp_path / "visual.mp4"), str(tmp_path / "visual_frames"))
    assert len(os.listdir(tmp_path / "visual_frames")) == 3
