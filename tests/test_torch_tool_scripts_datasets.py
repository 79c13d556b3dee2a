"""The port's dataset tools (`ipercore_tpu_torch/scripts/prepare_dataset.py`,
`visual_processed_data.py`, `evaluate/eval_imitator.py`) against the JAX
drivers themselves.

  * `prepare_dataset --smoke` on a raw directory of two noise-frame folders
    and a stray file, at 64² (the pipeline test's `preproc_smoke`
    configuration): the same `train.txt` / `val.txt`, and each input's SMPLs
    within 1e-4 and masks >= 99.5 % equal (`tests/test_torch_preprocess_
    pipeline.py`'s bars).
  * `visual_processed_data --smoke_model` on one processed directory written
    by `tests/test_torch_services._write_processed` (6 frames with masks and a
    background), 2 batches at 64²: the same PNG names, every grid within one
    8-bit level at >= 99.5 % of its values (the composition's K3 here is its
    plain version).
  * `eval_imitator` over two directories of 5 and 4 noise PNGs at 64², with
    the proxy VGG on `vgg_perceptual.npz` from git history in both: the same
    keys and `n_frames`, SSIM and PSNR within 1e-5 relative, the proxies as
    `tests/test_torch_evaluate.py` holds them (LPIPS 1e-4, FID 1e-3 relative).
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest

from ipercore_tpu_torch.scripts import prepare_dataset as tprep
from ipercore_tpu_torch.scripts import visual_processed_data as tvis
from ipercore_tpu_torch.scripts.evaluate import eval_imitator as teval
from ipercore_tpu_torch.services.meta_info import MetaProcess
from ipercore_tpu_torch.services.process_info import ProcessInfo
from ipercore_tpu_torch.utils import video as vid

from tests.test_torch_common import history_weights
from tests.torch_script_harness import load_jax_script, point_weights

S = 64


def _noise_dir(path, n, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    for i in range(n):
        vid.save_image(os.path.join(path, f"{i:04d}.png"), rng.uniform(-1, 1, (S, S, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    raw = tmp_path_factory.mktemp("raw")
    _noise_dir(str(raw / "person_a"), 3, 0)
    _noise_dir(str(raw / "person_b"), 3, 1)
    (raw / "notes.txt").write_text("not an input")
    jmod = load_jax_script("prepare_dataset")
    out = {}
    for pkg in ("jax", "torch"):
        root = str(tmp_path_factory.mktemp(f"dataset_{pkg}"))
        argv = ["--raw_dir", str(raw), "--output_dir", root, "--image_size", str(S), "--val_frac", "0.5", "--smoke"]
        if pkg == "jax":
            jmod.main(argv)
        else:
            tprep.main(argv + ["--device", "cpu"])
        out[pkg] = root
    return out


def test_prepare_dataset_matches_jax(prepared):
    jroot, troot = prepared["jax"], prepared["torch"]
    for f in ("train.txt", "val.txt"):
        with open(os.path.join(jroot, f)) as a, open(os.path.join(troot, f)) as b:
            assert a.read() == b.read(), f
    with open(os.path.join(troot, "train.txt")) as a, open(os.path.join(troot, "val.txt")) as b:
        names = a.read().split() + b.read().split()
    assert sorted(names) == ["person_a", "person_b"]
    for name in names:
        ji = ProcessInfo.deserialize(MetaProcess(name, jroot).processed_dir)
        ti = ProcessInfo.deserialize(MetaProcess(name, troot).processed_dir)
        np.testing.assert_allclose(ti.get_array("smpls"), ji.get_array("smpls"), atol=1e-4)
        assert (ti.get_array("masks") == ji.get_array("masks")).mean() >= 0.995
    assert tprep.split(["a", "b", "c"], 0.1) == (["b", "c"], ["a"]) and tprep.split(["a"], 0.5) == (["a"], [])


def test_visual_processed_data_matches_jax(tmp_path):
    from tests.test_torch_services import _write_processed

    root = str(tmp_path / "processed")
    _write_processed(root, "clip", 6, seed=3, masks=True, background=True)
    jmod = load_jax_script("visual_processed_data")
    outs = {}
    for pkg in ("jax", "torch"):
        out = str(tmp_path / f"grids_{pkg}")
        argv = ["--dataset_dir", root, "--out_dir", out, "--image_size", str(S), "--num_batches", "2",
                "--smoke_model"]
        assert (jmod.main(argv) if pkg == "jax" else tvis.main(argv + ["--device", "cpu"])) == 0
        outs[pkg] = out
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["torch"])) == ["batch_000.png", "batch_001.png"]
    for nm in names:
        a = vid.read_png(os.path.join(outs["jax"], nm)).astype(int)
        b = vid.read_png(os.path.join(outs["torch"], nm)).astype(int)
        assert a.shape == b.shape == (S, 5 * S, 3)
        assert (np.abs(a - b) <= 1).mean() >= 0.995, (np.abs(a - b) <= 1).mean()
        assert a.std() > 0


def test_eval_imitator_matches_jax(tmp_path_factory, tmp_path):
    pred, gt = str(tmp_path / "pred"), str(tmp_path / "gt")
    _noise_dir(pred, 5, 7)
    _noise_dir(gt, 4, 8)
    vgg = history_weights("vgg_perceptual", tmp_path_factory)
    jmod = load_jax_script("evaluate/eval_imitator")
    argv = ["--pred_dir", pred, "--gt_dir", gt, "--image_size", str(S)]
    with pytest.MonkeyPatch.context() as m:
        point_weights(m, {"vgg_perceptual": vgg})
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jmod.main(argv) == 0
            assert teval.main(argv + ["--device", "cpu"]) == 0
    want, got = (json.loads(line) for line in buf.getvalue().strip().splitlines()[-2:])
    assert got.keys() == want.keys() == {"ssim", "psnr", "lpips_proxy", "fid_proxy", "n_frames"}
    assert got["n_frames"] == want["n_frames"] == 4
    for k, rtol in (("ssim", 1e-5), ("psnr", 1e-5), ("lpips_proxy", 1e-4), ("fid_proxy", 1e-3)):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert teval.main(["--pred_dir", empty, "--gt_dir", gt, "--device", "cpu"]) == 1
