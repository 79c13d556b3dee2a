"""The port's self-imitation protocol (`ipercore_tpu_torch/scripts/evaluate/
self_imitation.py`) against `scripts/evaluate/self_imitation.py` itself on a
fabricated clip: 5 noise frames at 64² as the reference clip (a frame folder
in place of `akun_1.mp4`: the JAX driver's fixed path and the port's
`$IPERCORE_REFERENCE_SAMPLES` clip both pointed at it), and the two source
frames 0 and 90 in a temporary `FRAME_DIR`. Both run the three-stage
`run_imitator` in the pipeline test's small configuration
(`tests/test_torch_preprocess_pipeline.py`: `preproc_smoke`, the smoke body,
one narrow generator file for both, personalization of 0 iterations, the
offset fit cut to 2 steps), then score the synthesized frames against the
reference's processed crops at 64² with the proxy VGG on
`vgg_perceptual.npz` from git history.

Tolerances: the same keys and protocol fields; SSIM within 2e-3, PSNR within
0.1 dB, the LPIPS proxy within 2 % and the FID proxy within 5 % of JAX's
(the frames themselves meet JAX's at >= 99.5 % of 8-bit values within one
level, the pipeline test's bar). Without the clip the port prints one line
and exits 1.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ipercore_tpu_torch.scripts import eval_real_photos as treal
from ipercore_tpu_torch.scripts.evaluate import self_imitation as tself

from tests.test_torch_common import NARROW_CFG, history_weights
from tests.torch_script_harness import jax_scripts_module, load_jax_script, point_weights

S = 64


def _noise(path, names, seed):
    from ipercore_tpu_torch.utils import video as vid

    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    for nm in names:
        vid.save_image(os.path.join(path, nm), rng.uniform(-1, 1, (S, S, 3)).astype(np.float32))


def _smoke(parse, g_path):
    """`options.parse_args` followed by the pipeline test's small configuration."""
    def parse_args(argv=None):
        cfg = parse(argv)
        cfg.update(time_step=1, out_dilate_ks=5, Generator=NARROW_CFG, preproc_smoke=True, smoke_model=True,
                   load_path_G=g_path)
        cfg.Discriminator.update(ndf=8, n_layers=2)
        cfg.Train.update(niters_or_epochs_no_decay=0, niters_or_epochs_decay=0, face_loss_path="random")
        return cfg

    return parse_args


@pytest.fixture(scope="module")
def scores(tmp_path_factory):
    from ipercore_tpu.models.networks import build_generator as jbuild
    from ipercore_tpu.services import options as jopts
    from ipercore_tpu.tools import deformers as jdef
    from ipercore_tpu.utils import checkpoint as jckpt
    from ipercore_tpu_torch.services import options as topts
    from ipercore_tpu_torch.tools import deformers as tdef

    root = tmp_path_factory.mktemp("self_imitation")
    frame_dir, clip = str(root / "real_frames"), str(root / "akun_1")
    _noise(frame_dir, ["akun_0000.png", "akun_0090.png"], 0)
    _noise(clip, [f"{i:04d}.png" for i in range(5)], 1)
    gen = jbuild("AttLWB-SPADE", NARROW_CFG)
    z = jnp.zeros
    params = jax.jit(lambda r: gen.init(r, z((1, 1, 32, 32, 4)), z((1, 2, 32, 32, 6)), z((1, 1, 32, 32, 6)),
                                        z((1, 1, 2, 32, 32, 2)), None, False))(jax.random.PRNGKey(3))
    g_path = str(root / "G.npz")
    jckpt.save_params(g_path, params)
    jmod = load_jax_script("evaluate/self_imitation")
    out = {}
    with pytest.MonkeyPatch.context() as m:
        point_weights(m, {"vgg_perceptual": history_weights("vgg_perceptual", tmp_path_factory)})
        m.setattr(jax_scripts_module("eval_real_photos"), "FRAME_DIR", frame_dir)
        m.setattr(treal, "FRAME_DIR", frame_dir)
        m.setattr(jmod, "AKUN_MP4", clip)
        m.setattr(treal, "CLIP", clip)
        for mod in (jopts, topts):
            m.setattr(mod, "parse_args", _smoke(mod.parse_args, g_path))
        for mod in (jdef, tdef):
            fit = mod.run_sil2smpl_offsets
            m.setattr(mod, "run_sil2smpl_offsets", lambda opt, info, _fit=fit, **kw: _fit(opt, info, n_steps=2, **kw))
        for pkg in ("jax", "torch"):
            argv = ["--image_size", str(S), "--eval_size", str(S), "--out_dir", str(root / pkg)]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = jmod.main(argv) if pkg == "jax" else tself.main(argv + ["--device", "cpu"])
            assert rc == 0, buf.getvalue()[-2000:]
            out[pkg] = json.loads(buf.getvalue().strip().splitlines()[-1])
            with open(root / pkg / "self_imitation_trained.json") as f:
                assert json.load(f) == out[pkg]
    return out


def test_self_imitation_scores_match_jax(scores):
    j, t = scores["jax"], scores["torch"]
    assert set(t) == set(j) and {"ssim", "psnr", "lpips_proxy", "fid_proxy"} <= set(j)
    for k in ("protocol", "clip", "n_frames", "image_size", "eval_size", "num_source", "face_arm",
              "personalize_iters"):
        assert t[k] == j[k], k
    assert t["n_frames"] == 5
    assert abs(t["ssim"] - j["ssim"]) <= 2e-3
    assert abs(t["psnr"] - j["psnr"]) <= 0.1
    np.testing.assert_allclose(t["lpips_proxy"], j["lpips_proxy"], rtol=0.02)
    np.testing.assert_allclose(t["fid_proxy"], j["fid_proxy"], rtol=0.05)


def test_self_imitation_without_the_clip_says_so(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(treal, "CLIP", "")
    assert tself.main(["--out_dir", str(tmp_path), "--device", "cpu"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and "no sample clip" in json.loads(lines[0])["error"]
    assert not os.listdir(tmp_path)
