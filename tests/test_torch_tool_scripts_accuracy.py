"""The port's accuracy-cost ladder (`ipercore_tpu_torch/scripts/evaluate/
accuracy_cost.py`) against `scripts/evaluate/accuracy_cost.py` itself at
`--smoke --frames 3` (64², the small synthetic body, the narrow generator),
both on the JAX driver's generator parameters (its `PRNGKey(0)` init, handed
to the port in place of its seeded parameters).

Tolerances on the printed rows, each a shortcut against the golden f32 /
stride-1 frames: the same configurations in the same order; for the f32
shortcuts (`tst_stride2`, `feat_warp_stride2`) SSIM within 1e-4, PSNR within
0.1 dB and mean |delta| within 1e-5 + 2 % of JAX's. The bf16 rows compare
different roundings (JAX casts the generator's parameters and activations to
bf16; the port's `compute_dtype` is autocast over f32 parameters, ROADMAP
Queue 3), so there each package's drift is only held to the same scale:
SSIM above 0.99 and mean |delta| within a factor of 2 of JAX's.
"""
import contextlib
import io
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ipercore_tpu_torch.scripts.evaluate import accuracy_cost as A

from tests.test_torch_common import flatten_flax
from tests.torch_script_harness import load_jax_script

FRAMES = 3


def _rows(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def ladders():
    from ipercore_tpu.models.networks import build_generator as jbuild

    import ipercore_tpu_torch.utils.checkpoint as tckpt

    cfg = A.SMOKE_CFG
    S, ns = 64, 2
    gen = jbuild("AttLWB-SPADE", cfg)
    z = jnp.zeros
    params = jax.jit(lambda r: gen.init(r, z((1, 1, S, S, 4)), z((1, ns, S, S, 6)), z((1, 1, S, S, 6)),
                                        z((1, 1, ns, S, S, 2)), None, False))(jax.random.PRNGKey(0))
    flat = flatten_flax(params)
    jmod = load_jax_script("evaluate/accuracy_cost")
    argv = ["--smoke", "--frames", str(FRAMES)]
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tckpt, "seeded_flat_params", lambda *a, **k: flat)
        with contextlib.redirect_stdout(buf):
            assert jmod.main(argv) == 0
        jtext = buf.getvalue()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert A.main(argv + ["--device", "cpu"]) == 0
    return _rows(jtext), _rows(buf.getvalue()), buf.getvalue()


def test_accuracy_cost_rows_match_jax(ladders):
    jrows, trows, _ = ladders
    assert [r["config"] for r in trows] == [r["config"] for r in jrows] == [c[0] for c in A.CONFIGS[1:]]
    for j, t in zip(jrows, trows):
        assert (t["size"], t["frames"]) == (j["size"], j["frames"]) == (64, FRAMES)
        if "bf16" in j["config"]:
            assert t["ssim_vs_golden"] > 0.99 and j["ssim_vs_golden"] > 0.99, (t, j)
            assert j["mean_abs_delta"] / 2 <= t["mean_abs_delta"] <= 2 * j["mean_abs_delta"] + 1e-6, (t, j)
            continue
        assert abs(t["ssim_vs_golden"] - j["ssim_vs_golden"]) <= 1e-4, (t, j)
        if np.isfinite(j["psnr_vs_golden"]) and j["mean_abs_delta"] > 0:
            assert abs(t["psnr_vs_golden"] - j["psnr_vs_golden"]) <= 0.1, (t, j)
        assert abs(t["mean_abs_delta"] - j["mean_abs_delta"]) <= 1e-5 + 0.02 * j["mean_abs_delta"], (t, j)


def test_accuracy_cost_prints_the_table(ladders):
    _, trows, text = ladders
    lines = text.strip().splitlines()
    assert "| config | SSIM vs f32/stride1 | PSNR (dB) | mean |Δ| |" in lines
    table = [line for line in lines if line.startswith("| ") and not line.startswith("| config")]
    assert [line.split(" | ")[0][2:] for line in table] == [r["config"] for r in trows]
