"""Frame sharding and streaming synthesis (`parallel/inference.py`,
`parallel/streaming.py`, `parallel/mesh.py`) against the JAX package on the
CPU, on `tests/test_parallel/test_parallel.py`'s rig: 64², a narrow
AttLWB-SPADE with the port's seeded weights carried into JAX by the
converter, the small synthetic body, and the port's source cache handed to
both packages (`setup_source` itself is held in `test_torch_imitator.py`)."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipercore_tpu.models import flow_composition as jfc
from ipercore_tpu.models import imitator as jimit
from ipercore_tpu.models.mesh import load_assets as jload_assets
from ipercore_tpu.models.networks import build_generator as jbuild
from ipercore_tpu.parallel.inference import sharded_synthesize as jsharded
from ipercore_tpu.parallel.mesh import make_mesh
from ipercore_tpu.parallel.streaming import StreamingSynthesizer as JStreaming
from ipercore_tpu_torch.models import flow_composition as tfc
from ipercore_tpu_torch.models import imitator as timit
from ipercore_tpu_torch.models.mesh import load_assets as tload_assets
from ipercore_tpu_torch.models.networks import build_generator as tbuild
from ipercore_tpu_torch.ops.dispatch import kernel_stream
from ipercore_tpu_torch.parallel import mesh as tmesh
from ipercore_tpu_torch.parallel.inference import sharded_synthesize
from ipercore_tpu_torch.parallel.streaming import StreamingSynthesizer
from ipercore_tpu_torch.utils import checkpoint as tckpt
from ipercore_tpu_torch.utils import video as tvid

from tests.test_torch_common import n, small_models, t, unflatten_to_jax

S, NS = 64, 2
CFG = {
    "BGNet": {"num_filters": [8, 16, 16, 32], "n_res_block": 1},
    "SIDNet": {"num_filters": [8, 16, 32], "n_res_block": 1},
    "TSFNet": {"num_filters": [8, 16, 32], "n_res_block": 1},
}


def _theta(count, seed):
    rng = np.random.RandomState(seed)
    th = np.zeros((count, 85), np.float32)
    th[:, 0] = 1.2
    th[:, 3:75] = rng.randn(count, 72) * 0.05
    return th


@pytest.fixture(scope="module")
def rig():
    jm, tm = small_models()
    ja = jload_assets(jm, uv_map_path="/nonexistent", part_path="/nonexistent")
    ta = tload_assets(tm, device="cpu", synthetic=True)
    jcomp = jfc.make_composer(jm, ja, image_size=S, out_dilate_ks=5)
    tcomp = tfc.make_composer(tm, ta, image_size=S, out_dilate_ks=5)
    tgen = tbuild("AttLWB-SPADE", CFG, device="cpu")
    flat = tckpt.seeded_flat_params(tgen, 0)
    tckpt.load_generator_params(tgen, flat)
    src_img = np.random.RandomState(0).uniform(-1, 1, (1, NS, S, S, 3)).astype(np.float32)
    src_smpl = np.zeros((1, NS, 85), np.float32)
    src_smpl[..., 0] = 1.2
    tcache = timit.setup_source(tcomp, tgen, t(src_img), t(src_smpl))
    conv = lambda x: tuple(conv(v) for v in x) if isinstance(x, tuple) else jnp.asarray(n(x))
    jcache = jimit.SourceCache(*[conv(f) for f in tcache])
    return dict(jcomp=jcomp, tcomp=tcomp, jgen=jbuild("AttLWB-SPADE", CFG), tgen=tgen,
                params=unflatten_to_jax(flat), jcache=jcache, tcache=tcache)


@pytest.fixture(scope="module")
def sharded(rig):
    tgt = _theta(5, seed=1)  # deliberately not a multiple of the devices
    ref = jsharded(rig["jcomp"], rig["jgen"], rig["params"], rig["jcache"], jnp.asarray(tgt),
                   make_mesh("frames", 2))
    out = sharded_synthesize(rig["tcomp"], rig["tgen"], rig["tcache"], tgt, devices=["cpu", "cpu"])
    return tgt, ref, out


def _close(a, b):
    """Every value within 1e-4 of JAX's: the two packages' f32 convolutions
    sum in different orders (up to 8.9e-5 apart on this rig), so not 1e-5."""
    d = np.abs(n(a) - np.asarray(b))
    assert d.max() <= 1e-4, (d.max(), d.mean())


def test_sharded_synthesize_matches_jax(sharded):
    _, (jp, jm), (tp, tm) = sharded
    assert tp.shape == (5, S, S, 3) and tm.shape == (5, S, S, 1)
    _close(tp, jp)
    _close(tm, jm)
    assert n(tp).std() > 1e-3


def test_each_shard_equals_synthesize_frames_of_that_shard(rig, sharded):
    """Device k takes frames [3k, 3k+3) of the 6 padded with the last frame;
    each slice equals `synthesize_frames` of the same 3 frames bit for bit."""
    tgt, _, (tp, tm) = sharded
    padded = np.concatenate([tgt, tgt[-1:]])
    for k in range(2):
        p, m = timit.synthesize_frames(rig["tcomp"], rig["tgen"], rig["tcache"], t(padded[3 * k:3 * k + 3]))
        keep = min(3, 5 - 3 * k)
        np.testing.assert_array_equal(n(tp[3 * k:3 * k + keep]), n(p[:keep]))
        np.testing.assert_array_equal(n(tm[3 * k:3 * k + keep]), n(m[:keep]))


def test_streaming_matches_jax(rig, tmp_path):
    tgt = _theta(6, seed=2)
    jsynth = JStreaming(rig["jcomp"], rig["jgen"], rig["params"], rig["jcache"], chunk=4)
    tsynth = StreamingSynthesizer(rig["tcomp"], rig["tgen"], rig["tcache"], chunk=4)
    jpaths = jsynth.run(tgt, str(tmp_path / "jax"))
    tpaths = tsynth.run(tgt, str(tmp_path / "port"))
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    assert [os.path.basename(p) for p in tpaths] == [f"pred_{i:08d}.png" for i in range(6)]
    for a, b in zip(tpaths, jpaths):
        diff = np.abs(tvid.read_png(a).astype(int) - tvid.read_png(b).astype(int))
        assert diff.max() <= 1, (a, diff.max())
    jframes, tframes = jsynth.run(tgt, None), tsynth.run(tgt, None)
    assert len(tframes) == 6 and tframes[0].shape == (S, S, 3) and tframes[0].dtype == np.float32
    _close(np.stack(tframes), np.stack(jframes))
    # the tail chunk of 2 frames ran padded to 4, as `imitate_sequence` runs it
    from ipercore_tpu_torch.services.run_imitator import imitate_sequence

    whole = imitate_sequence(rig["tcomp"], rig["tgen"], rig["tcache"], tgt, chunk=4, device="cpu")
    np.testing.assert_array_equal(np.stack(tframes), whole)
    for p, f in zip(tpaths, whole):
        ref = str(tmp_path / "ref.png")
        tvid.save_image(ref, f)
        assert open(p, "rb").read() == open(ref, "rb").read()


def test_replicate_moves_what_is_elsewhere_and_keeps_the_rest(rig):
    comp = rig["tcomp"]
    assert tmesh.replicate(comp, "cpu") is comp
    assert tmesh.replicate(rig["tgen"], torch.device("cpu")) is rig["tgen"]
    assert tmesh.replicate(rig["tcache"], "cpu") is rig["tcache"]
    moved = tmesh.replicate(comp, "meta")
    assert type(moved) is type(comp) and type(moved.model) is type(comp.model)
    assert moved.uv_fim.device.type == "meta" and moved.model.v_template.device.type == "meta"
    assert moved.model.chain.levels[0][0].device.type == "meta"
    assert moved.model.parents is comp.model.parents and moved.image_size == comp.image_size
    assert comp.uv_fim.device.type == "cpu"
    gen = tmesh.replicate(rig["tgen"], "meta")
    assert gen is not rig["tgen"] and next(gen.parameters()).device.type == "meta"
    assert next(rig["tgen"].parameters()).device.type == "cpu"
    cache = tmesh.replicate(rig["tcache"], "meta")
    assert isinstance(cache.src_enc_outs, tuple) and cache.src_enc_outs[0].device.type == "meta"
    pair = (torch.zeros(2), 3)
    assert tmesh.replicate(pair, "cpu") is pair
    assert tmesh.replicate(pair, "meta")[0].device.type == "meta"


def test_local_devices(monkeypatch):
    assert tmesh.local_devices(device="cpu") == [torch.device("cpu")]
    assert tmesh.local_devices(2, device="cpu") == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.local_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded_synthesize(None, None, None, np.zeros((1, 85), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tmesh.local_devices() == [torch.device("cuda", i) for i in range(3)]
    assert tmesh.local_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="5 devices asked for, 3 visible"):
        tmesh.local_devices(5)


def test_kernel_stream_refuses_inputs_on_two_devices():
    with pytest.raises(ValueError, match="lie on cpu and meta"):
        with kernel_stream(torch.zeros(1), torch.zeros(1, device="meta")):
            pass
