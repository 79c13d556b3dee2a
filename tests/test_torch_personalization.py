"""`services/personalization` of the port: the training batches against the
JAX package's, and `personalize` end to end on a hand-built processed
directory (64^2, smoke body, a narrow generator, ndf 8, two iterations): it
writes `personalized.npz` in the JAX package's layout (which JAX's
`load_params(like=...)` reads), skips when that file exists, honours
`load_path_G`, passes over a checkpoint that does not fit, converts a
reference `.pth`, and the port's `imitate` then renders with the personalized
weights."""
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ipercore_tpu.models.networks import build_generator as jbuild
from ipercore_tpu.services import meta_info as jmeta
from ipercore_tpu.services import options as jopts
from ipercore_tpu.services import personalization as jpers
from ipercore_tpu.services.process_info import ProcessInfo as JProcessInfo
from ipercore_tpu.utils import checkpoint as jckpt
from ipercore_tpu.utils import video as jvid
from ipercore_tpu_torch.models.networks import build_generator as tbuild
from ipercore_tpu_torch.services import meta_info as tmeta
from ipercore_tpu_torch.services import options as topts
from ipercore_tpu_torch.services import personalization as tpers
from ipercore_tpu_torch.services import run_imitator as trun_imit
from ipercore_tpu_torch.trainers import lwg_trainer as TT
from ipercore_tpu_torch.utils import checkpoint as tckpt
from ipercore_tpu_torch.utils import video as tvid

from tests.test_torch_common import (
    NARROW_CFG,
    flatten_flax,
    reference_generator_state_dict,
    thetas,
    unflatten_to_jax,
)

S = 64


def _write_processed(root, name, n_frames, seed, masks=False, background=False):
    rng = np.random.RandomState(seed)
    info = JProcessInfo(jmeta.MetaProcess(name, root).make_dirs().processed_dir, name=name)
    os.makedirs(os.path.join(info.processed_dir, "images"), exist_ok=True)
    names = [f"frame_{i:08d}.png" for i in range(n_frames)]
    for nm in names:
        jvid.save_image(os.path.join(info.processed_dir, "images", nm),
                        rng.uniform(-1, 1, (S, S, 3)).astype(np.float32))
    info.meta["valid_img_names"] = names
    smpls = thetas(n_frames, seed=seed, pose_scale=0.15)
    smpls[:, 1:3] = rng.randn(n_frames, 2).astype(np.float32) * 0.03
    info.set_array("smpls", smpls)
    if masks:
        yy, xx = np.mgrid[:S, :S]
        info.set_array("masks", np.broadcast_to(
            ((yy - S / 2) ** 2 + (xx - S / 2) ** 2 > (S / 3) ** 2).astype(np.float32), (n_frames, S, S)))
    if background:
        jvid.save_image(os.path.join(info.processed_dir, "background.png"),
                        rng.uniform(-1, 1, (S, S, 3)).astype(np.float32))
    info.serialize()


def _opt(mod, root, iters=2):
    opt = mod.setup(None, [])
    opt.update(image_size=S, num_source=2, output_dir=str(root), model_id="m", out_dilate_ks=9,
               smoke_model=True, Generator=NARROW_CFG,
               src_path="path?=a,name?=alice", ref_path="path?=b,name?=dance,fps?=10")
    opt.Discriminator.update(ndf=8, n_layers=2)
    opt.Train.update(niters_or_epochs_no_decay=iters, face_loss_path="random")
    return opt


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A processed tree (a subject of 5 frames with masks and a background, a
    reference of 4 frames), copied for every use."""
    root = tmp_path_factory.mktemp("processed")
    _write_processed(str(root), "alice", 5, seed=20, masks=True, background=True)
    _write_processed(str(root), "dance", 4, seed=21)
    copies = iter(range(100))

    def copy():
        dst = tmp_path_factory.getbasetemp() / f"pers{next(copies)}"
        shutil.copytree(root, dst)
        return dst

    return copy


def _jax_like():
    gen = jbuild("AttLWB-SPADE", NARROW_CFG)
    z = jnp.zeros
    return jax.eval_shape(lambda r: gen.init(
        r, z((1, 1, 32, 32, 4)), z((1, 2, 32, 32, 6)), z((1, 1, 32, 32, 6)),
        z((1, 1, 2, 32, 32, 2)), None, False), jax.random.PRNGKey(0))


@pytest.mark.parametrize("time_step", [1, 2])
def test_personalized_batches_match_jax(tree, time_step):
    root = tree()
    jo, to = _opt(jopts, root), _opt(topts, root)
    jo.time_step = to.time_step = time_step
    jb = list(jpers.make_personalized_batches(jo, jmeta.parse_src_input(jo.src_path)[0],
                                              np.random.RandomState(0), 4))
    tb = list(tpers.make_personalized_batches(to, tmeta.parse_src_input(to.src_path)[0],
                                              np.random.RandomState(0), 4))
    assert len(jb) == len(tb) == 4
    for a, b in zip(tb, jb):
        assert set(a) == set(b)
        assert a["images"].shape == (1, 2 + time_step, S, S, 3) and a["masks"].shape == (1, 2 + time_step, S, S, 1)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def personalized(tree):
    root = tree()
    opt = _opt(topts, root)
    path = tpers.personalize(opt, device="cpu")
    return root, opt, path


def test_personalize_writes_what_jax_reads(personalized):
    root, opt, path = personalized
    assert path == os.path.join(str(root), "models", "m", "personalized.npz") and os.path.exists(path)
    flat = tckpt.load_flat_npz(path)
    like = _jax_like()
    want = {k: tuple(v.shape) for k, v in jckpt._flatten(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), like)).items()}
    assert {k: v.shape for k, v in flat.items()} == want
    loaded = jckpt.load_params(path, like=jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), like))
    seeded = tckpt.seeded_flat_params(NARROW_CFG, 0)
    back = jckpt._flatten(jax.tree_util.tree_map(np.asarray, loaded))
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    # two steps of Adam at lr 1e-4 moved the seeded weights, each by about lr
    moved = max(float(np.abs(flat[k] - seeded[k]).max()) for k in flat)
    assert 0 < moved <= 5e-4


def test_second_personalize_is_a_skip(personalized, monkeypatch):
    root, opt, path = personalized
    stamp = os.stat(path).st_mtime_ns

    def no_training(*a, **k):
        raise AssertionError("personalize trained although personalized.npz exists")

    monkeypatch.setattr(TT, "train_step", no_training)
    assert tpers.personalize(opt, device="cpu") == path
    assert os.stat(path).st_mtime_ns == stamp


def test_imitate_renders_with_the_personalized_weights(personalized, tree):
    root, opt, _ = personalized
    trun_imit.imitate(opt, device="cpu")
    syn = os.path.join(str(root), "primitives", "alice-dance", "synthesis")
    mine = sorted(f for f in os.listdir(syn) if f.startswith("pred_"))
    seeded_root = tree()  # the same tree without personalized.npz
    trun_imit.imitate(_opt(topts, seeded_root), device="cpu")
    syn0 = os.path.join(str(seeded_root), "primitives", "alice-dance", "synthesis")
    assert len(mine) == 4
    a = np.stack([tvid.read_png(os.path.join(syn, f)) for f in mine]).astype(np.int32)
    b = np.stack([tvid.read_png(os.path.join(syn0, f)) for f in mine]).astype(np.int32)
    assert np.abs(a - b).max() > 0


def test_load_path_G_is_honoured(tree):
    root = tree()
    src = os.path.join(str(root), "pretrain.npz")
    tckpt.save_params(src, tckpt.seeded_flat_params(NARROW_CFG, 5))
    opt = _opt(topts, root, iters=0)
    opt.load_path_G = src
    flat = tckpt.load_flat_npz(tpers.personalize(opt, device="cpu"))
    want = tckpt.load_flat_npz(src)
    assert flat.keys() == want.keys() and all(np.array_equal(flat[k], want[k]) for k in want)


def test_pretrain_candidates_in_order(tree):
    """A checkpoint that does not fit the generator is passed over for the
    next candidate; without one G starts from seed 0; a reference `.pth`
    converts as JAX's converter converts it."""
    root = tree()
    other = {"BGNet": {"num_filters": [8, 16, 16, 32], "n_res_block": 1},
             "SIDNet": {"num_filters": [8, 16, 32], "n_res_block": 1},
             "TSFNet": {"num_filters": [8, 16, 32], "n_res_block": 1}}
    bad = os.path.join(str(root), "other.npz")
    tckpt.save_params(bad, tckpt.seeded_flat_params(other, 1))
    pre = os.path.join(str(root), "models", "pretrains", "AttLWB-SPADE_G.npz")
    os.makedirs(os.path.dirname(pre))
    tckpt.save_params(pre, tckpt.seeded_flat_params(NARROW_CFG, 7))
    opt = _opt(topts, root, iters=0)
    opt.load_path_G = bad
    gen = tbuild("AttLWB-SPADE", NARROW_CFG, device="cpu")
    got = tpers.load_pretrained_generator(opt, gen)
    want = tckpt.seeded_flat_params(NARROW_CFG, 7)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    os.remove(pre)
    # the repository's full-width pretrain, where it is on disk, fits no
    # narrow generator either
    assert tpers.load_pretrained_generator(opt, gen) is None
    flat = tckpt.load_flat_npz(tpers.personalize(opt, device="cpu"))
    seeded = tckpt.seeded_flat_params(NARROW_CFG, 0)
    assert all(np.array_equal(flat[k], seeded[k]) for k in seeded)
    # a reference `.pth` (a state dict in the reference's layout, saved by
    # torch) converts into the flat dict JAX's `convert_generator` gives
    import torch

    from ipercore_tpu.utils.torch_convert import convert_generator as jconvert

    pth = os.path.join(str(root), "g.pth")
    sd = reference_generator_state_dict(seeded, seed=3)
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in sd.items()}}, pth)
    opt.load_path_G = pth
    got = tpers.load_pretrained_generator(opt, gen)
    want, report = jconvert(sd, unflatten_to_jax(seeded))
    assert report == []
    want = flatten_flax(want)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    assert not np.array_equal(got["params/tsf_enc_0/kernel"], seeded["params/tsf_enc_0/kernel"])


@pytest.mark.parametrize("gen_name", ["AttLWB-Front", "AttLWB-AdaIN", "AddLWB", "AvgLWB", "SoftGateAddLWB",
                                      "SoftGateAvgLWB", "InputConcat", "TextureWarping"])
def test_personalize_runs_every_generator(tree, gen_name):
    """`opt.gen_name` selects any generator of the registry (one iteration):
    the weights it writes have the keys and shapes of
    `seeded_flat_params(G, 0)` (InputConcat's at the options' ns = 2; held
    against JAX's Flax trees by `test_torch_networks.py::
    test_other_generators_match_jax`) and moved from them by about one Adam
    step. That step is held against JAX's for each fusion by
    `test_torch_zoo_fusion_steps.py`, for AttLWB-Front and InputConcat by
    `test_torch_zoo_trainers.py`."""
    root = tree()
    opt = _opt(topts, root, iters=1)
    opt.gen_name = gen_name
    flat = tckpt.load_flat_npz(tpers.personalize(opt, device="cpu"))
    seeded = tckpt.seeded_flat_params(tbuild(gen_name, NARROW_CFG, num_source=2, device="meta"), 0)
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in seeded.items()}
    moved = max(float(np.abs(flat[k] - seeded[k]).max()) for k in flat)
    assert 0 < moved <= 3e-4
