"""The disk-facing service layer: PNG IO, input parsing, the preprocessing
manifest, and `imitate` / `novel_view` / `swap` end to end against their JAX
twins on one hand-built processed directory (128^2, smoke body, a narrow
generator whose weights both packages read from the same `personalized.npz`)."""
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ipercore_tpu.models.networks import build_generator as jbuild
from ipercore_tpu.services import meta_info as jmeta
from ipercore_tpu.services import options as jopts
from ipercore_tpu.services import run_imitator as jrun_imit
from ipercore_tpu.services import run_swapper as jrun_swap
from ipercore_tpu.services import run_viewer as jrun_view
from ipercore_tpu.services.process_info import ProcessInfo as JProcessInfo
from ipercore_tpu.utils import checkpoint as jckpt
from ipercore_tpu.utils import video as jvid
from ipercore_tpu_torch.ops import rasterizer_cuda as trc
from ipercore_tpu_torch.services import meta_info as tmeta
from ipercore_tpu_torch.services import options as topts
from ipercore_tpu_torch.services import run_imitator as trun_imit
from ipercore_tpu_torch.services import run_swapper as trun_swap
from ipercore_tpu_torch.services import run_viewer as trun_view
from ipercore_tpu_torch.services.process_info import ProcessInfo as TProcessInfo
from ipercore_tpu_torch.utils import video as tvid

from tests.test_torch_common import NARROW_CFG, thetas

S = 128


@pytest.mark.parametrize("shape", [(9, 7, 3), (5, 6, 4), (4, 3, 1), (6, 5)])
def test_png_round_trip_and_jax_written_pngs(tmp_path, shape):
    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    want = {1: np.repeat(want[..., :1], 3, axis=2), 3: want, 4: want[..., :3]}[want.shape[2]]
    tvid.write_png(str(tmp_path / "t.png"), img)
    jvid.write_png(str(tmp_path / "j.png"), img)
    for reader in (tvid.read_png, jvid.read_png):
        np.testing.assert_array_equal(reader(str(tmp_path / "t.png")), want)
    np.testing.assert_array_equal(tvid.read_png(str(tmp_path / "j.png")), want)


def test_png_reader_undoes_every_filter(tmp_path):
    """Rows written with each of the five PNG filters decode to the image."""
    import struct
    import zlib

    rng = np.random.RandomState(1)
    h, w, c = 10, 7, 3
    img = rng.randint(0, 256, (h, w, c)).astype(np.int64)
    raw, prev = b"", np.zeros(w * c, np.int64)
    for r in range(h):
        cur, ft = img[r].reshape(-1), r % 5
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ft == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        else:
            pred = [0 * cur, left, prev, (left + prev) // 2][ft]
        raw += bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    with open(tmp_path / "f.png", "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(tvid.read_png(str(tmp_path / "f.png")), img.astype(np.uint8))


@pytest.mark.parametrize("size", [None, 32, 80])
def test_load_image_matches_jax(tmp_path, size):
    img = np.random.RandomState(2).uniform(-1, 1, (48, 48, 3)).astype(np.float32)
    jvid.save_image(str(tmp_path / "a.png"), img)
    np.testing.assert_allclose(tvid.load_image(str(tmp_path / "a.png"), size=size),
                               jvid.load_image(str(tmp_path / "a.png"), size=size), atol=1e-5, rtol=0)


def test_meta_info_and_options_parse_as_in_jax():
    src = "path?=/d/a,name?=alice,bg_path?=/d/bg.png|/d/bob_dir/|path?=/d/c,parts?=upper-head"
    ref = "path?=/d/v.mp4,name?=dance,fps?=30,pose_fc?=200,effect?=View-45;BT-3-10|/d/w/"
    for js, ts in zip(jmeta.parse_src_input(src), tmeta.parse_src_input(src)):
        assert vars(js) == vars(ts) and js.to_str() == ts.to_str()
    for jr, tr in zip(jmeta.parse_ref_input(ref), tmeta.parse_ref_input(ref)):
        assert vars(jr) == vars(tr) and jr.to_str() == tr.to_str()
    assert tmeta.parse_ref_input(ref)[0].effect == {"View": 45.0, "BT": [(3, 10)]}
    argv = ["--image_size", "128", "--src_path", src, "--Train.lr_G", "0.5", "--temporal", "true"]
    assert dict(topts.parse_args(argv)) == dict(jopts.parse_args(argv))


def test_process_info_reads_a_directory_written_by_jax(tmp_path):
    rng = np.random.RandomState(3)
    info = JProcessInfo(str(tmp_path / "p"), name="x")
    info.meta["valid_img_names"] = [f"f{i}.png" for i in range(5)]
    info.set_array("smpls", rng.randn(5, 85).astype(np.float32))
    info.set_array("ft_ids", np.array([3, 1]))
    info.set_array("bk_ids", np.array([4]))
    info.mark_run("detector", n=5)
    info.serialize()
    j, t_ = JProcessInfo.deserialize(str(tmp_path / "p")), TProcessInfo.deserialize(str(tmp_path / "p"))
    assert t_.meta == j.meta and t_.has_run("detector") and not t_.has_run("parser")
    for ns in (1, 2, 3, 4):
        a, b = t_.read_src_info(ns), j.read_src_info(ns)
        assert a["src_ids"] == b["src_ids"] and a["img_names"] == b["img_names"]
        np.testing.assert_array_equal(a["smpls"], b["smpls"])
    np.testing.assert_array_equal(t_.read_ref_info()["smpls"], j.read_ref_info()["smpls"])


# ---------------------------------------------------------------------------
# the three services end to end
# ---------------------------------------------------------------------------

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


def _opt(mod, root):
    opt = mod.setup(None, [])
    opt.update(image_size=S, num_source=2, output_dir=str(root), model_id="m", out_dilate_ks=9,
               smoke_model=True, view_frames=8, Generator=NARROW_CFG,
               src_path="path?=a,name?=alice", ref_path="path?=b,name?=dance,fps?=10")
    return opt


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """One processed tree (two people, one reference of 12 frames, a narrow
    `personalized.npz`), copied for every run so that no run sees another's
    output."""
    root = tmp_path_factory.mktemp("processed")
    _write_processed(str(root), "alice", 3, seed=10, masks=True, background=True)
    _write_processed(str(root), "bob", 2, seed=11)
    _write_processed(str(root), "dance", 12, seed=12)
    gen = jbuild("AttLWB-SPADE", NARROW_CFG)
    z = jnp.zeros
    params = jax.jit(lambda r: gen.init(
        r, z((1, 1, 32, 32, 4)), z((1, 2, 32, 32, 6)), z((1, 1, 32, 32, 6)),
        z((1, 1, 2, 32, 32, 2)), None, False))(jax.random.PRNGKey(0))
    jckpt.save_params(os.path.join(jmeta.checkpoints_dir(str(root), "m"), "personalized.npz"), params)
    copies = iter(range(100))

    def copy():
        dst = tmp_path_factory.getbasetemp() / f"run{next(copies)}"
        shutil.copytree(root, dst)
        return dst

    return copy


def _frames(out_dir):
    names = sorted(f for f in os.listdir(out_dir) if f.startswith("pred_"))
    return np.stack([tvid.read_png(os.path.join(out_dir, f)) for f in names]).astype(np.int32)


def _run(processed, opts, fn, synthesis, **opt_fields):
    """Run one service on a fresh copy of the processed tree; returns the
    decoded frames it wrote, its return value and the copy's root."""
    root = processed()
    opt = _opt(opts, root)
    opt.update(opt_fields)
    out = fn(opt) if opts is jopts else fn(opt, device="cpu")
    return _frames(os.path.join(root, "primitives", synthesis, "synthesis")), out, root


def _close_lsb(a, b):
    assert a.shape == b.shape
    assert (np.abs(a - b) <= 1).mean() >= 0.995, (np.abs(a - b) <= 1).mean()


@pytest.fixture(scope="module")
def jax_imitated(processed):
    return _run(processed, jopts, jrun_imit.imitate, "alice-dance")[0]


def test_imitate_matches_jax(processed, jax_imitated):
    tf, out, root = _run(processed, topts, trun_imit.imitate, "alice-dance")
    assert tf.shape == (12, S, S, 3)
    _close_lsb(tf, jax_imitated)
    assert np.abs(tf[0] - tf[-1]).max() > 2  # the frames follow the pose
    syn = os.path.join(root, "primitives", "alice-dance", "synthesis")
    assert out in ([syn], [os.path.join(syn, "imitation.mp4")])
    fused = sorted(f for f in os.listdir(syn) if f.startswith("fused_"))
    assert len(fused) == 12
    assert tvid.read_png(os.path.join(syn, fused[0])).shape == (S, 4 * S, 3)  # 2 sources | ref | out


def test_imitate_on_the_table_route_matches_jax(processed, jax_imitated, monkeypatch):
    """`IPERCORE_CSR_RASTER=0`: the port's frames come through the table
    raster (its plain version here); the JAX package on the CPU has one route."""
    monkeypatch.setenv("IPERCORE_CSR_RASTER", "0")
    calls = {"table": 0, "csr": 0}
    table_plain, csr_plain = trc.raster_flows_table_plain, trc.raster_flows_plain

    def spy(key, fn):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(trc, "raster_flows_table_plain", spy("table", table_plain))
    monkeypatch.setattr(trc, "raster_flows_plain", spy("csr", csr_plain))
    tf = _run(processed, topts, trun_imit.imitate, "alice-dance")[0]
    assert calls == {"table": 1, "csr": 0}  # one chunk of 16 frames
    _close_lsb(tf, jax_imitated)


def test_novel_view_matches_jax(processed):
    jf = _run(processed, jopts, jrun_view.novel_view, "alice-novel_view")[0]
    tf = _run(processed, topts, trun_view.novel_view, "alice-novel_view")[0]
    assert tf.shape == (8, S, S, 3)
    _close_lsb(tf, jf)
    assert np.abs(tf[0] - tf[4]).max() > 2  # half a turn apart


def test_swap_matches_jax(processed):
    src = "path?=a,name?=alice|path?=b,name?=bob,parts?=upper"
    jf = _run(processed, jopts, jrun_swap.swap, "alice+bob-dance-swap", src_path=src)[0]
    tf = _run(processed, topts, trun_swap.swap, "alice+bob-dance-swap", src_path=src)[0]
    assert tf.shape == (12, S, S, 3)
    _close_lsb(tf, jf)
