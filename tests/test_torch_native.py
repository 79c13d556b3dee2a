"""`ipercore_tpu_torch/utils/native.py` (the port's own copies of
`native/cclabel.cpp` and `native/pngfilters.cpp`, built with the host C++
compiler into `ipercore_tpu_torch/_build/`) against the JAX package's
`utils/native.py` and against the port's Python versions of the same work:
connected-component boxes exactly equal, PNG rows decoded to the same bytes,
and files written by `write_png` byte-equal to the JAX package's.
"""
import os
import struct
import zlib

import numpy as np
import pytest

from ipercore_tpu.tools import detection as JD
from ipercore_tpu.utils import native as JN
from ipercore_tpu.utils import video as JV
from ipercore_tpu_torch.tools import detection as TD
from ipercore_tpu_torch.utils import cuda_build
from ipercore_tpu_torch.utils import native as TN
from ipercore_tpu_torch.utils import video as TV


def _masks():
    rng = np.random.RandomState(3)
    two = np.zeros((20, 20), bool)  # the JAX package's two-box test mask
    two[2:5, 3:8] = True
    two[10:18, 12:16] = True
    solid = np.zeros((32, 32), bool)
    solid[4:10, 7:20] = True
    ring = np.zeros((40, 50), bool)  # one component around a hole, touching the borders
    ring[:, :3] = ring[:, -3:] = ring[:2] = ring[-2:] = True
    return {"random_sparse": rng.rand(96, 96) > 0.7, "random_dense": rng.rand(160, 160) > 0.45,
            "two_boxes": two, "solid": solid, "ring": ring, "empty": np.zeros((24, 17), bool)}


MASKS = _masks()


@pytest.mark.parametrize("name", sorted(MASKS))
def test_cc_boxes_equal_jax_native_and_the_bfs(name):
    mask = MASKS[name]
    for max_comps in (256, 4096):
        got = TN.cc_boxes(mask, max_comps=max_comps)
        want = JN.cc_boxes(mask, max_comps=max_comps)
        assert want is not None, "the JAX package's native library did not build"
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    # the area partition of the foreground, largest first
    full = TN.cc_boxes(mask, max_comps=4096)
    assert full[:, 4].sum() == mask.sum() and (np.diff(full[:, 4]) <= 0).all()
    for min_area in (1, 16):
        boxes = TD.connected_component_boxes(mask, min_area=min_area)
        np.testing.assert_array_equal(boxes, JD.connected_component_boxes(mask, min_area=min_area))
        plain = TD._cc_boxes_plain(mask, min_area=min_area)
        if len(full) <= 256:  # the native labeling keeps the 256 largest
            assert sorted(map(tuple, boxes.tolist())) == sorted(map(tuple, plain.tolist()))


def test_cc_boxes_of_a_degenerate_mask():
    assert TN.cc_boxes(np.zeros((0, 5), bool)) is None and JN.cc_boxes(np.zeros((0, 5), bool)) is None
    assert TD.connected_component_boxes(np.zeros((0, 5), bool)).shape == (0, 4)
    solid = MASKS["solid"]
    assert TN.cc_boxes(solid)[0].tolist() == [7, 4, 20, 10, 6 * 13]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _filtered_rows(truth: np.ndarray, types, bpp: int) -> bytes:
    """Scanlines of `truth` (H, stride) with row y filtered by types[y]."""
    truth = truth.astype(np.int32)
    h, stride = truth.shape
    lines = []
    for y in range(h):
        ft = types[y % len(types)]
        row, prev = truth[y], (truth[y - 1] if y else np.zeros(stride, np.int32))
        enc = np.zeros(stride, np.int32)
        for i in range(stride):
            left = row[i - bpp] if i >= bpp else 0
            up, ul = prev[i], (prev[i - bpp] if i >= bpp else 0)
            pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1, 4: _paeth(left, up, ul)}[ft]
            enc[i] = (row[i] - pred) % 256
        lines.append(bytes([ft]) + enc.astype(np.uint8).tobytes())
    return b"".join(lines)


@pytest.mark.parametrize("types", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_png_unfilter_undoes_every_filter_as_jax(types, bpp):
    rng = np.random.RandomState(sum(types) * 7 + bpp)
    truth = rng.randint(0, 256, (7, 5 * bpp)).astype(np.uint8)
    raw = _filtered_rows(truth, types, bpp)
    got = TN.png_unfilter(raw, 7, 5 * bpp, bpp)
    np.testing.assert_array_equal(got, truth)
    np.testing.assert_array_equal(got, JN.png_unfilter(raw, 7, 5 * bpp, bpp))
    np.testing.assert_array_equal(TV.unfilter_rows_plain(raw, 7, 5 * bpp, bpp), truth)


def test_png_unfilter_rejects_what_jax_rejects():
    raw = _filtered_rows(np.zeros((2, 6), np.uint8), (0,), 3)
    assert TN.png_unfilter(raw[:-1], 2, 6, 3) is None and JN.png_unfilter(raw[:-1], 2, 6, 3) is None
    bad = bytes([7]) + raw[1:]
    assert TN.png_unfilter(bad, 2, 6, 3) is None and JN.png_unfilter(bad, 2, 6, 3) is None


@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 1), (9, 13, 3), (9, 13, 4), (64, 48, 3)])
def test_write_png_bytes_equal_jax_and_read_back(tmp_path, shape):
    img = np.random.RandomState(len(shape) + shape[-1]).randint(0, 256, shape).astype(np.uint8)
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    TV.write_png(ours, img)
    JV.write_png(theirs, img)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(TV.read_png(ours), JV.read_png(ours))
    rows = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    raw, h, w, nch = TV.png_rows(ours)
    assert raw == TV.filter_sub_plain(rows.reshape(h, -1), nch)  # every row Sub-filtered
    np.testing.assert_array_equal(TV.unfilter_rows_plain(raw, h, w * nch, nch), rows.reshape(h, -1))


def test_read_png_of_paeth_rows_and_a_corrupt_file(tmp_path):
    img = np.random.RandomState(5).randint(0, 256, (11, 10, 3)).astype(np.uint8)

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    def png(rows):
        return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 10, 11, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))

    path = tmp_path / "paeth.png"
    path.write_bytes(png(_filtered_rows(img.reshape(11, -1), (4, 3), 3)))
    np.testing.assert_array_equal(TV.read_png(str(path)), img)
    np.testing.assert_array_equal(JV.read_png(str(path)), img)
    bad = bytearray(_filtered_rows(img.reshape(11, -1), (0,), 3))
    bad[0] = 9
    path.write_bytes(png(bytes(bad)))
    with pytest.raises(ValueError, match="unknown row filter"):
        TV.read_png(str(path))


def test_failed_host_build_raises_with_the_log(monkeypatch, tmp_path):
    """No quiet fallback: a compiler that fails raises, naming the source
    and carrying the compiler's output; a missing compiler raises too."""
    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\necho 'fake compiler: no luck' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match=r"(?s)csrc/cclabel\.cpp.*exit 3.*no luck"):
        cuda_build.load_library("cclabel")
    monkeypatch.setenv("CXX", str(tmp_path / "absent"))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    with pytest.raises(FileNotFoundError, match="C\\+\\+ compiler"):
        cuda_build.load_library("pngfilters")
    assert not os.path.exists(tmp_path / "_build") or not os.listdir(tmp_path / "_build")
