"""ctypes binding to the port's native host routines.

The port's own copy of `ipercore_tpu/utils/native.py`, over its own copies of
the sources (`csrc/cclabel.cpp`, `csrc/pngfilters.cpp`), built at first use
by `utils/cuda_build.py` with the host C++ compiler into
`ipercore_tpu_torch/_build/`. Where the JAX package returns None when its
library cannot be built, a failed build raises here with the compiler's log:
the callers keep no silent fallback. The Python versions of the same work
(`tools/detection._cc_boxes_plain`, `utils/video.unfilter_rows_plain`) are
the plain versions the tests hold these routines against.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ipercore_tpu_torch.utils import cuda_build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_bound: dict[str, ctypes.CDLL] = {}


def _lib(name: str) -> ctypes.CDLL:
    lib = _bound.get(name)
    if lib is None:
        lib = cuda_build.load_library(name)
        if name == "cclabel":
            lib.cc_boxes.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64, _I32P, ctypes.c_int64]
            lib.cc_boxes.restype = ctypes.c_int
        else:
            for fn in (lib.png_unfilter, lib.png_filter_sub):
                fn.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _U8P]
                fn.restype = ctypes.c_int
        _bound[name] = lib
    return lib


def _ptr(a: np.ndarray, kind=_U8P):
    return a.ctypes.data_as(kind)


def png_unfilter(raw: bytes, height: int, stride: int, bpp: int) -> Optional[np.ndarray]:
    """Reconstruct filtered PNG scanlines. Returns (height, stride) uint8, or
    None when `raw` is not `height * (stride + 1)` bytes or holds an unknown
    filter type."""
    lib = _lib("pngfilters")
    src = np.frombuffer(raw, np.uint8)
    if src.size != height * (stride + 1):
        return None
    out = np.empty((height, stride), np.uint8)
    rc = lib.png_unfilter(_ptr(src), height, stride, bpp, _ptr(out))
    return out if rc == 0 else None


def png_filter_sub(img: np.ndarray, bpp: int) -> Optional[bytes]:
    """Apply the Sub filter to (height, stride) uint8 rows; returns the
    filter-tagged scanline bytes ready for zlib, or None on bad arguments."""
    lib = _lib("pngfilters")
    img = np.ascontiguousarray(img, np.uint8)
    height, stride = img.shape
    out = np.empty((height, stride + 1), np.uint8)
    rc = lib.png_filter_sub(_ptr(img), height, stride, bpp, _ptr(out))
    return out.tobytes() if rc == 0 else None


def cc_boxes(mask: np.ndarray, max_comps: int = 256) -> Optional[np.ndarray]:
    """Connected-component boxes (8-connectivity) of a (H, W) bool / uint8
    mask. Returns (K, 5) int32 [x0, y0, x1, y1, area] (exclusive x1 / y1),
    sorted by area, largest first, at most `max_comps`; None on bad arguments
    (an empty mask, a non-positive `max_comps`)."""
    lib = _lib("cclabel")
    m = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    h, w = m.shape
    out = np.empty((max_comps, 5), np.int32)
    n = lib.cc_boxes(_ptr(m), h, w, _ptr(out, _I32P), max_comps)
    if n < 0:
        return None
    return out[:n]
