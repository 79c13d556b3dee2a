"""Build-at-first-use for the sources under `ipercore_tpu_torch/csrc/`.

Each `<name>.cu` exposes a plain C interface and is compiled by `nvcc` into
`ipercore_tpu_torch/_build/lib<name>-<hash>.so`, then loaded with `ctypes`.
Each `<name>.cpp` (host code: `HOST_SOURCES`) is compiled the same way by the
host C++ compiler (`$CXX`, else `c++` or `g++` on PATH). Nothing is built when
a module is imported: `load_library` is called by a wrapper the first time it
runs. `build_all` compiles every source in parallel (one compiler process
each), which is what a start-up script wants.

The CUDA build needs `nvcc` (on PATH, under `$CUDA_HOME`, or `/usr/local/cuda`)
and targets `sm_90a`; there is no fallback when a compiler is missing or fails
— the error says so, with the compiler's log.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
SOURCES = ("raster_bin", "raster", "raster_table_bin", "raster_table", "grid_sample", "spade_conv")
HOST_SOURCES = ("cclabel", "pngfilters")
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of the CUDA compiler; raises FileNotFoundError when there is none."""
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise FileNotFoundError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA kernels of "
        "ipercore_tpu_torch can only be built on a machine with the CUDA toolkit")


def find_cxx() -> str:
    """Path of the host C++ compiler (`$CXX`, else `c++` or `g++` on PATH);
    raises FileNotFoundError when there is none."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        path = c and (c if os.path.isabs(c) else shutil.which(c))
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise FileNotFoundError(
        "no host C++ compiler ($CXX, c++, g++): the native routines of "
        "ipercore_tpu_torch cannot be built")


def _included(path: str, seen: list[str]) -> list[str]:
    """`path` and every file under `csrc/` that it includes with quotes,
    directly or through another such file, each once."""
    if path not in seen:
        seen.append(path)
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                dep = os.path.join(os.path.dirname(path), inc.decode())
                if os.path.isfile(dep):
                    _included(dep, seen)
    return seen


def _source(name: str) -> tuple[str, tuple[str, ...]]:
    """The source file of `name` and its compiler's flags."""
    if name in HOST_SOURCES:
        return os.path.join(CSRC_DIR, f"{name}.cpp"), CXX_FLAGS
    return os.path.join(CSRC_DIR, f"{name}.cu"), NVCC_FLAGS


def _paths(name: str) -> tuple[str, str]:
    """The source and its library, named by a hash of the source, every
    header it includes from `csrc/` and the flags: an edited header rebuilds."""
    src, flags = _source(name)
    h = hashlib.sha256(" ".join(flags).encode())
    for path in _included(src, []):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str) -> tuple[subprocess.Popen, str, str] | None:
    """Start the compiler for one source unless its library is already built."""
    src, lib = _paths(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    flags = _source(name)[1]
    compiler = find_cxx() if name in HOST_SOURCES else find_nvcc()
    proc = subprocess.Popen([compiler, *flags, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish_build(name: str, started: tuple[subprocess.Popen, str, str] | None) -> None:
    if started is None:
        return
    proc, tmp, lib = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        src = os.path.basename(_source(name)[0])
        raise RuntimeError(f"{os.path.basename(proc.args[0])} failed on csrc/{src} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)


def build_all() -> None:
    """Compile every source, all compiler processes started together."""
    started = [(n, _start_build(n)) for n in SOURCES + HOST_SOURCES]
    errors = []
    for n, s in started:  # wait for every compiler before reporting a failure
        try:
            _finish_build(n, s)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]


def load_library(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` (or `.cpp`) if needed and return its loaded library."""
    lib = _loaded.get(name)
    if lib is None:
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(_paths(name)[1])
        _loaded[name] = lib
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise when a launch function returned a non-zero `cudaGetLastError()`."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {err}")
