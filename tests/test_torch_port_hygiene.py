"""The port's boundaries: it imports no JAX and nothing of the JAX package,
builds nothing at import, defaults to the GPU, keeps CPU tensors on the plain
versions, and the repository tracks no weight file."""
import inspect
import os
import pkgutil
import re
import shutil
import subprocess
import sys
import types

import pytest
import torch

import ipercore_tpu_torch
from ipercore_tpu_torch.ops import dispatch
from ipercore_tpu_torch.ops import rasterizer_cuda as trc
from ipercore_tpu_torch.ops import sampling_cuda as tsc
from ipercore_tpu_torch.utils import cuda_build

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "ipercore_tpu_torch")
WEIGHTS = ["esrgan", "faceloss", "inpaintor", "inpaintor_refine", "lwg_pretrained_G",
           "matting_gca", "mobilenet_openpose", "openpose", "person_seg", "schp", "spin",
           "vgg_perceptual"]


def _read(path):
    with open(path) as f:
        return f.read()


def _module_names():
    names = ["ipercore_tpu_torch"]
    for m in pkgutil.walk_packages(ipercore_tpu_torch.__path__, prefix="ipercore_tpu_torch."):
        names.append(m.name)
    return names


def _python_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_every_module_imports_without_jax_or_the_jax_package():
    names = _module_names()
    assert len(names) >= 20
    for m in ("ipercore_tpu_torch.trainers.lwg_trainer", "ipercore_tpu_torch.services.personalization",
              "ipercore_tpu_torch.models.networks.discriminators",
              "ipercore_tpu_torch.models.networks.criterions",
              "ipercore_tpu_torch.data.datasets", "ipercore_tpu_torch.data.prefetch",
              "ipercore_tpu_torch.parallel.mesh", "ipercore_tpu_torch.services.train",
              "ipercore_tpu_torch.utils.logging", "ipercore_tpu_torch.utils.live_dashboard",
              "ipercore_tpu_torch.utils.torch_convert", "ipercore_tpu_torch.services.evaluate",
              "ipercore_tpu_torch.models.networks.inception"):
        assert m in names
    code = (
        "import importlib, sys\n"
        f"names = {names!r} + ['chip_smoke']\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'flax', 'ipercore_tpu')"
        " or m.startswith(('jax.', 'flax.', 'ipercore_tpu.'))]\n"
        "assert not bad, bad\n"
        "from ipercore_tpu_torch.utils import cuda_build\n"
        "assert not cuda_build._loaded, 'a module built a kernel at import'\n"
        "print('OK', len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("OK")


@pytest.mark.parametrize("pattern", [r"^\s*(import|from)\s+jax\b", r"^\s*(import|from)\s+flax\b",
                                     r"^\s*(import|from)\s+ipercore_tpu(\.|\s)",
                                     r"^\s*(import|from)\s+triton\b"])
def test_sources_do_not_import(pattern):
    """No source line imports jax, flax, the JAX package or (at module level
    or anywhere else on this slice) triton."""
    rx = re.compile(pattern, re.M)
    hits = [p for p in _python_sources() if rx.search(_read(p))]
    assert not hits, hits


def test_chip_smoke_reads_no_asset_and_no_jax():
    src = _read(os.path.join(ROOT, "chip_smoke.py"))
    assert "assets/" not in src and "assets\\" not in src and ".npz" not in src
    assert "load_flat_npz" not in src and "np.load" not in src


def test_no_build_directory_from_importing():
    assert cuda_build._loaded == {}
    assert cuda_build.BUILD_DIR == os.path.join(PKG, "_build")
    assert all(os.path.exists(os.path.join(cuda_build.CSRC_DIR, f"{s}.cu")) for s in cuda_build.SOURCES)
    assert "-gencode=arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


ENTRY_POINTS = [
    ("ipercore_tpu_torch.models.smpl", "synthetic_model"),
    ("ipercore_tpu_torch.models.smpl", "template_model"),
    ("ipercore_tpu_torch.models.smpl", "load_model"),
    ("ipercore_tpu_torch.models.mesh", "load_assets"),
    ("ipercore_tpu_torch.models.networks", "build_generator"),
    ("ipercore_tpu_torch.services.run_imitator", "imitate_sequence"),
    ("ipercore_tpu_torch.models.smpl", "resolve_body_model"),
    ("ipercore_tpu_torch.services.run_imitator", "build_runtime"),
    ("ipercore_tpu_torch.services.run_imitator", "imitate"),
    ("ipercore_tpu_torch.services.run_viewer", "novel_view"),
    ("ipercore_tpu_torch.services.run_swapper", "swap"),
    ("ipercore_tpu_torch.services.personalization", "personalize"),
    ("ipercore_tpu_torch.models.networks", "build_discriminator"),
    ("ipercore_tpu_torch.models.networks.criterions", "build_vgg"),
    ("ipercore_tpu_torch.models.networks.criterions", "build_face_net"),
    ("ipercore_tpu_torch.models.networks.criterions", "init_face_params"),
    ("ipercore_tpu_torch.services.train", "train"),
    ("ipercore_tpu_torch.parallel.mesh", "init_data_parallel"),
    ("ipercore_tpu_torch.services.evaluate", "evaluate_frames"),
    ("ipercore_tpu_torch.services.evaluate", "PerceptualMetric"),
    ("ipercore_tpu_torch.services.evaluate", "InceptionFID"),
    ("ipercore_tpu_torch.services.evaluate", "LPIPSMetric"),
]


@pytest.mark.parametrize("module,name", ENTRY_POINTS)
def test_entry_points_default_to_cuda(module, name):
    fn = getattr(__import__(module, fromlist=[name]), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU tensor reached the build of {name}")

    monkeypatch.setattr(cuda_build, "load_library", no_build)
    wrappers = (trc.raster_flows, trc.raster_fim, trc.raster_flows_table, tsc.grid_sample_nhwc,
                trc.prepare_raster, trc.prepare_table)
    before = tuple(w.launches for w in wrappers)
    fv = torch.rand(1, 6, 3, 3) * 2 - 1
    fv[..., 2] += 2
    trc.raster_flows(fv, torch.rand(2, 6, 3, 2), 16, with_stats=True)
    trc.raster_fim(fv, 16, with_stats=True)
    trc.raster_flows_table(fv, torch.rand(2, 6, 3, 2), 128)
    trc.prepare_table(fv, 128)
    tsc.grid_sample_nhwc(torch.rand(1, 4, 4, 3), torch.rand(1, 5, 5, 2) * 2 - 1)
    after = tuple(w.launches for w in wrappers)
    assert before == after == (0,) * 6 and all(isinstance(c, int) for c in after)


def test_dispatch_sends_cuda_tensors_to_the_kernel():
    cuda_like = types.SimpleNamespace(is_cuda=True)
    cpu_like = types.SimpleNamespace(is_cuda=False)
    assert dispatch.use_kernel(cuda_like) and not dispatch.use_kernel(cpu_like)
    with dispatch.force_plain():
        assert not dispatch.use_kernel(cuda_like)
    assert dispatch.use_kernel(cuda_like)


def test_build_without_nvcc_raises_and_does_not_fall_back(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda _: False)
    with pytest.raises(FileNotFoundError, match="nvcc"):
        cuda_build.load_library("raster")
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        cuda_build.check_launch(1, "x")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """Here there is no GPU: the script must exit non-zero and print no ok
    line, from the repository and from a directory that holds nothing else."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _git(*args):
    return subprocess.run(["git", *args], cwd=ROOT, capture_output=True, text=True)


def test_git_tracks_no_weight_file_and_stays_small():
    if _git("rev-parse", "--is-inside-work-tree").stdout.strip() != "true":
        pytest.skip("not in a git work tree")
    files = [f for f in _git("ls-files", "-z").stdout.split("\0") if f]
    for w in WEIGHTS:
        assert f"assets/{w}.npz" not in files
    assert "assets/WEIGHTS.md" in files and "assets/gmm_prior.npz" in files
    total = sum(os.path.getsize(os.path.join(ROOT, f)) for f in files
                if os.path.isfile(os.path.join(ROOT, f)))
    assert total < 40_000_000, total
    assert not [f for f in files if f.startswith(("ipercore_tpu_torch/_build/", "chiprun_out/"))]


def test_ignore_files_list_the_weights():
    gitignore = _read(os.path.join(ROOT, ".gitignore")).splitlines()
    chipignore = _read(os.path.join(ROOT, ".chiprunignore")).splitlines()
    for w in WEIGHTS:
        assert f"assets/{w}.npz" in gitignore and f"assets/{w}.npz" in chipignore
    assert "ipercore_tpu_torch/_build/" in gitignore and "chiprun_out/" in gitignore
    assert "assets/*.npz" not in gitignore
    # the copy tool takes plain relative paths only
    assert all(l and not l.endswith("/") and not set(l) & set("*?![") for l in chipignore)
    weights_md = _read(os.path.join(ROOT, "assets", "WEIGHTS.md"))
    assert all(f"assets/{w}.npz" in weights_md for w in WEIGHTS)


def test_pyproject_names_the_port():
    assert '"ipercore_tpu_torch*"' in _read(os.path.join(ROOT, "pyproject.toml"))
