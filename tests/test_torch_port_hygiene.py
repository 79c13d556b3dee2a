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

import numpy as np
import pytest
import torch

import ipercore_tpu_torch
from ipercore_tpu_torch.ops import dispatch
from ipercore_tpu_torch.ops import rasterizer_cuda as trc
from ipercore_tpu_torch.ops import sampling_cuda as tsc
from ipercore_tpu_torch.ops import spade_conv_cuda as tk5
from ipercore_tpu_torch.utils import cuda_build
from ipercore_tpu_torch.utils import logging as tlogging

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "ipercore_tpu_torch")
# each driver of `ipercore_tpu_torch/scripts/` with the arguments of a short run
DRIVER_ARGS = {
    "train_lwg_pretrain": ["--smoke"], "train_vgg": ["--smoke"], "train_faceloss": ["--smoke"],
    "train_spin": ["--smoke"], "train_openpose": ["--smoke"], "train_person_seg": ["--smoke"],
    "train_schp": ["--smoke"], "train_inpaintor": ["--smoke"], "train_esrgan": ["--smoke"],
    "fit_gmm_prior": ["--n", "64", "--out", os.devnull], "pseudo_label_pose": ["--report"],
    "pseudo_label_seg": ["--report"], "pseudo_label_theta": ["--report"], "eval_real_photos": [],
    "verify_perception": ["--frames", "2"], "prepare_dataset": ["--raw_dir", ".", "--output_dir", "."],
    "visual_processed_data": ["--dataset_dir", "."], "evaluate.eval_imitator": ["--pred_dir", ".", "--gt_dir", "."],
    "evaluate.accuracy_cost": ["--smoke"], "evaluate.self_imitation": [],
}
DRIVERS = tuple(DRIVER_ARGS)
# the root `scripts/` drivers without a twin: the JAX benchmark drivers, which
# the port's benchmark replaces, and the port's own probes (`torch_*`)
NO_TWIN = ("train_bench", "stage_bench", "temporal_bench", "measure_reference_baseline", "qualify_train_memory")
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
              "ipercore_tpu_torch.models.networks.inception", "ipercore_tpu_torch.utils.native",
              "ipercore_tpu_torch.tools.detection", "ipercore_tpu_torch.tools.pose2d",
              "ipercore_tpu_torch.tools.pose2d_mobilenet", "ipercore_tpu_torch.tools.mattors",
              "ipercore_tpu_torch.tools.preprocessor", "ipercore_tpu_torch.utils.keypoints",
              "ipercore_tpu_torch.tools.pose3d", "ipercore_tpu_torch.tools.deformers",
              "ipercore_tpu_torch.ops.attention", "ipercore_tpu_torch.tools.parsers",
              "ipercore_tpu_torch.tools.inpaintors", "ipercore_tpu_torch.services.preprocess",
              "ipercore_tpu_torch.parallel.inference", "ipercore_tpu_torch.parallel.streaming",
              "ipercore_tpu_torch.tools.synth_data", *(f"ipercore_tpu_torch.scripts.{d}" for d in DRIVERS),
              "ipercore_tpu_torch.scripts.evaluate",
              "ipercore_tpu_torch.scripts._common", "ipercore_tpu_torch.scripts.eval_real_photos"):
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
                                     r"^\s*(import|from)\s+triton\b",
                                     r"^\s*(import|from)\s+(scripts|eval_real_photos)\b"])
def test_sources_do_not_import(pattern):
    """No source line imports jax, flax, the JAX package, the JAX drivers of
    the root `scripts/` (the port's drivers keep their own copies) or (at
    module level or anywhere else on this slice) triton."""
    rx = re.compile(pattern, re.M)
    hits = [p for p in _python_sources() if rx.search(_read(p))]
    assert not hits, hits


def test_kernels_launch_on_their_inputs_device():
    """No source asks for the current stream without naming a device: a
    kernel must launch on the stream of its inputs' device
    (`dispatch.kernel_stream`), whichever device is current."""
    rx = re.compile(r"current_stream\(\s*\)")
    assert not [p for p in _python_sources() if rx.search(_read(p))]


def test_chip_smoke_reads_no_asset_and_no_jax():
    src = _read(os.path.join(ROOT, "chip_smoke.py"))
    assert "assets/" not in src and "assets\\" not in src and ".npz" not in src
    assert "load_flat_npz" not in src and "np.load" not in src


def test_no_build_directory_from_importing():
    """No CUDA library is ever loaded in a CPU test process (the host-code
    libraries of `HOST_SOURCES` are, by the tests that write or read PNGs or
    label components; that importing builds nothing is checked in a fresh
    process by the first test)."""
    assert not set(cuda_build._loaded) & set(cuda_build.SOURCES)
    assert cuda_build.BUILD_DIR == os.path.join(PKG, "_build")
    assert all(os.path.exists(os.path.join(cuda_build.CSRC_DIR, f"{s}.cu")) for s in cuda_build.SOURCES)
    assert all(os.path.exists(os.path.join(cuda_build.CSRC_DIR, f"{s}.cpp")) for s in cuda_build.HOST_SOURCES)
    assert "-gencode=arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


def test_native_routines_come_from_the_port_build_only():
    """The port names no library or source of the JAX package's `native/`,
    loads shared libraries only through `utils/cuda_build.py`, and every
    library it loads lies in `ipercore_tpu_torch/_build/`, built from its own
    copies under `csrc/`."""
    from ipercore_tpu_torch.utils import native

    rx = re.compile(r"""["'/]native/|join\(.*["']native["']|libcclabel|libpngfilters""")
    assert not [p for p in _python_sources() if rx.search(_read(p))]
    loaders = [p for p in _python_sources() if re.search(r"ctypes\.(CDLL|LoadLibrary)\(|cdll\.LoadLibrary\(", _read(p))]
    assert loaders == [os.path.join(PKG, "utils", "cuda_build.py")], loaders
    for name in cuda_build.SOURCES + cuda_build.HOST_SOURCES:
        src, lib = cuda_build._paths(name)
        assert src.startswith(cuda_build.CSRC_DIR + os.sep) and os.path.isfile(src)
        assert os.path.dirname(lib) == cuda_build.BUILD_DIR
    native.cc_boxes(np.ones((3, 3), bool))
    native.png_unfilter(b"\x00" * 4, 1, 3, 3)
    for lib in list(native._bound.values()) + list(cuda_build._loaded.values()):
        assert os.path.dirname(os.path.abspath(lib._name)) == cuda_build.BUILD_DIR, lib._name


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
    ("ipercore_tpu_torch.tools.pose2d", "OpenPoseRunner"),
    ("ipercore_tpu_torch.tools.pose2d", "build_pose2d_estimator"),
    ("ipercore_tpu_torch.tools.pose2d_mobilenet", "MobilenetOpenPoseRunner"),
    ("ipercore_tpu_torch.tools.mattors", "HumanMattor"),
    ("ipercore_tpu_torch.tools.detection", "SegmentationDetector"),
    ("ipercore_tpu_torch.tools.detection", "pose_person_boxes"),
    ("ipercore_tpu_torch.tools.detection", "detect_person_boxes"),
    ("ipercore_tpu_torch.tools.preprocessor", "process_crop_img"),
    ("ipercore_tpu_torch.tools.pose3d", "SPINRunner"),
    ("ipercore_tpu_torch.tools.pose3d", "load_gmm_prior"),
    ("ipercore_tpu_torch.tools.pose3d", "fit_gmm_prior"),
    ("ipercore_tpu_torch.tools.deformers", "run_sil2smpl_offsets"),
    ("ipercore_tpu_torch.tools.mattors", "build_mattor"),
    ("ipercore_tpu_torch.tools.parsers", "SchpParser"),
    ("ipercore_tpu_torch.tools.parsers", "build_parser"),
    ("ipercore_tpu_torch.tools.inpaintors", "SuperResolutionInpaintor"),
    ("ipercore_tpu_torch.tools.inpaintors", "build_background_inpaintors"),
    ("ipercore_tpu_torch.tools.preprocessor", "Preprocessor"),
    ("ipercore_tpu_torch.tools.preprocessor", "background_visibility"),
    ("ipercore_tpu_torch.utils.visualizer", "smpl_overlay_frames"),
    ("ipercore_tpu_torch.utils.visualizer", "write_visual_video"),
    ("ipercore_tpu_torch.services.preprocess", "preprocess"),
    ("ipercore_tpu_torch.services.preprocess", "preprocess_one"),
    ("ipercore_tpu_torch.services.preprocess", "human_estimate"),
    ("ipercore_tpu_torch.services.preprocess", "digital_deform"),
    ("ipercore_tpu_torch.services.run_imitator", "run_imitator"),
    ("ipercore_tpu_torch.services.run_viewer", "run_viewer"),
    ("ipercore_tpu_torch.services.run_swapper", "run_swapper"),
    ("ipercore_tpu_torch.parallel.mesh", "local_devices"),
    ("ipercore_tpu_torch.tools.synth_data", "Draws"),
]


@pytest.mark.parametrize("module,name", ENTRY_POINTS)
def test_entry_points_default_to_cuda(module, name):
    fn = getattr(__import__(module, fromlist=[name]), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("driver", DRIVERS)
def test_training_drivers_default_to_the_card_and_refuse_without_one(monkeypatch, driver):
    """`python -m ipercore_tpu_torch.scripts.<driver>` runs on `cuda` unless
    `--device cpu` is given; without a card it raises before any work, it
    does not fall back to the CPU."""
    import importlib

    mod = importlib.import_module(f"ipercore_tpu_torch.scripts.{driver}")
    assert "--device" in inspect.getsource(mod.main) and 'default="cuda"' in inspect.getsource(mod.main)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(DRIVER_ARGS[driver])


def test_every_root_script_has_a_twin_or_is_listed():
    """Each `.py` under the root `scripts/` (subfolders too) has a twin of the
    same relative path under `ipercore_tpu_torch/scripts/`, or is one of the
    JAX benchmark drivers the port's benchmark replaces, or a probe of the
    port's own (`torch_*`)."""
    root = os.path.join(ROOT, "scripts")
    missing = []
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py") or f == "__init__.py":
                continue
            rel = os.path.relpath(os.path.join(d, f), root)
            name = rel[:-3].replace(os.sep, ".")
            if name in NO_TWIN or f.startswith("torch_"):
                continue
            if not os.path.exists(os.path.join(PKG, "scripts", rel)):
                missing.append(rel)
    assert not missing, missing
    # every twin is in the no-JAX import test and the card test above
    prefix = "ipercore_tpu_torch.scripts."
    twins = {n[len(prefix):] for n in _module_names() if n.startswith(prefix)}
    assert {t for t in twins if not t.rsplit(".", 1)[-1].startswith("_") and t != "evaluate"} == set(DRIVERS)


def test_sharded_synthesize_defaults_to_every_cuda_device(monkeypatch):
    """`sharded_synthesize(devices=None)` splits over `local_devices()`, the
    visible CUDA devices; with none it raises, it does not fall back to the CPU."""
    from ipercore_tpu_torch.parallel.inference import sharded_synthesize

    assert inspect.signature(sharded_synthesize).parameters["devices"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded_synthesize(None, None, None, np.zeros((1, 85), np.float32))


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU tensor reached the build of {name}")

    monkeypatch.setattr(cuda_build, "load_library", no_build)
    names = ("k1.launches", "k3.launches", "k4.launches", "k2.launches", "raster_binning.launches",
             "table_binning.launches", "k5.launches")
    before = tuple(tlogging.counts().get(k, 0) for k in names)
    fv = torch.rand(1, 6, 3, 3) * 2 - 1
    fv[..., 2] += 2
    trc.raster_flows(fv, torch.rand(2, 6, 3, 2), 16, with_stats=True)
    trc.raster_fim(fv, 16, with_stats=True)
    trc.raster_flows_table(fv, torch.rand(2, 6, 3, 2), 128)
    trc.prepare_table(fv, 128)
    tsc.grid_sample_nhwc(torch.rand(1, 4, 4, 3), torch.rand(1, 5, 5, 2) * 2 - 1)
    wp, b = tk5.pack_conv3x3((torch.rand(4, 16, 3, 3), torch.rand(4, 16, 3, 3)), (torch.rand(4), torch.rand(4)))
    tk5.spade_modulate(tk5.spade_conv_relu(torch.rand(1, 5, 6, 16), *tk5.pack_conv3x3(
        (torch.rand(16, 16, 3, 3),), (torch.rand(16),))), wp, b, torch.rand(1, 5, 6, 4),
        torch.rand(1, 1, 1, 4), torch.rand(1, 1, 1, 4))
    after = tuple(tlogging.counts().get(k, 0) for k in names)
    assert before == after == (0,) * 7 and all(isinstance(c, int) for c in after)


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
