"""`services/train.train` with `train_name = BaselineTrainer` (InputConcat,
which has no source stream) in both packages, two iterations from one start
checkpoint, on the data, settings and composition table of
`test_torch_train_service.py`, held to that file's two-step bars for G
(its second gradient is taken at parameters the first step moved apart) on
both networks, with 97 % (not 98 %) of the moments within 1e-3 of the
largest. InputConcat's G is a third BGNet by parameters, and BGNet's
convolutions before an instance norm take gradients that are float noise in
their biases, which the first step moves by +-lr either way in the two
packages; the second step's BGNet gradients then differ by ~1.3 % (L2), and
D's second step sees fakes composited over that background. Measured on
this rig: 97.9 % (G) and 97.8 % (D) of the moments within 1e-3 of the
largest, 0.5 % / 0.4 % apart in L2, 99.5 % / 99.4 % of the parameters within
1e-5. The first step alone is held to the one-step bars in
`test_torch_zoo_trainers.py`.
"""
import numpy as np
import pytest

import jax

from ipercore_tpu.parallel import mesh as jmesh
from ipercore_tpu.services import options as jopts
from ipercore_tpu.services import train as jtrain
from ipercore_tpu_torch.models.networks import build_discriminator as tbuild_dis
from ipercore_tpu_torch.models.networks import build_generator as tbuild_gen
from ipercore_tpu_torch.models.networks import criterions as TC
from ipercore_tpu_torch.services import options as topts
from ipercore_tpu_torch.services import train as ttrain
from ipercore_tpu_torch.utils import checkpoint as tckpt

from tests.test_torch_common import NARROW_CFG, write_train_video
from tests.test_torch_train_service import (
    DIS_CFG,
    ITERS,
    S,
    TWO_STEP_BARS,
    _geometry_table,
    _moments,
    _opt,
    _read_log,
    _same_geometry,
)

LR = 1e-4
# (moments within 1e-3 of the largest, parameter tolerance, fraction within it)
BARS = {net: (0.97,) + TWO_STEP_BARS["G"][1:] for net in "GD"}


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    """Both packages' `train(opt, max_iters=2)` with `train_name =
    BaselineTrainer` from one `net_iter_0_id_{G,D}.npz`, on the data and the
    settings of `test_torch_train_service.py` (its composition table too)."""
    from ipercore_tpu_torch.data import build_dataset

    base = tmp_path_factory.mktemp("baseline_service")
    data = base / "data"
    write_train_video(str(data), "v0", 5, seed=31, mask_size=S, background=True)
    write_train_video(str(data), "v1", 4, seed=32, mask_size=48)
    (data / "train.txt").write_text("v0\nv1\n")
    (data / "val.txt").write_text("v1\n")
    vgg = TC.build_vgg("VGG11", device="cpu")
    vgg_path = str(base / "vgg11.npz")
    tckpt.save_params(vgg_path, tckpt.seeded_flat_params(vgg, 7))
    gen = tbuild_gen("InputConcat", NARROW_CFG, num_source=2, device="cpu")
    dis = tbuild_dis("patch_global", DIS_CFG, device="cpu")
    start = {"G": tckpt.seeded_flat_params(gen, 5), "D": tckpt.seeded_flat_params(dis, 6)}
    for name in ("jax", "port"):
        ckpt = base / name / "models" / "m"
        ckpt.mkdir(parents=True)
        for net, flat in start.items():
            tckpt.save_params(str(ckpt / f"net_iter_0_id_{net}.npz"), flat)
    opts = {"jax": _opt(jopts, base / "jax", data, vgg_path), "port": _opt(topts, base / "port", data, vgg_path)}
    for o in opts.values():  # both options' gen_name defaults to AttLWB-SPADE
        o.update(train_name="BaselineTrainer", gen_name="InputConcat")
    kw = dict(dataset_dirs=[str(data)], image_size=S, num_source=2, time_step=1)
    train_it = build_dataset("ProcessedVideo", **kw).iterate(1, seed=0)
    val_it = build_dataset("ProcessedVideo", split="val", **kw).iterate(1, seed=7)
    table = _geometry_table(opts["jax"], [next(train_it) for _ in range(ITERS)] +
                            [next(val_it) for _ in range(ITERS)])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _same_geometry(mp, table)
        mp.setattr(jmesh, "make_mesh", lambda axis_name="data", n_devices=None: jmesh.Mesh(
            np.asarray(jax.devices()[:1]), (axis_name,)))
        out["jax"] = jtrain.train(opts["jax"], max_iters=ITERS)
        out["port"] = ttrain.train(opts["port"], max_iters=ITERS, device="cpu")
    return base, out


def test_baseline_service_matches_jax(service):
    """Same files, logs with the same keys (first step's losses within 1e-4,
    later values within 1e-3), and after two steps the parameters and both
    moments within the two-step bars."""
    base, out = service
    dirs = {k: base / k / "models" / "m" for k in ("jax", "port")}
    assert sorted(p.name for p in dirs["jax"].iterdir()) == sorted(p.name for p in dirs["port"].iterdir())
    logs = {k: _read_log(d / "train_log.jsonl") for k, d in dirs.items()}
    assert [sorted(r) for r in logs["port"]] == [sorted(r) for r in logs["jax"]]
    assert len(logs["port"]) == ITERS and "val_g_total" in logs["port"][0]
    for i, (a, b) in enumerate(zip(logs["port"], logs["jax"])):
        for k in b:
            if k not in ("t", "step"):
                rtol = 1e-4 if i == 0 and not k.startswith("val_") else 1e-3
                np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-6, err_msg=f"{i} {k}")
    assert out["port"].keys() == out["jax"].keys()
    p = tckpt.load_flat_npz(str(dirs["port"] / f"net_iter_{ITERS}_id_G.npz"))
    assert any(k.startswith("params/net/") for k in p) and not any(k.startswith("params/src_net/") for k in p)
    for net in ("G", "D"):
        within_max, param_tol, param_frac = BARS[net]
        p = {k: tckpt.load_flat_npz(str(d / f"net_iter_{ITERS}_id_{net}.npz")) for k, d in dirs.items()}
        assert p["jax"].keys() == p["port"].keys()
        cat = lambda d: np.concatenate([np.asarray(d[k], np.float64).ravel() for k in sorted(d)])
        dp = np.abs(cat(p["port"]) - cat(p["jax"]))
        assert dp.max() <= 2 * LR * ITERS * 1.001, (net, dp.max())
        assert (dp <= param_tol).mean() >= param_frac, (net, (dp <= param_tol).mean())
        leaves = {k: tckpt.load_leaves(str(d / f"opt_iter_{ITERS}_id_{net}.npz")) for k, d in dirs.items()}
        assert [int(x) for x in leaves["port"][:4]] == [int(x) for x in leaves["jax"][:4]] == [0, 1, 0, ITERS]
        n_p = (len(leaves["jax"]) - 4) // 2
        got, want = _moments(leaves["port"], n_p), _moments(leaves["jax"], n_p)
        for what in ("mu", "nu"):
            a, b = got[what], want[what]
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            frac = (np.abs(a - b) <= 1e-3 * np.abs(b).max()).mean()
            assert rel <= 2e-2 and frac >= within_max, (net, what, rel, frac)
