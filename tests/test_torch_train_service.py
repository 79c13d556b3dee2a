"""The train service of the port against the JAX package's: the training
checkpoints across the two packages (both directions, with a constant and a
scheduled learning rate), resume, and `train` itself from one start
checkpoint (64², the smoke body, a narrow generator, D ndf 8, VGG11 from one
weight file, no face loss, ns = 2, nt = 1, bs 1, two iterations).

Tolerances: checkpoint carriers are exact (bit for bit). Two iterations of
the two packages' services from one start, each composing its own inputs, are
held to `test_torch_trainer.py::test_train_step_updates_match_jax`'s bars:
the first moments (the clipped gradients over 1 - b1) within 2 % (L2,
relative) and 99 % of the elements within 1e-3 of the largest; the square
root of the second moments the same; every parameter within 2 * lr per step
and 97 % within 1e-6; the first step's losses within 1e-4 relative. Both
services take one composition per batch (JAX's, see `_same_geometry`). D
meets those bars after two steps; G's second gradient is taken at parameters
that the first step already moved apart (a weight whose gradient is near 0
moves by +-lr either way), so after two steps G's bars are 98 % of the
moments within 1e-3 of the largest and 95 % of the parameters within a tenth
of a step (1e-5), and the losses computed after an update agree within 1e-3.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ipercore_tpu.parallel import mesh as jmesh
from ipercore_tpu.services import options as jopts
from ipercore_tpu.services import train as jtrain
from ipercore_tpu.trainers import lwg_trainer as JT
from ipercore_tpu.utils import checkpoint as jckpt
from ipercore_tpu_torch.models.networks import build_discriminator as tbuild_dis
from ipercore_tpu_torch.models.networks import build_generator as tbuild_gen
from ipercore_tpu_torch.models.networks import criterions as TC
from ipercore_tpu_torch.services import options as topts
from ipercore_tpu_torch.services import train as ttrain
from ipercore_tpu_torch.trainers import lwg_trainer as TT
from ipercore_tpu_torch.utils import checkpoint as tckpt

from tests.test_torch_common import NARROW_CFG, flatten_flax, unflatten_to_jax, write_train_video

S = 64
DIS_CFG = {"ndf": 8, "n_layers": 2, "max_nf_mult": 8, "use_sigmoid": False}
# the carrier tests' generator: every kind of layer, one residual block a stage
CKPT_CFG = {k: dict(v, n_res_block=1) for k, v in NARROW_CFG.items()}


def _nets():
    gen = tbuild_gen("AttLWB-SPADE", CKPT_CFG, device="cpu")
    dis = tbuild_dis("patch_global", DIS_CFG, device="cpu")
    tckpt.load_generator_params(gen, tckpt.seeded_flat_params(CKPT_CFG, 0))
    tckpt.load_generator_params(dis, tckpt.seeded_flat_params(dis, 1))
    return gen, dis


def _grads(params, rng, scale=1.0):
    return {k: torch.as_tensor(rng.randn(*v.shape).astype(np.float32) * scale) for k, v in params.items()}


def _port_state(gen, dis, cfg, seed=0):
    """A port train state whose optimizer states went through finite,
    clipped and non-finite updates."""
    rng = np.random.RandomState(seed)
    state = TT.create_train_state(gen, dis, cfg)
    tx_g, tx_d = TT.make_optimizers(cfg)
    pg, og, pd, od = state.params_G, state.opt_G, state.params_D, state.opt_D
    for scale in (0.1, 50.0, np.nan, 0.3):
        g = _grads(pg, rng, scale)
        pg, og = tx_g.apply(g, og, pg)
        pd, od = tx_d.apply(_grads(pd, rng, 0.2), od, pd)
    return state._replace(params_G=pg, params_D=pd, opt_G=og, opt_D=od, step=torch.tensor(4, dtype=torch.int32))


def _jax_state(gen, dis, cfg, seed=0, fresh=False):
    """The JAX package's train state on the same parameters, its optimizer
    states through the same kinds of updates (one jitted program)."""
    pg = unflatten_to_jax(tckpt.torch_params_to_flax(gen))
    pd = unflatten_to_jax(tckpt.torch_params_to_flax(dis))
    tx_g, tx_d = JT.make_optimizers(cfg)
    rng = np.random.RandomState(seed)
    draw = lambda tree, scale: jax.tree_util.tree_map(
        lambda l: rng.randn(*l.shape).astype(np.float32) * scale, tree)
    grads = [] if fresh else [(draw(pg, scale), draw(pd, 0.2)) for scale in (0.1, 50.0, np.nan, 0.3)]

    def update(tx):
        def one(g, o, p):
            upd, o = tx.update(g, o, p)
            return optax.apply_updates(p, upd), o
        return jax.jit(one)

    step_g, step_d = update(tx_g), update(tx_d)
    og, od = jax.jit(tx_g.init)(pg), jax.jit(tx_d.init)(pd)
    for g, d in grads:
        pg, og = step_g(g, og, pg)
        pd, od = step_d(d, od, pd)
    return JT.LWGTrainState(params_G=pg, params_D=pd, opt_G=og, opt_D=od, step=jnp.zeros((), jnp.int32))


def _leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def _assert_same_state(tstate, jstate, gen, dis, scheduled):
    for module, tp, jp, to, jo in ((gen, tstate.params_G, jstate.params_G, tstate.opt_G, jstate.opt_G),
                                   (dis, tstate.params_D, jstate.params_D, tstate.opt_D, jstate.opt_D)):
        want = flatten_flax(jp)
        got = tckpt.torch_params_to_flax(module, tp)
        assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
        tl, jl = tckpt.adam_state_to_leaves(module, to, scheduled), _leaves(jo)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


CFGS = {"constant": dict(), "scheduled": dict(niters_no_decay=2, niters_decay=5)}


@pytest.mark.parametrize("lr", list(CFGS))
def test_jax_train_checkpoint_loads_in_the_port(tmp_path, lr):
    gen, dis = _nets()
    jstate = _jax_state(gen, dis, JT.TrainConfig(**CFGS[lr]))
    assert int(jax.tree_util.tree_leaves(jstate.opt_G)[0]) == 0  # notfinite_count after a finite step
    jckpt.save_train_ckpt(str(tmp_path), 6, jstate.params_G, jstate.params_D, opt_G=jstate.opt_G,
                          opt_D=jstate.opt_D)
    cfg = TT.TrainConfig(**CFGS[lr])
    like = TT.create_train_state(gen, dis, cfg)
    got = tckpt.load_train_ckpt(str(tmp_path), 6, like, gen, dis, scheduled=cfg.niters_decay > 0)
    assert int(got.step) == 6 and int(got.opt_G.count) == 3 and int(got.opt_G.total_notfinite) == 1
    _assert_same_state(got, jstate, gen, dis, cfg.niters_decay > 0)


@pytest.mark.parametrize("lr", list(CFGS))
def test_port_train_checkpoint_loads_in_jax(tmp_path, lr):
    gen, dis = _nets()
    cfg = TT.TrainConfig(**CFGS[lr])
    tstate = _port_state(gen, dis, cfg)
    assert int(tstate.opt_G.count) == 3 and int(tstate.opt_G.total_notfinite) == 1
    tckpt.save_train_ckpt(str(tmp_path), 4, tstate, gen, dis, scheduled=cfg.niters_decay > 0)
    assert sorted(os.listdir(tmp_path)) == [f"{k}_iter_4_id_{n}.npz" for k in ("net", "opt") for n in "DG"]
    like = _jax_state(gen, dis, JT.TrainConfig(**CFGS[lr]), fresh=True)
    got = jckpt.load_train_ckpt(str(tmp_path), 4, like)
    assert int(got.step) == 4
    _assert_same_state(tstate, got, gen, dis, cfg.niters_decay > 0)
    # and back into the port, unchanged
    back = tckpt.load_train_ckpt(str(tmp_path), 4, TT.create_train_state(gen, dis, cfg), gen, dis,
                                 scheduled=cfg.niters_decay > 0)
    _assert_same_state(back, got, gen, dis, cfg.niters_decay > 0)


def test_missing_files_keep_the_fresh_state_and_a_wrong_leaf_count_raises(tmp_path):
    gen, dis = _nets()
    cfg = TT.TrainConfig()
    tstate = _port_state(gen, dis, cfg)
    tckpt.save_train_ckpt(str(tmp_path), 3, tstate, gen, dis)
    fresh = TT.create_train_state(gen, dis, cfg)
    os.remove(tmp_path / "opt_iter_3_id_G.npz")
    os.remove(tmp_path / "net_iter_3_id_D.npz")
    got = tckpt.load_train_ckpt(str(tmp_path), 3, fresh, gen, dis)
    assert got.opt_G is fresh.opt_G and got.params_D is fresh.params_D
    assert all(torch.equal(got.params_G[k], tstate.params_G[k]) for k in tstate.params_G)
    assert all(torch.equal(got.opt_D.nu[k], tstate.opt_D.nu[k]) for k in tstate.opt_D.nu)
    # a scheduled state on disk has one leaf more than a constant one expects
    tckpt.save_train_ckpt(str(tmp_path), 5, tstate, gen, dis, scheduled=True)
    with pytest.raises(ValueError, match=r"opt_iter_5_id_G\.npz: \d+ saved leaves vs \d+ expected"):
        tckpt.load_train_ckpt(str(tmp_path), 5, fresh, gen, dis, scheduled=False)


def test_find_latest_iter_matches_jax(tmp_path):
    assert tckpt.find_latest_iter(str(tmp_path / "none")) == jckpt.find_latest_iter(str(tmp_path / "none")) \
        == (-1, None)
    for name in ("net_iter_3_id_G.npz", "net_iter_12_id_G.npz", "net_iter_40_id_D.npz",
                 "opt_iter_50_id_G.npz", "net_iter_7_id_G.npz.tmp.npz", "x_net_iter_99_id_G.npz"):
        (tmp_path / name).write_bytes(b"")
    for net in ("G", "D"):
        assert tckpt.find_latest_iter(str(tmp_path), net) == jckpt.find_latest_iter(str(tmp_path), net)
    assert tckpt.find_latest_iter(str(tmp_path))[0] == 12


# --- the service ----------------------------------------------------------------

ITERS = 2


def _opt(mod, out_dir, data_root, vgg_path, **train):
    opt = mod.setup(None, [])
    opt.update(image_size=S, num_source=2, time_step=1, batch_size=1, output_dir=str(out_dir),
               model_id="m", out_dilate_ks=9, smoke_model=True, Generator=NARROW_CFG,
               dataset_dirs=[str(data_root)])
    opt.Discriminator.update(DIS_CFG)
    opt.Train.update(dict(use_face=False, face_loss_path="random", use_vgg="VGG11", vgg_loss_path=vgg_path,
                          print_freq_s=0.0, display_freq_s=1e9, save_latest_freq_s=0.0,
                          niters_or_epochs_no_decay=0, niters_or_epochs_decay=0), **train)
    return opt


_COMP_KEYS = ("input_G_bg", "input_G_src", "input_G_tsf", "Tst")


def _geometry_table(opt, batches):
    """JAX's composition (jitted alone) of every batch the services will see,
    keyed by the batch's SMPL bytes: {key: {input_G_*, Tst, j2d}}."""
    from ipercore_tpu.models import flow_composition as jfc
    from ipercore_tpu.models import smpl as jsmpl
    from ipercore_tpu.models.mesh import load_assets as jload_assets

    model = jsmpl.resolve_body_model(opt)
    comp = jfc.make_composer(model, jload_assets(model), image_size=S, out_dilate_ks=int(opt.out_dilate_ks))
    fwd = jax.jit(lambda *a: jfc.forward(comp, *a[:4], src_mask=a[4], ref_mask=a[5]))
    table = {}
    for b in batches:
        ns = 2
        out = fwd(*(jnp.asarray(x) for x in (b["images"][:, :ns], b["images"][:, ns:], b["smpls"][:, :ns],
                                              b["smpls"][:, ns:], b["masks"][:, :ns], b["masks"][:, ns:])))
        assert out["Ttt"] is None
        row = {k: np.asarray(out[k]) for k in _COMP_KEYS}
        row["j2d"] = np.asarray(out["ref_info"]["j2d"])
        table[np.ascontiguousarray(b["smpls"], np.float32).tobytes()] = row
    return table


def _key(src_smpl, ref_smpl) -> bytes:
    return np.ascontiguousarray(np.concatenate([np.asarray(src_smpl), np.asarray(ref_smpl)], axis=1),
                                np.float32).tobytes()


def _same_geometry(mp, table):
    """Within the patch both services take the tabled composition of their
    batch (through a host callback inside JAX's jitted step) instead of
    composing their own: the two packages' steps are held against each other
    on identical inputs, as in `test_torch_trainer.py` (each package's own
    composition differs by an ulp of a vertex, which the L1 losses turn into
    gradient differences of ~1 %)."""
    from ipercore_tpu.models import flow_composition as jfc
    from ipercore_tpu_torch.models import flow_composition as tfc

    spec = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in next(iter(table.values())).items()}

    def unpack(row, wrap):
        out = {k: wrap(row[k]) for k in _COMP_KEYS}
        out.update(Ttt=None, ref_info={"j2d": wrap(row["j2d"])})
        return out

    def jforward(comp, src_img, ref_img, src_smpl, ref_smpl, **kw):
        row = jax.pure_callback(lambda a, b: table[_key(a, b)], spec, src_smpl, ref_smpl)
        return unpack(row, lambda x: x)

    def tforward(comp, src_img, ref_img, src_smpl, ref_smpl, **kw):
        return unpack(table[_key(src_smpl.cpu(), ref_smpl.cpu())], lambda x: torch.tensor(np.array(x)))

    mp.setattr(jfc, "forward", jforward)
    mp.setattr(tfc, "forward", tforward)


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    """Both packages' `train(opt, max_iters=2)` from one
    `net_iter_0_id_{G,D}.npz` (no optimizer files, so both start with fresh
    Adam states), one VGG11 weight file, one dataset of two videos with a
    `train.txt` and a `val.txt`, on one composition per batch. JAX runs on
    one device (its mesh factory is replaced for this fixture only)."""
    from ipercore_tpu_torch.data import build_dataset

    base = tmp_path_factory.mktemp("train_service")
    data = base / "data"
    write_train_video(str(data), "v0", 5, seed=31, mask_size=S, background=True)
    write_train_video(str(data), "v1", 4, seed=32, mask_size=48)
    (data / "train.txt").write_text("v0\nv1\n")
    (data / "val.txt").write_text("v1\n")
    vgg = TC.build_vgg("VGG11", device="cpu")
    vgg_path = str(base / "vgg11.npz")
    tckpt.save_params(vgg_path, tckpt.seeded_flat_params(vgg, 7))
    gen = tbuild_gen("AttLWB-SPADE", NARROW_CFG, device="cpu")
    dis = tbuild_dis("patch_global", DIS_CFG, device="cpu")
    start = {"G": tckpt.seeded_flat_params(NARROW_CFG, 5), "D": tckpt.seeded_flat_params(dis, 6)}
    for name in ("jax", "port"):
        ckpt = base / name / "models" / "m"
        ckpt.mkdir(parents=True)
        for net, flat in start.items():
            tckpt.save_params(str(ckpt / f"net_iter_0_id_{net}.npz"), flat)
    opts = {"jax": _opt(jopts, base / "jax", data, vgg_path), "port": _opt(topts, base / "port", data, vgg_path)}
    # the batches both services draw: ITERS train batches (seed 0), one
    # validation batch an iteration (seed 7)
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
    return base, out, gen, dis, table, opts["port"]


def _read_log(path):
    import json

    with open(path) as f:
        return [json.loads(l) for l in f]


def _moments(leaves, n_params, b1=0.5, b2=0.999):
    flat = lambda ls: np.concatenate([np.asarray(l, np.float64).ravel() for l in ls])
    return {"mu": flat(leaves[4:4 + n_params]) / (1 - b1),
            "nu": np.sqrt(flat(leaves[4 + n_params:4 + 2 * n_params]) / (1 - b2))}


# (moments within 1e-3 of the largest, parameters within `param_tol`): D's are
# the one-step bars; G's second step takes its gradient at parameters that
# already differ (the first step moves a weight with a near-0 gradient by
# +-lr either way), so its bars are 98 % and a tenth of a step
TWO_STEP_BARS = {"G": (0.98, 1e-5, 0.95), "D": (0.99, 1e-6, 0.97)}


def test_service_checkpoints_match_jax(service):
    base, _, gen, dis, _, _ = service
    lr = 1e-4
    dirs = {k: base / k / "models" / "m" for k in ("jax", "port")}
    files = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
    assert files["jax"] == files["port"]
    for net in ("G", "D"):
        within_max, param_tol, param_frac = TWO_STEP_BARS[net]
        assert f"opt_iter_{ITERS}_id_{net}.npz" in files["port"]
        p = {k: tckpt.load_flat_npz(str(d / f"net_iter_{ITERS}_id_{net}.npz")) for k, d in dirs.items()}
        assert p["jax"].keys() == p["port"].keys()
        cat = lambda d: np.concatenate([np.asarray(d[k], np.float64).ravel() for k in sorted(d)])
        dp = np.abs(cat(p["port"]) - cat(p["jax"]))
        assert dp.max() <= 2 * lr * ITERS * 1.001, (net, dp.max())
        assert (dp <= param_tol).mean() >= param_frac, (net, (dp <= param_tol).mean())
        leaves = {k: tckpt.load_leaves(str(d / f"opt_iter_{ITERS}_id_{net}.npz")) for k, d in dirs.items()}
        assert [l.dtype for l in leaves["port"]] == [l.dtype for l in leaves["jax"]]
        assert [int(l) for l in leaves["port"][:4]] == [int(l) for l in leaves["jax"][:4]] == [0, 1, 0, ITERS]
        n_p = (len(leaves["jax"]) - 4) // 2
        got, want = _moments(leaves["port"], n_p), _moments(leaves["jax"], n_p)
        for what in ("mu", "nu"):
            a, b = got[what], want[what]
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            frac = (np.abs(a - b) <= 1e-3 * np.abs(b).max()).mean()
            assert rel <= 2e-2 and frac >= within_max, (net, what, rel, frac)


def test_service_logs_match_jax(service):
    """Both logs hold a row an iteration (print_freq_s 0) with the same keys,
    the val_g_* ones included; the first step's losses within 1e-4 relative,
    the rest (after updates) within 1e-3; both return the last step's
    metrics."""
    base, out, _, _, _, _ = service
    logs = {k: _read_log(base / k / "models" / "m" / "train_log.jsonl") for k in ("jax", "port")}
    assert [sorted(r) for r in logs["port"]] == [sorted(r) for r in logs["jax"]]
    assert [r["step"] for r in logs["port"]] == list(range(ITERS))
    assert {"g_total", "d_total", "val_g_total", "val_g_rec"} <= set(logs["port"][0])
    for i, (a, b) in enumerate(zip(logs["port"], logs["jax"])):
        for k in b:
            if k not in ("t", "step"):
                # the first step's losses come from one state; every other value
                # from parameters that the updates already moved apart
                rtol = 1e-4 if i == 0 and not k.startswith("val_") else 1e-3
                np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-6, err_msg=f"{i} {k}")
    assert out["port"].keys() == out["jax"].keys()


def test_resume_repeats_the_saved_index_and_replays_the_data(service, tmp_path):
    """Both packages save at loop index i (save_latest_freq_s 0) the state
    after step i as `net_iter_<i>` (Adam count i + 1), so the final file at
    `total` repeats the one at `total - 1`, and their loaders set the step to
    i. A resumed port run restores exactly what was saved, runs index i again
    on the data from the start of the stream, and writes `net_iter_<total>`."""
    base, _, gen, dis, table, opt = service
    for pkg in ("jax", "port"):
        d = base / pkg / "models" / "m"
        for net in ("G", "D"):
            for kind in ("net", "opt"):
                a = tckpt.load_leaves(str(d / f"{kind}_iter_{ITERS - 1}_id_{net}.npz"))
                b = tckpt.load_leaves(str(d / f"{kind}_iter_{ITERS}_id_{net}.npz"))
                assert all(np.array_equal(x, y) for x, y in zip(a, b)), (pkg, kind, net)
            leaves = tckpt.load_leaves(str(d / f"opt_iter_{ITERS - 1}_id_{net}.npz"))
            assert int(leaves[3]) == ITERS  # the Adam count after index ITERS - 1
    jlike = _jax_state(gen, dis, JT.TrainConfig(), fresh=True)
    assert int(jckpt.load_train_ckpt(str(base / "jax" / "models" / "m"), ITERS, jlike).step) == ITERS

    out_dir = tmp_path / "resume"
    shutil.copytree(base / "port", out_dir)
    os.remove(out_dir / "models" / "m" / "train_log.jsonl")
    opt = topts.AttrDict(opt, output_dir=str(out_dir))
    seen, loaded = [], []
    real_prefetch, real_load = ttrain.prefetch, ttrain.load_train_ckpt

    def recording_prefetch(it, depth=2):
        for b in real_prefetch(it, depth):
            seen.append(b)
            yield b

    def recording_load(*a, **k):
        loaded.append((a[1], real_load(*a, **k)))
        return loaded[-1][1]

    with pytest.MonkeyPatch.context() as mp:
        _same_geometry(mp, table)
        mp.setattr(ttrain, "prefetch", recording_prefetch)
        mp.setattr(ttrain, "load_train_ckpt", recording_load)
        ttrain.train(opt, max_iters=ITERS + 1, device="cpu")
    d, src = out_dir / "models" / "m", base / "port" / "models" / "m"
    (step, state), = loaded
    assert step == ITERS and int(state.step) == ITERS
    for net, module, params, adam in (("G", gen, state.params_G, state.opt_G), ("D", dis, state.params_D, state.opt_D)):
        want = tckpt.load_flat_npz(str(src / f"net_iter_{ITERS}_id_{net}.npz"))
        got = tckpt.torch_params_to_flax(module, params)
        assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
        saved = tckpt.load_leaves(str(src / f"opt_iter_{ITERS}_id_{net}.npz"))
        assert all(np.array_equal(a, b) for a, b in zip(tckpt.adam_state_to_leaves(module, adam, False), saved))
    # one iteration (index ITERS) on the first batch of the stream
    assert len(seen) == 1
    first = next(iter(table))
    assert np.ascontiguousarray(seen[0]["smpls"], np.float32).tobytes() == first
    assert [r["step"] for r in _read_log(d / "train_log.jsonl")] == [ITERS]
    assert int(tckpt.load_leaves(str(d / f"opt_iter_{ITERS + 1}_id_G.npz"))[3]) == ITERS + 1
