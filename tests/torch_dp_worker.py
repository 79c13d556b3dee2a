"""One rank of the two-rank gloo run of `tests/test_torch_data_parallel.py`
(holds no test).

    RANK=r WORLD_SIZE=2 python -m tests.torch_dp_worker <work dir>

Joins the group through a `file://` store in the work dir, runs the port's
data-parallel step on its row of the global batch and `train(max_iters=2)` at
bs 1 a rank on the dataset under `<work dir>/data`; rank 0 writes the stepped
state (`step/`, as a train checkpoint, and `step/metrics.npz`) and the
service's checkpoints (`train/`). The same rig, batch and options serve the
one-process runs of the test.
"""
import os
import sys

import numpy as np
import torch

S = 64
NS, NT = 2, 1
THREADS = 2  # torch threads of each rank, and of the test's one-process runs
CFG = {
    "BGNet": {"num_filters": [8, 16, 16, 32], "n_res_block": 1},
    "SIDNet": {"num_filters": [8, 16, 32], "n_res_block": 1},
    "TSFNet": {"num_filters": [8, 16, 32], "n_res_block": 1},
}
DIS_CFG = {"ndf": 8, "n_layers": 2, "max_nf_mult": 8, "use_sigmoid": False}
NARROW_VGG = ((4,), (8,), (8,), (8,), (8,))


def compose_per_sample():
    """Make `flow_composition.forward` compose each sample of a batch alone
    and concatenate (returns the original to restore). The LBS rounds a
    vertex by an ulp differently at another batch size, which can move a
    silhouette pixel; composing sample by sample gives the ranks (bs 1) and
    the one process (bs 2) the same geometry, so the comparison sees only the
    data-parallel reduction."""
    from ipercore_tpu_torch.models import flow_composition as fc

    real = fc.forward

    def forward(comp, src_img, ref_img, src_smpl, ref_smpl, src_mask=None, ref_mask=None, **kw):
        rows = [real(comp, src_img[i:i + 1], ref_img[i:i + 1], src_smpl[i:i + 1], ref_smpl[i:i + 1],
                     src_mask=None if src_mask is None else src_mask[i:i + 1],
                     ref_mask=None if ref_mask is None else ref_mask[i:i + 1], **kw)
                for i in range(src_img.shape[0])]
        out = {k: torch.cat([r[k] for r in rows]) for k in ("input_G_bg", "input_G_src", "input_G_tsf", "Tst")}
        out["Ttt"] = None if rows[0]["Ttt"] is None else torch.cat([r["Ttt"] for r in rows])
        out["ref_info"] = {"j2d": torch.cat([r["ref_info"]["j2d"] for r in rows])}
        return out

    fc.forward = forward
    return real


def rig():
    """(comp, generator, discriminator, vgg, cfg): seeded, narrow, 64²."""
    from ipercore_tpu_torch.models import flow_composition as fc
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import load_assets
    from ipercore_tpu_torch.models.networks import build_discriminator, build_generator
    from ipercore_tpu_torch.models.networks import criterions as C
    from ipercore_tpu_torch.trainers import lwg_trainer as T
    from ipercore_tpu_torch.utils.checkpoint import load_generator_params, seeded_flat_params

    model = smpl_mod.synthetic_model(nu=20, nv=18, device="cpu")
    comp = fc.make_composer(model, load_assets(model, device="cpu", synthetic=True), image_size=S,
                            out_dilate_ks=5)
    gen = build_generator("AttLWB-SPADE", CFG, device="cpu")
    load_generator_params(gen, seeded_flat_params(CFG, 0))
    dis = build_discriminator("patch_global", DIS_CFG, device="cpu")
    load_generator_params(dis, seeded_flat_params(dis, 1))
    vgg = C.VGGFeatures(slices=NARROW_VGG).eval().requires_grad_(False)
    load_generator_params(vgg, seeded_flat_params(vgg, 2))
    return comp, gen, dis, vgg, T.TrainConfig(use_face=False)


def global_batch() -> dict:
    """The global batch of 2 (numpy, from a seed)."""
    rng = np.random.RandomState(0)
    smpls = np.zeros((2, NS + NT, 85), np.float32)
    smpls[:, :, 0] = 1.2
    smpls[:, :, 3:75] = rng.randn(2, NS + NT, 72) * 0.1
    return {"images": rng.uniform(-1, 1, (2, NS + NT, S, S, 3)).astype(np.float32), "smpls": smpls,
            "masks": (rng.rand(2, NS + NT, S, S, 1) > 0.6).astype(np.float32),
            "bg": rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)}


def train_opt(out_dir: str, data_dir: str, batch_size: int):
    from ipercore_tpu_torch.services import options

    opt = options.setup(None, [])
    opt.update(image_size=S, num_source=NS, time_step=NT, batch_size=batch_size, output_dir=out_dir,
               model_id="m", out_dilate_ks=5, smoke_model=True, Generator=CFG, dataset_dirs=[data_dir])
    opt.Discriminator.update(DIS_CFG)
    opt.Train.update(use_face=False, face_loss_path="random", use_vgg="VGG11", print_freq_s=0.0,
                     display_freq_s=0.0, save_latest_freq_s=1e9)
    return opt


def main(work: str) -> None:
    from ipercore_tpu_torch.parallel import mesh
    from ipercore_tpu_torch.services.train import train
    from ipercore_tpu_torch.trainers import lwg_trainer as T
    from ipercore_tpu_torch.utils.checkpoint import save_train_ckpt

    torch.set_num_threads(THREADS)
    compose_per_sample()
    device = mesh.init_data_parallel("cpu", init_method="file://" + os.path.join(work, "store"))
    r = mesh.rank()
    assert mesh.world_size() == 2 and device.type == "cpu"
    comp, gen, dis, vgg, cfg = rig()
    batch = {k: torch.as_tensor(v[r:r + 1]) for k, v in global_batch().items()}
    step = T.make_sharded_train_step(comp, gen, dis, vgg, None, cfg, ns=NS)
    before = mesh.all_reduce_mean.calls
    state, metrics = step(T.create_train_state(gen, dis, cfg), batch)
    calls = mesh.all_reduce_mean.calls - before
    if r == 0:
        save_train_ckpt(os.path.join(work, "step"), 1, state, gen, dis)
        np.savez(os.path.join(work, "step", "metrics.npz"), all_reduce_calls=calls,
                 **{k: v.numpy() for k, v in metrics.items()})
    train(train_opt(os.path.join(work, "train"), os.path.join(work, "data"), 1), max_iters=2, device=device)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
