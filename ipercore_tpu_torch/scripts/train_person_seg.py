"""Train the person segmenter and the matting refiner on procedural SMPL
renders.

Twin of `scripts/train_person_seg.py`. Random SMPL poses, shapes and cameras
are rasterized at twice the scene size by K1 (`rasterizer_cuda.raster_flows`
on the card, its plain version on a CPU tensor), which gives an exact
silhouette and, 2x2-averaged, a soft alpha; the person wears procedural,
photo or garment textures over photo-statistics or studio backgrounds, with a
contact shadow, person-free negatives, person-shaped distractors labeled
background, and the camera-pipeline augmentation. It trains:

  * `PersonSegUNet`: BCE (v7: background pixels x2, boundary band x3) +
    soft dice on the binary mask;
  * `MattingRefiner` (or `GCAMattingRefiner`, `--matting gca`): L1 to the
    soft alpha given RGB + the trimap of `generate_trimap`.

`--pseudo` appends pseudo-labeled real frames to every batch. Checkpoints are
chosen on the annotated real select images where they exist (for `gca`, by
held-out alpha L1). Ships `assets/person_seg.npz` (`matting_gca.npz` for
`gca`), f16, which `tools.mattors.HumanMattor` loads in both packages.

    python -m ipercore_tpu_torch.scripts.train_person_seg [--size 256] [--steps 1500] [--batch 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.models.imitator import reference_precision
from ipercore_tpu_torch.models.mesh import load_assets
from ipercore_tpu_torch.ops import rasterizer as rz
from ipercore_tpu_torch.ops.morphology import dilate, erode
from ipercore_tpu_torch.ops.rasterizer_cuda import raster_flows
from ipercore_tpu_torch.scripts import _common as cm
from ipercore_tpu_torch.scripts import eval_real_photos as real
from ipercore_tpu_torch.tools import synth_data as sd
from ipercore_tpu_torch.tools.mattors import (GCAMattingRefiner, HumanMattor, MattingRefiner, PersonSegUNet,
                                              generate_trimap)
from ipercore_tpu_torch.utils.checkpoint import (WEIGHTS_DIR, flax_params_to_torch, load_flat_npz,
                                                 torch_params_to_flax)


WEIGHTS_NAME = "person_seg.npz"


def render_alpha(draws: sd.Draws, model, assets, batch: int, size: int):
    """B random SMPL scenes -> soft alpha (B, S, S, 1), cond (B, S, S, 3) and
    the face-index map at 2S (B, 2S, 2S) (`render_alpha`, `:102-130`). The
    raster is K1 itself, as the JAX driver calls `rasterize_flows_pallas_csr`."""
    R = size * 2
    theta = torch.cat([draws.uniform((batch, 1), 0.35, 1.6), draws.uniform((batch, 2), -0.5, 0.5),
                       draws.normal((batch, 72)) * 0.25, draws.normal((batch, 10)) * 1.0], dim=-1)
    details = smpl_mod.get_details(model, theta)
    fv = rz.verts_to_faces(rz.project_verts(details["verts"], details["cam"]), model.faces)
    fim, _ = raster_flows(fv.contiguous(), assets.f2uvs[None], R)
    alpha = sd._downsample2((fim >= 0).float()[..., None])
    cond = sd._downsample2(rz.encode_fim(fim, assets.map_fn))
    return alpha, cond, fim


def make_batch(draws: sd.Draws, model, assets, batch: int, size: int, v7: bool = True,
               real_tex: float = 0.0):
    """(img (B, S, S, 3), alpha (B, S, S, 1), hard (B, S, S, 1)): the
    sim2real scene of `make_batch` (`:132-190`), drawing in its order."""
    B, S = batch, size
    alpha, cond, fim = render_alpha(draws, model, assets, B, S)
    bg = sd.synth_background_mix(draws, B, S, real_frac=real_tex)
    tex = sd.person_texture_mix(draws, cond, B, S, real_frac=real_tex)
    if v7:
        studio = sd.synth_background_studio(draws, B, S)
        use_studio = draws.bernoulli(0.4, (B, 1, 1, 1)).float()
        bg = bg * (1 - use_studio) + studio * use_studio
        garm = sd._downsample2(sd.garment_texture(draws, fim, assets.face_parts))
        use_garm = draws.bernoulli(0.5, (B, 1, 1, 1)).float()
        tex = tex * (1 - use_garm) + garm * use_garm
    # person-free hard negatives (12 %): everything is background
    drop = draws.bernoulli(0.12, (B, 1, 1, 1)).float()
    alpha = alpha * (1.0 - drop)
    # contact shadow: the shifted silhouette, 5x5 box-blurred (zero padding)
    sh = torch.roll(alpha, (S // 32, S // 24), dims=(1, 2))
    sh = F.avg_pool2d(sh.permute(0, 3, 1, 2), 5, stride=1, padding=2,
                      count_include_pad=True).permute(0, 2, 3, 1)
    sh_amp = draws.uniform((B, 1, 1, 1), 0.0, 0.5)
    bg = bg - sh_amp * sh * (bg + 1.0) * 0.5
    # a distractor blob labeled background
    blob = (sd.fractal_noise(draws, B, S, 1) > 0.55).float()
    use_blob = draws.bernoulli(0.3, (B, 1, 1, 1)).float()
    blob = blob * use_blob * (1.0 - alpha)
    blob_col = draws.uniform((B, 1, 1, 3), -1, 1)
    bg = bg * (1 - blob) + blob_col * blob
    img = sd.photo_augment(draws, tex * alpha + bg * (1.0 - alpha))
    return img, alpha, (alpha > 0.5).float()


def real_rows(draws: sd.Draws, pseudo, n: int, size: int):
    """n pseudo-labeled real frames: flip, shift, gain, bias (`real_rows`)."""
    idx = draws.randint((n,), 0, pseudo[0].shape[0])
    x, m = pseudo[0][idx], pseudo[1][idx]
    do = draws.bernoulli(0.5, (n,))[:, None, None, None]
    x, m = torch.where(do, x.flip(2), x), torch.where(do, m.flip(2), m)
    shift = draws.randint((n, 2), -size // 10, size // 10 + 1)
    x, m = cm.roll_each(x, shift), cm.roll_each(m, shift)
    gain = draws.uniform((n, 1, 1, 3), 0.75, 1.25)
    bias = draws.uniform((n, 1, 1, 3), -0.12, 0.12)
    return torch.clamp(x * gain + bias, -1, 1), m


def loss_fn(nets, batch, v7: bool = True, matting: str = "plain", w_mat: torch.Tensor | None = None):
    """bce + dice + 2 * alpha L1 (`loss_fn`, `:260-296`): (loss, {bce, dice,
    alpha_l1, iou}). `nets` = (segmenter, refiner); `w_mat` weights each
    row's matting error (0 on real rows)."""
    seg, mat = nets
    img, alpha, hard = batch
    logits = seg(img)
    if v7:  # background pixels cost 2x, the silhouette's boundary band 3x
        band = dilate(hard, 5) - erode(hard, 5)
        w = 1.0 + 1.0 * (1.0 - hard) + 2.0 * band
        bce = torch.mean(w * cm.sigmoid_binary_cross_entropy(logits, hard)) / torch.mean(w)
    else:
        bce = torch.mean(cm.sigmoid_binary_cross_entropy(logits, hard))
    p = torch.sigmoid(logits)
    inter = torch.sum(p * hard, dim=(1, 2, 3))
    dice = 1.0 - torch.mean((2 * inter + 1.0) / (p.sum((1, 2, 3)) + hard.sum((1, 2, 3)) + 1.0))
    trimap = generate_trimap(hard)
    a_pred = mat(torch.cat([img, trimap], dim=-1))
    wm = (torch.ones((img.shape[0],), device=img.device)
          if w_mat is None or w_mat.shape[0] != img.shape[0] else w_mat)
    wm4 = wm[:, None, None, None]
    if matting == "gca":  # the error over the unknown band only
        band = ((trimap > 0.25) & (trimap < 0.75)).to(a_pred.dtype)
        l1 = torch.sum(torch.abs(a_pred - alpha) * band * wm4) / torch.clamp_min(torch.sum(band * wm4), 1.0)
    else:
        l1 = (torch.sum(torch.abs(a_pred - alpha) * wm4)
              / torch.clamp_min(torch.sum(wm4) * alpha.shape[1] * alpha.shape[2], 1.0))
    iou = torch.mean(inter / (torch.maximum((p > 0.5).float(), (hard > 0.5).float()).sum((1, 2, 3)) + 1.0))
    aux = {"bce": bce, "dice": dice, "alpha_l1": l1, "iou": iou}
    return bce + dice + 2.0 * l1, {k: v.detach() for k, v in aux.items()}


class Nets(torch.nn.Module):
    """The two trained networks under the weight file's tree names."""

    def __init__(self, matting: str = "plain"):
        super().__init__()
        self.seg = PersonSegUNet()
        self.mat = GCAMattingRefiner() if matting == "gca" else MattingRefiner()

    def pair(self):
        return self.seg, self.mat


def train_step(nets: Nets, tx, opt_state, batch, v7: bool = True, matting: str = "plain", w_mat=None):
    with reference_precision():
        loss, aux = loss_fn(nets.pair(), batch, v7, matting, w_mat)
        opt_state = cm.update(nets, tx, opt_state, loss)
    return opt_state, loss.detach(), aux


def build(device, matting: str = "plain", resume: str | None = None) -> Nets:
    nets = Nets(matting)
    cm.seeded(nets.seg, cm.SEEDS["person_seg"])
    cm.seeded(nets.mat, cm.SEEDS["matting"])
    if resume:
        nets.load_state_dict(state_of(nets, load_flat_npz(resume)), strict=True)
        print(f"resumed from {resume}", flush=True)
    return nets.to(device)


def state_of(nets: Nets, flat: dict) -> dict:
    """A flat `seg/params/...`, `mat/params/...` dict as `nets`' state dict
    (f32), strictly."""
    out = {}
    for name, net in (("seg", nets.seg), ("mat", nets.mat)):
        tree = {k.partition("/")[2]: np.asarray(v, np.float32) for k, v in flat.items() if k.startswith(name + "/")}
        out.update({f"{name}.{k}": v for k, v in flax_params_to_torch(tree, like=net.state_dict()).items()})
    return out


def save(path: str, nets: Nets) -> str:
    """Both trees, `seg/params/...` and `mat/params/...`, f16."""
    flat = {f"{name}/{k}": v for name, net in (("seg", nets.seg), ("mat", nets.mat))
            for k, v in torch_params_to_flax(net).items()}
    return cm.save_f16(path, flat)


def consumer(path: str, device) -> HumanMattor:
    """The shipped file in its consumer: `HumanMattor` (no GCA file beside
    it), both trees, strictly."""
    mattor = HumanMattor(weights_path=path, gca_weights_path=path + ".no-gca", device=device)
    assert mattor.trained and isinstance(mattor.mat, MattingRefiner), path
    return mattor


def _resized(path: str, size: int, device) -> np.ndarray:
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"), np.float32) / 127.5 - 1.0
    return resize_linear(torch.as_tensor(arr[None], device=device), (1, size, size, 3))[0].cpu().numpy()


def probe_images(size: int, device) -> list:
    """(image at size², box in pixels) of each select image on disk, or []."""
    def load():
        return [(_resized(path, size, device), (np.asarray(frac) * size).astype(int))
                for _name, (path, frac) in real.select_gt().items() if os.path.exists(path)]

    return real.probes_or_none(load)


def probe_mask(size: int, device):
    """(image, mask) of the select image with a traced silhouette, or None."""
    try:
        reg = json.load(open(real.GT_PATH))["images"]
        e, gt_sel = reg.get("akun_0060", {}), real.load_gt(roles=("select",))
        if "mask_poly" in e and "akun_0060" in gt_sel and os.path.exists(gt_sel["akun_0060"][0]):
            return (_resized(gt_sel["akun_0060"][0], size, device),
                    real.rasterize_poly(e["mask_poly"], size) > 0.5)
    except Exception as exc:  # a missing frame or PIL: no mask probe, as in the JAX driver
        print(f"mask probe unavailable: {exc}", flush=True)
    return None


def seg_prob(seg, img: np.ndarray, device) -> np.ndarray:
    with torch.no_grad(), reference_precision():
        return torch.sigmoid(seg(torch.as_tensor(img[None], device=device)))[0, ..., 0].cpu().numpy()


def probe_score(nets: Nets, images: list, mask, v7: bool, device) -> float:
    """Checkpoint score on the select images: v7 the mean of the component
    box IoU and a quarter of (coverage - 2 fp); v6 coverage - 2 fp; plus the
    mask IoU where a traced silhouette exists (`probe`, `:380-430`)."""
    from ipercore_tpu_torch.tools.detection import _iou, _merge_aligned_components, person_components

    if not images:
        return 0.0
    qs = []
    for small, g in images:
        prob = seg_prob(nets.seg, small, device)
        m = prob > 0.5
        inside = m[g[1]:g[3], g[0]:g[2]]
        fp = (m.sum() - inside.sum()) / max(m.size - inside.size, 1)
        q = float(inside.mean()) - 2.0 * float(fp)
        if v7:
            cb, cs = person_components(prob, min_area=32)
            iou = _iou(_merge_aligned_components(cb, cs), np.asarray(g, np.float32)) if len(cb) else 0.0
            q = iou + 0.25 * q
        qs.append(q)
    score = float(np.mean(qs))
    if mask is not None:
        m = seg_prob(nets.seg, mask[0], device) > 0.5
        score += float((m & mask[1]).sum() / max((m | mask[1]).sum(), 1))
    return score


def load_pseudo(path: str, size: int, device):
    with np.load(path, allow_pickle=True) as d:
        imgs = torch.as_tensor(np.asarray(d["imgs"], np.float32), device=device)
        masks = torch.as_tensor(np.asarray(d["masks"], np.float32), device=device)[..., None]
    if imgs.shape[1] != size:
        imgs = resize_linear(imgs, (imgs.shape[0], size, size, 3))
        masks = (resize_linear(masks, (masks.shape[0], size, size, 1)) > 0.5).float()
    return imgs, masks


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--out", type=str, default=os.path.join(WEIGHTS_DIR, WEIGHTS_NAME))
    ap.add_argument("--smoke", action="store_true", help="tiny run (CI)")
    ap.add_argument("--matting", choices=("plain", "gca"), default="plain",
                    help="alpha refiner: plain UNet or GCAMattingRefiner (saved to matting_gca.npz)")
    ap.add_argument("--save_every", type=int, default=200, help="checkpoint cadence in steps (0: at the end)")
    ap.add_argument("--real_tex", type=float, default=0.0,
                    help="fraction of real-photo texture crops in backgrounds and person textures")
    ap.add_argument("--recipe", choices=("v6", "v7"), default="v7")
    ap.add_argument("--pseudo", type=str, default="", help="npz of pseudo-labeled real (img, mask) frames")
    ap.add_argument("--real_frac", type=float, default=0.375,
                    help="real rows appended per batch = real_frac * batch")
    ap.add_argument("--resume", action="store_true", help="initialize from an existing --out checkpoint")
    ap.add_argument("--real_photo", type=str, default="",
                    help="a real still to report the promoted segmenter's mask on (optional)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = cm.resolve_device(args.device)
    if args.smoke:
        args.size, args.steps, args.batch = 64, 8, 2
        model = smpl_mod.synthetic_model(nu=16, nv=14, device=device)
        assets = load_assets(model, device=device, synthetic=True)
    else:
        model = smpl_mod.template_model(device=device)
        assets = load_assets(model, device=device)
    if args.matting == "gca" and args.out.endswith(WEIGHTS_NAME):
        args.out = os.path.join(WEIGHTS_DIR, "matting_gca.npz")
    args.out = cm.smoke_out(args.out, args.smoke)
    S, B, v7 = args.size, args.batch, args.recipe == "v7"

    def synth(draws):
        return make_batch(draws, model, assets, B, S, v7, args.real_tex)

    pseudo, w_mat, n_real = None, None, 0
    if args.pseudo and not args.smoke:
        pseudo = load_pseudo(args.pseudo, S, device)
        n_real = max(int(round(args.real_frac * B)), 1)
        w_mat = torch.cat([torch.ones((B,)), torch.zeros((n_real,))]).to(device)
        print(f"pseudo pool: {pseudo[0].shape[0]} real frames; {B} synth + {n_real} real per batch", flush=True)

    def batch_of(draws):
        img, alpha, hard = synth(draws)
        if pseudo is None:
            return img, alpha, hard
        xr, mr = real_rows(draws, pseudo, n_real, S)
        return torch.cat([img, xr]), torch.cat([alpha, mr]), torch.cat([hard, mr])

    nets = build(device, args.matting, args.out if args.resume and os.path.exists(args.out) else None)
    tx = cm.adam(args.lr)
    opt = cm.init_state(tx, nets)

    images, mask = ([], None) if args.smoke else (probe_images(S, device), None)
    if not args.smoke and pseudo is not None:
        mask = probe_mask(S, device)
    if args.matting == "gca":  # the refiner ships: select by held-out alpha L1
        ev = synth(sd.Draws(torch.Generator(device=device).manual_seed(777), device))
        ev_tri = generate_trimap(ev[2])

        def probe(nets):
            with torch.no_grad(), reference_precision():
                a = nets.mat(torch.cat([ev[0], ev_tri], -1))
            return -float(torch.mean(torch.abs(a - ev[1])))
    else:
        probe = lambda nets: probe_score(nets, images, mask, v7, device)  # noqa: E731

    draws = sd.Draws(torch.Generator(device=device).manual_seed(42), device)
    t0 = time.perf_counter()
    best_q, best_step = -np.inf, -1
    for step in range(args.steps):
        opt, loss, aux = train_step(nets, tx, opt, batch_of(draws), v7, args.matting, w_mat)
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            cm.log({"step": step, "loss": loss, **aux})
        if args.save_every and step and step % args.save_every == 0:
            q = probe(nets)
            if q >= best_q:
                best_q, best_step = q, step
                save(args.out, nets)
            cm.log({"step": step, "real_probe": q, "best_step": best_step})

    img, alpha, hard = synth(sd.Draws(torch.Generator(device=device).manual_seed(777), device))
    with torch.no_grad(), reference_precision():
        _, aux = loss_fn(nets.pair(), (img, alpha, hard), v7, args.matting)
        sad = float(torch.abs(nets.mat(torch.cat([img, generate_trimap(hard)], -1)) - alpha).sum()) / 1e3
    result = {"metric": "person_seg_synthetic_holdout", "matting": args.matting,
              "iou": round(float(aux["iou"]), 4), "alpha_l1": round(float(aux["alpha_l1"]), 4),
              "alpha_sad_k": round(sad, 2), "steps": args.steps, "size": S,
              "train_s": round(time.perf_counter() - t0, 1)}
    q_final = probe(nets)
    if not images or q_final >= best_q:
        best_q, best_step = q_final, args.steps - 1
        save(args.out, nets)
    result.update(real_probe_best=round(float(best_q), 4), best_step=best_step)

    if args.real_photo and os.path.exists(args.real_photo) and not args.smoke:
        from ipercore_tpu_torch.tools.detection import _clean, mask_is_compact

        promoted = build(device, args.matting, args.out)
        m = _clean(seg_prob(promoted.seg, _resized(args.real_photo, S, device), device) > 0.5)
        result.update(real_photo_mask_frac=round(float(m.mean()), 4), real_photo_compact=bool(mask_is_compact(m)))
    result["out"] = args.out
    cm.log(result)
    return result


if __name__ == "__main__":
    main()
