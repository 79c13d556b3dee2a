"""The personalization train step in plain PyTorch: one update of the
generator and one of the discriminator, as iPERCore v0.2.0's LWG trainer
makes it with the published `Train` defaults.

  * the composition of the batch (sources with their person masks, the
    target's raster, the UV-warped target input, the source-to-target flows
    at full size) takes no gradient;
  * G's loss: 10 * (L1 of the sources' reconstruction + L1 of the background)
    / 2, 10 * VGG19 perceptual, 5 * Sphere20a on the head crops, LSGAN with
    target 0 under the discriminator's parameters before this step, 5 * mask
    BCE over sources and targets, 1 * total variation of the masks;
  * D's loss on G's output of this step, detached: LSGAN real = 1, fake = -1;
  * each optimizer: clip to global norm 10, Adam (b1 0.5, b2 0.999, eps 1e-8,
    lr 1e-4), a step with a gradient that is not finite skipped.

Gradients come from `torch.autograd` on the modules' own parameters, and the
update is written leaf by leaf.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import geometry as g
from portbench.reference import losses as L
from portbench.reference.generator import grid_sample
from portbench.reference.imitate import source_inputs

NECK = 12  # cocoplus joints from 12 on are the neck and the head


def compose(comp, images, smpls, masks, ns: int) -> dict:
    """Generator inputs of a batch of one row: images (1, ns + nt, S, S, 3),
    smpls (1, ns + nt, 85), masks (1, ns + nt, S, S, 1) with background 1."""
    S = comp.size
    nt = images.shape[1] - ns
    src = source_inputs(comp, images[:, :ns], smpls[0, :ns], masks[0, :ns])
    theta = smpls[0, ns:]
    verts = g.verts_of(comp.body, theta)
    fv = g.project(verts, theta[:, 0:3])[:, comp.body.faces]
    fim, wim = g.rasterize_batch(fv, S)
    cond = g.encode_fim(fim, comp.map_fn)
    uv_flow = g.bc_flow(comp.f2uvs.expand((nt,) + tuple(comp.f2uvs.shape)), fim, wim)
    syn = grid_sample(src["uv_img"].expand(nt, S, S, 3), uv_flow)
    tsf_in = torch.cat([syn, cond], dim=-1)[None]
    F_ = src["f2pts"].shape[1]
    src_rep = src["f2pts"][None].expand(nt, ns, F_, 3, 2).reshape(nt * ns, F_, 3, 2)
    Tst = g.bc_flow(src_rep, fim[:, None].expand(nt, ns, S, S).reshape(nt * ns, S, S),
                    wim[:, None].expand(nt, ns, S, S, 3).reshape(nt * ns, S, S, 3))
    j3d = torch.einsum("kv,nvd->nkd", comp.body.joint_regressor, verts)
    j2d = theta[:, None, 0:1] * (j3d[..., 0:2] + theta[:, None, 1:3])
    head = j2d[:, NECK:]
    box = torch.stack([head[..., 0].amin(1) - 0.1, head[..., 1].amin(1) - 0.1,
                       head[..., 0].amax(1) + 0.1, head[..., 1].amax(1) + 0.1], 1).clamp(-1.0, 1.0)
    return {"bg_in": src["bg_in"], "src_in": src["src_in"], "tsf_in": tsf_in,
            "Tst": Tst.reshape(1, nt, ns, S, S, 2), "head_box": box}


class Adam:
    """Clip to global norm, Adam, skip a step whose gradient is not finite."""

    def __init__(self, params: list, lr=1e-4, b1=0.5, b2=0.999, eps=1e-8, clip=10.0):
        self.params, self.lr, self.b1, self.b2, self.eps, self.clip = params, lr, b1, b2, eps, clip
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list) -> list:
        """Update the parameters in place; returns the gradients after the clip."""
        if not all(bool(torch.isfinite(x).all()) for x in grads):
            return grads
        norm = math.sqrt(sum(float(torch.sum(x.double() ** 2)) for x in grads))
        if norm >= self.clip:
            grads = [x * (self.clip / norm) for x in grads]
        self.count += 1
        for p, x, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(x, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(x * x, alpha=1 - self.b2)
            mu_hat = mu / (1 - self.b1 ** self.count)
            nu_hat = nu / (1 - self.b2 ** self.count)
            p.add_(mu_hat / (nu_hat.sqrt() + self.eps), alpha=-self.lr)
        return grads


class Trainer:
    """The networks (reference modules holding the weights) and their optimizers."""

    def __init__(self, comp, gen, dis, vgg, face, train: dict, ns: int):
        self.comp, self.gen, self.dis, self.vgg, self.face = comp, gen, dis, vgg, face
        self.t, self.ns = train, ns
        self.g_params = list(gen.parameters())
        self.d_params = list(dis.parameters())
        self.opt_g = Adam(self.g_params, lr=train["lr_G"])
        self.opt_d = Adam(self.d_params, lr=train["lr_D"])

    def step(self, batch: dict) -> dict:
        """One update; returns the losses and each network's clipped gradients."""
        t, ns, S = self.t, self.ns, self.comp.size
        images, masks = batch["images"], batch["masks"]
        with torch.no_grad():
            c = compose(self.comp, images, batch["smpls"], masks, ns)
        src_img, real = images[:, :ns], images[0, ns:]
        nt = real.shape[0]
        cond = c["tsf_in"][0, ..., 3:6]

        bg, src_color, src_mask, tsf_color, tsf_mask = self.gen.forward_train(
            c["bg_in"], c["src_in"], c["tsf_in"], c["Tst"])
        bg1 = bg[:, 0:1]
        fake = (tsf_mask * bg1 + (1.0 - tsf_mask) * tsf_color).reshape(nt, S, S, 3)
        src_fake = src_mask * bg1 + (1.0 - src_mask) * src_color
        rec = (L.l1(src_fake, src_img) + L.l1(bg1[:, 0], batch["bg"])) / 2.0 * t["lambda_rec"]
        all_masks = torch.cat([src_mask, tsf_mask], dim=1).reshape(-1, S, S, 1)
        mask = L.mask_bce(all_masks, masks.reshape(-1, S, S, 1)) * t["lambda_mask"]
        adv = L.lsgan(self.dis(torch.cat([fake, cond], dim=-1)), 0.0) * t["lambda_D_prob"]
        tsf = L.perceptual(self.vgg, fake, real) * t["lambda_tsf"]
        face = L.face(self.face, fake, real, c["head_box"]) * t["lambda_face"]
        smooth = L.tv(all_masks) * t["lambda_mask_smooth"]
        g_total = rec + tsf + face + adv + mask + smooth
        g_grads = self.opt_g.step(list(torch.autograd.grad(g_total, self.g_params)))

        fake = fake.detach()
        d_total = (L.lsgan(self.dis(torch.cat([real, cond], dim=-1)), 1.0)
                   + L.lsgan(self.dis(torch.cat([fake, cond], dim=-1)), -1.0))
        d_grads = self.opt_d.step(list(torch.autograd.grad(d_total, self.d_params)))
        return {"g_total": float(g_total.detach()), "d_total": float(d_total.detach()),
                "g_grads": g_grads, "d_grads": d_grads}
