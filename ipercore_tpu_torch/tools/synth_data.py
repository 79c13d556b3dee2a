"""Procedural supervision scenes for training the perception stack on the GPU.

Twin of `ipercore_tpu/tools/synth_data.py`. Random SMPL pose, shape and camera
rendered through the production rasterizer (K1, `raster_flows`, on a CUDA
tensor) give exact silhouettes, part maps and projected joints; textures are
random colour transforms of the part-condition map, fractal shading, garment
tables or crops of real photographs; backgrounds are procedural (gradients,
checkers, fractal noise, studio walls) or real-photo crops. Every label is
exact by construction:

  * soft alpha + binary mask        -> person segmenter / matting refiner
  * theta (cam, pose, shape) + j2d  -> SPIN regressor
  * Body-25 joints + limb PAFs      -> OpenPose
  * clean background + random holes -> background inpaintor

Randomness. `jax.random`'s counter-based keys cannot be reproduced without
JAX, so every function here takes a `Draws` (a sequential `torch.Generator`
source) where the JAX twin takes a key. It draws once per `jax.random.*` call
of the twin, in the order the twin calls them and with its shapes; a key's
`split` and `fold_in` become nothing, since successive draws of one generator
are independent. Given the same draws, the outputs agree with the JAX twin
(the CPU tests replay JAX's own draws).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ipercore_tpu_torch.data.datasets import resize_linear
from ipercore_tpu_torch.models import smpl as smpl_mod
from ipercore_tpu_torch.ops import rasterizer as rz
from ipercore_tpu_torch.ops.rasterizer_cuda import raster_flows
from ipercore_tpu_torch.ops.rotations import rodrigues, rotmat_to_axis_angle

Device = str | torch.device


class Draws:
    """The random draws of the functions below: uniform, normal, Bernoulli,
    integer and Dirichlet samples from `generator`, returned on `device`. A
    generator on another device than `device` draws there and is copied over;
    a `torch.Generator(device="cuda")` draws on the card directly."""

    def __init__(self, generator: torch.Generator, device: Device = "cuda"):
        self.generator = generator
        self.device = torch.device(device)

    def _here(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device)

    def uniform(self, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, device=self.generator.device)
        return self._here(torch.clamp_min(u * (hi - lo) + lo, lo))

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return self._here(torch.randn(tuple(shape), generator=self.generator,
                                      device=self.generator.device))

    def bernoulli(self, p: float, shape: Sequence[int]) -> torch.Tensor:
        """Bool samples, true with probability p."""
        u = torch.rand(tuple(shape), generator=self.generator, device=self.generator.device)
        return self._here(u < p)

    def randint(self, shape: Sequence[int], lo: int, hi: int) -> torch.Tensor:
        return self._here(torch.randint(lo, hi, tuple(shape), generator=self.generator,
                                        device=self.generator.device))

    def dirichlet(self, alpha: Sequence[float], shape: Sequence[int]) -> torch.Tensor:
        """(*shape, len(alpha)) samples: normalised gamma draws."""
        a = torch.as_tensor(alpha, dtype=torch.float32).to(self.generator.device, non_blocking=True)
        g = torch._standard_gamma(a.expand(tuple(shape) + a.shape), generator=self.generator)
        return self._here(g / g.sum(-1, keepdim=True))


class SceneBatch(NamedTuple):
    """One batch of labeled synthetic scenes (image units: [-1, 1])."""

    img: torch.Tensor     # (B, S, S, 3) composited scene
    alpha: torch.Tensor   # (B, S, S, 1) soft person alpha (supersampled render)
    mask: torch.Tensor    # (B, S, S, 1) binary person mask (alpha > .5)
    bg: torch.Tensor      # (B, S, S, 3) the clean background plate
    theta: torch.Tensor   # (B, 85) cam(3) + pose_aa(72) + shape(10)
    j2d: torch.Tensor     # (B, 19, 2) cocoplus joints, NDC (x right, y down)


# SMPL joint ids (parent-relative axis-angle triplets in pose[3*j : 3*j+3]).
_J_LHIP, _J_RHIP, _J_LKNEE, _J_RKNEE = 1, 2, 4, 5
_J_LANK, _J_RANK, _J_SPINE = 7, 8, (3, 6, 9)
_J_NECK, _J_LCOLL, _J_RCOLL, _J_HEAD = 12, 13, 14, 15
_J_LSH, _J_RSH, _J_LELB, _J_RELB = 16, 17, 18, 19


def _linspace(lo: float, hi: float, n: int, device) -> torch.Tensor:
    """`jnp.linspace(lo, hi, n)` in f32, as the JAX package's CPU build
    computes it: lo * (1 - i*r) + i * (hi*r) for i < d = n - 1 with r = f32(1/d),
    the last product fused into the sum (one rounding), then hi. Bit-equal to
    it for n <= 352; above, XLA's code generation changes and some points
    differ by one ulp (`tests/test_torch_synth_data.py` pins both)."""
    end = torch.full((1,), float(hi), dtype=torch.float32, device=device)
    if n == 1:
        return torch.full((1,), float(lo), dtype=torch.float32, device=device)
    i = torch.arange(n - 1, dtype=torch.float32, device=device)
    r = 1.0 / (n - 1)  # a Python scalar: rounded to f32 in each product
    head = (i.double() * (end * r).double() + (lo * (1 - i * r)).double()).float()
    return torch.cat([head, end])


def _grid(lo: float, hi: float, size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """yy, xx = meshgrid(linspace, linspace, indexing="ij"), each (S, S)."""
    r = _linspace(lo, hi, size, device)
    return torch.meshgrid(r, r, indexing="ij")


def natural_pose(draws: Draws, batch: int) -> torch.Tensor:
    """72-dim SMPL body poses from the hand-built natural-stance prior of the
    JAX twin: arms down (shoulder adduction, L +, R -), jittered elbows, a
    walk / dance swing at the hips and knees, spine and neck sway, and a small
    isotropic floor, in the repository's frame (reference SMPL with y and z
    negated)."""
    pose = 0.06 * draws.normal((batch, 72))

    def setj(p, j, axis, val):
        p = p.clone()
        p[:, 3 * j + axis] = val + p[:, 3 * j + axis]
        return p

    add = draws.uniform((batch, 2), 0.8, 2.3)  # arms down: ~A-pose .. tight at sides
    pose = setj(pose, _J_LSH, 2, add[:, 0])
    pose = setj(pose, _J_RSH, 2, -add[:, 1])
    coll = 0.12 * draws.uniform((batch,))  # one shrug, mirrored
    pose = setj(pose, _J_LCOLL, 2, coll)
    pose = setj(pose, _J_RCOLL, 2, -coll)
    elb = torch.abs(0.45 * draws.normal((batch, 2))) + draws.uniform((batch, 2), 0.0, 0.35)
    pose = setj(pose, _J_LELB, 1, elb[:, 0])
    pose = setj(pose, _J_RELB, 1, -elb[:, 1])
    swing = 0.35 * draws.normal((batch,))
    hip_n = 0.15 * draws.normal((batch, 2))
    pose = setj(pose, _J_LHIP, 0, swing + hip_n[:, 0])
    pose = setj(pose, _J_RHIP, 0, -swing + hip_n[:, 1])
    knee = torch.abs(0.4 * draws.normal((batch, 2)))
    pose = setj(pose, _J_LKNEE, 0, knee[:, 0])
    pose = setj(pose, _J_RKNEE, 0, knee[:, 1])
    ank = 0.15 * draws.normal((batch,))  # both ankles from one draw
    pose = setj(pose, _J_LANK, 0, ank)
    pose = setj(pose, _J_RANK, 0, ank)
    pose = pose.clone()
    for j in _J_SPINE:
        pose[:, 3 * j:3 * j + 3] += 0.07 * draws.normal((batch, 3))
    pose[:, 3 * _J_NECK:3 * _J_NECK + 3] += 0.1 * draws.normal((batch, 3))
    pose[:, 3 * _J_HEAD:3 * _J_HEAD + 3] += 0.1 * draws.normal((batch, 3))
    return pose


def make_theta(draws: Draws, batch: int, pose_std: float = 0.25, yaw: bool = True,
               scale_range=(0.55, 1.6), tx_range=0.5, natural_frac: float = 0.0) -> torch.Tensor:
    """Random plausible SMPL thetas (B, 85): a full random yaw composed with
    a small tilt; `natural_frac` of the poses from `natural_pose`, the rest
    from the isotropic T-pose-centred prior."""
    scale = draws.uniform((batch, 1), scale_range[0], scale_range[1])
    txy = draws.uniform((batch, 2), -tx_range, tx_range)
    pose = draws.normal((batch, 72)) * pose_std
    if natural_frac > 0.0:
        nat = natural_pose(draws, batch)
        use_nat = draws.bernoulli(natural_frac, (batch, 1))
        pose = torch.where(use_nat, nat, pose)
    beta = draws.normal((batch, 10))
    if yaw:
        ang = draws.uniform((batch,), -np.pi, np.pi)
        tilt = draws.normal((batch, 3)) * 0.1
        zero = torch.zeros_like(ang)
        spin = rodrigues(torch.stack([zero, ang, zero], dim=-1))
        wobble = rodrigues(tilt)
        orient = rotmat_to_axis_angle(torch.einsum("bij,bjk->bik", wobble, spin))
        pose = torch.cat([orient, pose[:, 3:]], dim=-1)
    return torch.cat([scale, txy, pose, beta], dim=-1)


def render_fim(model: smpl_mod.SMPLModel, theta: torch.Tensor, size: int,
               f2uvs: torch.Tensor | None = None, details: dict | None = None) -> torch.Tensor:
    """Rasterize thetas to a face-index map (B, size, size) int32 (-1
    background) with K1 (`raster_flows`, one flow set: `f2uvs` or zeros); on
    a CPU tensor its plain version runs."""
    if details is None:
        details = smpl_mod.get_details(model, theta)
    proj = rz.project_verts(details["verts"], details["cam"])
    fv = rz.verts_to_faces(proj, model.faces)
    aux = (f2uvs if f2uvs is not None
           else torch.zeros((model.faces.shape[0], 3, 2), dtype=torch.float32, device=fv.device))
    fim, _ = raster_flows(fv.contiguous(), aux[None], size)
    return fim


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x average pool over (B, H, W, C)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def synth_background(draws: Draws, batch: int, size: int) -> torch.Tensor:
    """Procedural background plates: gradient + checker + noise mix."""
    dev = draws.device
    yy, xx = _grid(-1, 1, size, dev)
    ang = draws.uniform((batch, 1, 1), 0, np.pi)
    g = (torch.cos(ang) * xx[None] + torch.sin(ang) * yy[None])[..., None]
    ca = draws.uniform((batch, 1, 1, 3), -1, 1)
    cb = draws.uniform((batch, 1, 1, 3), -1, 1)
    grad = ca + (cb - ca) * (g * 0.5 + 0.5)
    fx = draws.uniform((batch, 1, 1), 2, 14)
    fy = draws.uniform((batch, 1, 1), 2, 14)
    check = torch.sign(torch.sin(xx[None] * fx * np.pi) * torch.sin(yy[None] * fy * np.pi))[..., None]
    check = check * draws.uniform((batch, 1, 1, 3), -0.8, 0.8)
    noise = draws.uniform((batch, size, size, 3), -1, 1)
    w = draws.dirichlet([1.0, 1.0, 1.0], (batch,))[:, None, None, :]
    bg = w[..., 0:1] * grad + w[..., 1:2] * check + w[..., 2:3] * noise
    return torch.clamp(bg, -1, 1)


def fractal_noise(draws: Draws, batch: int, size: int, channels: int = 3,
                  octaves: int = 5) -> torch.Tensor:
    """Multi-octave value noise in [-1, 1]: random grids of 4, 8, 16, ... cells
    upsampled linearly and summed with weights 1/2^o."""
    out = torch.zeros((batch, size, size, channels), device=draws.device)
    amp_sum = 0.0
    for o in range(octaves):
        res = max(2, 2 ** (o + 2))
        if res > size:
            break
        g = draws.uniform((batch, res, res, channels), -1.0, 1.0)
        up = resize_linear(g, (batch, size, size, channels))
        amp = 1.0 / (2 ** o)
        out = out + amp * up
        amp_sum += amp
    return out / amp_sum


def synth_background_photo(draws: Draws, batch: int, size: int) -> torch.Tensor:
    """Photo-statistics background plates: fractal noise as the scene
    texture, 0-4 clutter rectangles and an illumination gradient; [-1, 1]."""
    dev = draws.device
    base = fractal_noise(draws, batch, size, 3)
    tint = draws.uniform((batch, 1, 1, 3), -0.6, 0.6)
    contrast = draws.uniform((batch, 1, 1, 1), 0.3, 1.0)
    bg = torch.clamp(base * contrast + tint, -1, 1)
    yy, xx = _grid(0, 1, size, dev)
    for _ in range(4):
        c0 = draws.uniform((batch, 2), 0.0, 0.8)
        wh = draws.uniform((batch, 2), 0.05, 0.5)
        col = draws.uniform((batch, 1, 1, 3), -1, 1)
        on = draws.bernoulli(0.5, (batch, 1, 1, 1))
        inside = ((xx[None] >= c0[:, 0, None, None])
                  & (xx[None] <= (c0[:, 0] + wh[:, 0])[:, None, None])
                  & (yy[None] >= c0[:, 1, None, None])
                  & (yy[None] <= (c0[:, 1] + wh[:, 1])[:, None, None]))
        m = inside[..., None].to(bg.dtype) * on
        blend = draws.uniform((batch, 1, 1, 1), 0.4, 1.0)
        bg = bg * (1 - m * blend) + col * m * blend
    ang = draws.uniform((batch, 1, 1), 0, 2 * np.pi)
    g = (torch.cos(ang) * (xx[None] - 0.5) + torch.sin(ang) * (yy[None] - 0.5))[..., None]
    amp = draws.uniform((batch, 1, 1, 1), 0.0, 0.5)
    return torch.clamp(bg + amp * g, -1, 1)


def synth_background_studio(draws: Draws, batch: int, size: int) -> torch.Tensor:
    """Studio / indoor-stage background plates: a near-flat bright wall with
    an illumination gradient, a wall / floor split with planks, 0-2 diagonal
    stripe decals, 0-2 logo glyphs and a vignette; (B, S, S, 3) in [-1, 1]."""
    dev = draws.device
    yy, xx = _grid(0, 1, size, dev)
    wall = draws.uniform((batch, 1, 1, 3), 0.25, 0.95)
    wall = wall + 0.06 * fractal_noise(draws, batch, size, 3)
    ang = draws.uniform((batch, 1, 1), 0, 2 * np.pi)
    g = (torch.cos(ang) * (xx[None] - 0.5) + torch.sin(ang) * (yy[None] - 0.5))[..., None]
    amp = draws.uniform((batch, 1, 1, 1), 0.0, 0.3)
    bg = wall + amp * g

    horizon = draws.uniform((batch, 1, 1), 0.55, 0.95)
    floor_m = (yy[None] > horizon)[..., None].to(bg.dtype)
    fcol = draws.uniform((batch, 1, 1, 3), -0.4, 0.6)
    depth = torch.clamp((yy[None, ..., None] - horizon[..., None]) * 4.0, 0, 1)
    plank_f = draws.uniform((batch, 1, 1), 20.0, 90.0)
    planks = 0.08 * torch.sin(yy[None] * plank_f)[..., None]
    floor = fcol * (0.75 + 0.25 * depth) + planks
    use_floor = draws.bernoulli(0.8, (batch, 1, 1, 1)).to(bg.dtype)
    bg = bg * (1 - floor_m * use_floor) + floor * floor_m * use_floor

    for _ in range(2):  # stripe decals, on the wall only
        a = draws.uniform((batch, 1, 1), 0, np.pi)
        off = draws.uniform((batch, 1, 1), -0.8, 1.2)
        width = draws.uniform((batch, 1, 1), 0.04, 0.22)
        d = torch.cos(a) * xx[None] + torch.sin(a) * yy[None] - off
        band = (torch.abs(d) < width)[..., None].to(bg.dtype)
        col = draws.uniform((batch, 1, 1, 3), -1.0, 1.0)
        on = draws.bernoulli(0.6, (batch, 1, 1, 1)).to(bg.dtype)
        band = band * on * (1 - floor_m * use_floor)
        bg = bg * (1 - band) + col * band

    for _ in range(2):  # logo glyphs in the upper half of the wall
        c = draws.uniform((batch, 2), 0.05, 0.75)
        c = torch.stack([c[:, 0], c[:, 1] * 0.5], dim=1)
        wh = draws.uniform((batch, 2), 0.04, 0.16)
        dx = (xx[None] - c[:, 0, None, None]) / wh[:, 0, None, None]
        dy = (yy[None] - c[:, 1, None, None]) / wh[:, 1, None, None]
        outer = ((torch.abs(dx) < 1.0) & (torch.abs(dy) < 1.0))[..., None]
        inner = ((torch.abs(dx) < 0.6) & (torch.abs(dy) < 0.6))[..., None]
        bars = (torch.sin(dx * 7.0) > 0.2)[..., None] & inner
        col = draws.uniform((batch, 1, 1, 3), -1.0, 0.4)
        on = draws.bernoulli(0.5, (batch, 1, 1, 1)).to(bg.dtype)
        m_out = outer.to(bg.dtype) * on
        bg = bg * (1 - m_out) + col * m_out
        m_bar = bars.to(bg.dtype) * on
        bg = bg * (1 - m_bar) + (-col) * m_bar

    cx = draws.uniform((batch, 1, 1), -0.2, 1.2)
    cy = draws.uniform((batch, 1, 1), -0.2, 0.4)
    ex, ey = xx[None] - cx, yy[None] - cy
    r2 = ex * ex + ey * ey
    vig = torch.exp(-r2 / 0.08)[..., None]
    vamp = draws.uniform((batch, 1, 1, 1), 0.0, 0.9)
    bg = bg - vamp * vig * (bg + 1.0) * 0.5
    return torch.clamp(bg, -1, 1)


# SMPL part label -> garment group: 0 skin (head, facial, hands), 1 top (torso,
# arms), 2 bottom (legs), 3 shoes (feet)
_PART_TO_GARMENT = np.asarray([0, 1, 2, 2, 1, 1, 3, 3, 0, 0, 0], np.int32)


def garment_tables(draws: Draws, batch: int, face_parts: torch.Tensor) -> torch.Tensor:
    """Per-sample garment colour tables for `encode_fim`: a skin tone, muted
    (often dark) top, bottom and shoe colours, short sleeves (arms take the
    skin) and dresses (legs take the top). Returns (B, F+1, 3); the background
    row is black."""
    dev = draws.device
    parts = torch.as_tensor(face_parts, device=dev).long()
    base = draws.uniform((batch, 1), -0.35, 0.75)
    skin = torch.cat([base + 0.18, base, base - 0.12], dim=-1)
    skin = skin + 0.05 * draws.normal((batch, 3))

    def muted(dark_bias):
        hue = draws.uniform((batch, 3), -1.0, 1.0)
        lum = draws.uniform((batch, 1), -0.9, 0.5 - dark_bias)
        sat = draws.uniform((batch, 1), 0.05, 0.45)
        return torch.clamp(lum + sat * hue, -1, 1)

    top, bottom, shoes = muted(0.0), muted(0.0), muted(0.4)
    short_sleeve = draws.bernoulli(0.3, (batch, 1))
    dress = draws.bernoulli(0.15, (batch, 1))
    bottom = torch.where(dress, top, bottom)
    groups = torch.stack([skin, top, bottom, shoes], dim=1)  # (B, 4, 3)
    g_of_face = torch.as_tensor(_PART_TO_GARMENT).to(dev, non_blocking=True).long()[parts]  # (F,)
    tables = groups[:, g_of_face]  # (B, F, 3)
    arm = ((parts == 4) | (parts == 5)).float()[None, :, None]
    tables = torch.where(short_sleeve[:, None].float() * arm > 0, skin[:, None], tables)
    return torch.cat([tables, torch.zeros((batch, 1, 3), device=dev)], dim=1)


def garment_texture(draws: Draws, fim_lo: torch.Tensor, face_parts: torch.Tensor) -> torch.Tensor:
    """Clothed-person texture from a (B, S, S) face-index map: per-sample
    garment tables, low-amplitude fractal fabric shading and a vertical
    illumination ramp; in [-1, 1]."""
    B, S = fim_lo.shape[0], fim_lo.shape[1]
    tables = garment_tables(draws, B, face_parts)
    idx = torch.where(fim_lo < 0, tables.shape[1] - 1, fim_lo).long()  # background: last row
    tex = tables[torch.arange(B, device=fim_lo.device)[:, None, None], idx]
    shade = 1.0 + 0.18 * fractal_noise(draws, B, S, 1)
    ramp = 1.0 - 0.25 * _linspace(0, 1, S, fim_lo.device)[None, :, None, None]
    amb = draws.uniform((B, 1, 1, 1), 0.75, 1.05)
    return torch.clamp(tex * shade * ramp * amb, -1, 1)


_TEXTURE_BANK = None


def _texture_bank() -> np.ndarray:
    """Real photographs available offline: scikit-learn's bundled sample
    images (a temple scene and a flower macro), cropped to a common size,
    (N, H, W, 3) in [-1, 1] on the host; N = 0 when scikit-learn is absent
    (callers fall back to procedural plates, as the JAX twin does). No image
    with a person is in the bank."""
    global _TEXTURE_BANK
    if _TEXTURE_BANK is None:
        imgs = []
        try:
            from sklearn.datasets import load_sample_images

            for im in load_sample_images().images:
                imgs.append(np.asarray(im, np.float32) / 127.5 - 1.0)
        except Exception:
            pass
        if imgs:
            h = min(i.shape[0] for i in imgs)
            w = min(i.shape[1] for i in imgs)
            _TEXTURE_BANK = np.stack([i[:h, :w] for i in imgs])
        else:
            _TEXTURE_BANK = np.zeros((0, 2, 2, 3), np.float32)
    return _TEXTURE_BANK


def synth_background_real(draws: Draws, batch: int, size: int) -> torch.Tensor:
    """Background plates cropped from `_texture_bank`'s photographs: random
    image, zoom (25-100 % of the frame), offset, horizontal flip and colour
    jitter, by a separable bilinear gather. `synth_background_photo` when
    the bank is empty."""
    bank_np = _texture_bank()
    if bank_np.shape[0] == 0:
        return synth_background_photo(draws, batch, size)
    dev = draws.device
    bank = torch.as_tensor(bank_np, device=dev)
    n, H, W, _ = bank.shape
    idx = draws.randint((batch,), 0, n)
    side = draws.uniform((batch, 1), 0.25, 1.0)
    txy = draws.uniform((batch, 2), 0.0, 1.0)
    flip = draws.bernoulli(0.5, (batch, 1))
    u = _linspace(0.0, 1.0, size, dev)[None]
    gx = (txy[:, 0:1] * (1 - side) + u * side) * (W - 1)
    gy = (txy[:, 1:2] * (1 - side) + u * side) * (H - 1)
    gx = torch.where(flip, (W - 1) - gx, gx)

    y0 = torch.clamp(torch.floor(gy).int(), 0, H - 2)  # (B, S)
    x0 = torch.clamp(torch.floor(gx).int(), 0, W - 2)
    wy = (gy - y0)[:, :, None, None]
    wx = (gx - x0)[:, None, :, None]
    b = torch.arange(batch, device=dev)[:, None]
    img = bank[idx.long()]  # (B, H, W, 3)
    rows = img[b, y0.long()] * (1 - wy) + img[b, y0.long() + 1] * wy  # (B, S, W, 3)
    b3, r3, c3 = b[:, :, None], torch.arange(size, device=dev)[None, :, None], x0.long()[:, None, :]
    out = rows[b3, r3, c3] * (1 - wx) + rows[b3, r3, c3 + 1] * wx
    scale = draws.uniform((batch, 1, 1, 3), 0.6, 1.4)
    shift = draws.uniform((batch, 1, 1, 3), -0.25, 0.25)
    return torch.clamp(out * scale + shift, -1, 1)


def synth_background_mix(draws: Draws, batch: int, size: int,
                         real_frac: float = 0.0) -> torch.Tensor:
    """The perception-training background distribution: `real_frac`
    real-photo crops, and of the rest 75 % photo-statistics and 25 % legacy
    procedural plates. Keep `real_frac` small (< 0.2): the bank holds two
    photographs."""
    photo = synth_background_photo(draws, batch, size)
    old = synth_background(draws, batch, size)
    u = draws.uniform((batch, 1, 1, 1))
    cut = real_frac + 0.75 * (1.0 - real_frac)
    out = torch.where(u < cut, photo, old)
    if real_frac > 0.0:
        real = synth_background_real(draws, batch, size)
        out = torch.where(u < real_frac, real, out)
    return out


def person_texture_mix(draws: Draws, cond: torch.Tensor, batch: int, size: int,
                       real_frac: float = 0.0) -> torch.Tensor:
    """Person appearance: a random per-sample colour transform of the part
    map with fractal shading, and `real_frac` of real-photo crops shaded by
    the part map."""
    M = draws.uniform((batch, 3, 3), -1, 1)
    proc = torch.einsum("bhwc,bcd->bhwd", cond, M)
    proc = proc + 0.35 * fractal_noise(draws, batch, size, 1)
    proc = torch.tanh(proc + 0.15 * draws.normal(proc.shape))
    if real_frac <= 0.0:
        return proc
    real = synth_background_real(draws, batch, size)
    shade = 0.65 + 0.35 * torch.mean(cond, dim=-1, keepdim=True)
    real = torch.clamp(real * shade, -1, 1)
    use_real = draws.bernoulli(real_frac, (batch, 1, 1, 1))
    return torch.where(use_real, real, proc)


def _blur3(x: torch.Tensor, strength: torch.Tensor) -> torch.Tensor:
    """Separable 3-tap blur (edge-padded) with per-sample strength in [0, 1]."""
    w0, w1, w2 = 0.25, 0.5, 0.25
    xp = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    h = w0 * xp[:, :-2] + w1 * xp[:, 1:-1] + w2 * xp[:, 2:]
    hp = torch.cat([h[:, :, :1], h, h[:, :, -1:]], dim=2)
    b = w0 * hp[:, :, :-2] + w1 * hp[:, :, 1:-1] + w2 * hp[:, :, 2:]
    return x + strength * (b - x)


def photo_augment(draws: Draws, img: torch.Tensor, strength: float = 1.0) -> torch.Tensor:
    """Camera-pipeline augmentation of (B, H, W, C) images in [-1, 1]:
    resolution jitter, blur, per-channel colour jitter, grayscale mixing,
    gamma, posterization, vignette and sensor noise."""
    b, h, w_, c = img.shape
    lo2 = resize_linear(resize_linear(img, (b, h // 2, w_ // 2, c)), (b, h, w_, c))
    lo4 = resize_linear(resize_linear(img, (b, h // 4, w_ // 4, c)), (b, h, w_, c))
    u2 = draws.uniform((b, 1, 1, 1))
    w2 = u2 * u2 * strength
    u4 = draws.uniform((b, 1, 1, 1))
    w4 = u4 * u4 * u4 * strength
    img = img * (1 - w2 - w4 * 0.5) + lo2 * w2 + lo4 * (w4 * 0.5)
    img = _blur3(img, draws.uniform((b, 1, 1, 1), 0.0, min(1.0, strength)))
    scale = draws.uniform((b, 1, 1, 3), 0.7, 1.3)
    shift = draws.uniform((b, 1, 1, 3), -0.15, 0.15)
    img = img * scale + shift
    g = torch.mean(img, dim=-1, keepdim=True)  # grayscale mixing
    a = draws.uniform((b, 1, 1, 1), 0.0, 0.6 * strength)
    img = img * (1 - a) + g * a
    gamma = draws.uniform((b, 1, 1, 1), 0.7, 1.4)  # in [0, 1] space
    img01 = torch.clamp((img + 1) * 0.5, 1e-4, 1.0)
    img = torch.pow(img01, gamma) * 2.0 - 1.0
    q = draws.uniform((b, 1, 1, 1), 8.0, 40.0)  # posterization
    post = torch.round((img + 1.0) * 0.5 * q) / q * 2.0 - 1.0
    use_post = draws.uniform((b, 1, 1, 1)) < 0.4 * strength
    img = torch.where(use_post, post, img)
    yy, xx = torch.meshgrid(_linspace(-1, 1, h, img.device), _linspace(-1, 1, w_, img.device),
                            indexing="ij")
    r2 = (xx * xx + yy * yy)[None, ..., None]
    vig = draws.uniform((b, 1, 1, 1), 0.0, 0.4)
    img = img - vig * r2
    img = img + 0.04 * draws.normal(img.shape)
    return torch.clamp(img, -1, 1)


def motion_blur(draws: Draws, img: torch.Tensor, max_len: float = 12.0,
                p: float = 0.5) -> torch.Tensor:
    """Directional motion blur with probability p per sample: a 13x13 line
    kernel (angle uniform, length 1..max_len px, gaussian cross-section),
    applied depthwise with zero "SAME" padding. img: (B, H, W, C)."""
    B, H, W, C = img.shape
    ang = draws.uniform((B,), 0.0, np.pi)
    ln = draws.uniform((B,), 1.0, max_len)
    use = draws.bernoulli(p, (B,))
    K = 13
    off = torch.arange(K, dtype=torch.float32, device=img.device) - K // 2
    dy, dx = torch.meshgrid(off, off, indexing="ij")
    ca, sa = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
    along = dx * ca + dy * sa
    perp = dy * ca - dx * sa
    w = torch.exp(-(perp * perp) / 0.5) * (torch.abs(along) <= ln[:, None, None] / 2)
    w = w / torch.clamp_min(w.sum(dim=(1, 2), keepdim=True), 1e-6)
    # one depthwise convolution over all samples: group b*C + ch takes w[b]
    x = img.permute(0, 3, 1, 2).reshape(1, B * C, H, W)
    kern = w[:, None].expand(B, C, K, K).reshape(B * C, 1, K, K)
    blurred = F.conv2d(x, kern, padding=K // 2, groups=B * C).reshape(B, C, H, W).permute(0, 2, 3, 1)
    return torch.where(use[:, None, None, None], blurred, img)


def compose_scene(draws: Draws, model: smpl_mod.SMPLModel, assets, batch: int, size: int,
                  pose_std: float = 0.25, yaw: bool = True, noise: float = 0.05,
                  photo: bool = True, real_frac: float = 0.0, studio_frac: float = 0.0,
                  garment_frac: float = 0.0, natural_frac: float = 0.0) -> SceneBatch:
    """A labeled scene batch at `size`, rendered supersampled 2x (K1 rasters
    at 2 * size).

    photo=True: photo-statistics backgrounds, fractal person shading, a
    contact shadow and the camera-pipeline augmentation. `studio_frac` /
    `garment_frac`: the fractions of scenes with studio backgrounds and of
    people in garment textures."""
    theta = make_theta(draws, batch, pose_std=pose_std, yaw=yaw, natural_frac=natural_frac)
    details = smpl_mod.get_details(model, theta)
    fim = render_fim(model, theta, size * 2, f2uvs=assets.f2uvs, details=details)
    hard_hi = (fim >= 0).float()[..., None]
    alpha = _downsample2(hard_hi)
    cond = _downsample2(rz.encode_fim(fim, assets.map_fn))
    if photo:
        bg = synth_background_mix(draws, batch, size, real_frac=real_frac)
        if studio_frac > 0.0:
            studio = synth_background_studio(draws, batch, size)
            use_st = draws.bernoulli(studio_frac, (batch, 1, 1, 1)).float()
            bg = bg * (1 - use_st) + studio * use_st
    else:
        bg = synth_background(draws, batch, size)
    if photo:
        tex = person_texture_mix(draws, cond, batch, size, real_frac=real_frac)
        if garment_frac > 0.0:
            garm = _downsample2(garment_texture(draws, fim, assets.face_parts))
            use_g = draws.bernoulli(garment_frac, (batch, 1, 1, 1)).float()
            tex = tex * (1 - use_g) + garm * use_g
        # contact shadow under the person: a 5x5 box sum with zero padding / 25
        sh = torch.roll(alpha, (size // 32, size // 24), dims=(1, 2))
        sh = F.avg_pool2d(sh.permute(0, 3, 1, 2), 5, stride=1, padding=2,
                          count_include_pad=True).permute(0, 2, 3, 1)
        amp = draws.uniform((batch, 1, 1, 1), 0.0, 0.5)
        bg = bg - amp * sh * (bg + 1.0) * 0.5
    else:
        M = draws.uniform((batch, 3, 3), -1, 1)
        tex = torch.einsum("bhwc,bcd->bhwd", cond, M)
        tex = torch.tanh(tex + 0.15 * draws.normal(tex.shape))
    img = tex * alpha + bg * (1.0 - alpha)
    if photo:
        img = photo_augment(draws, img)
    else:
        img = torch.clamp(img + noise * draws.normal(img.shape), -1, 1)
    return SceneBatch(img=img, alpha=alpha, mask=(alpha > 0.5).float(), bg=bg, theta=theta,
                      j2d=details["j2d"])


def random_holes(draws: Draws, batch: int, size: int, max_holes: int = 4) -> torch.Tensor:
    """Random rectangular and elliptical hole masks (1 = hole), (B, S, S, 1)."""
    yy, xx = _grid(0, 1, size, draws.device)
    holes = torch.zeros((batch, size, size), dtype=torch.bool, device=draws.device)
    for _ in range(max_holes):
        c = draws.uniform((batch, 2, 1, 1), 0.1, 0.9)
        wh = draws.uniform((batch, 2, 1, 1), 0.05, 0.35)
        is_ellipse = draws.bernoulli(0.5, (batch, 1, 1))
        dx = torch.abs(xx[None] - c[:, 0]) / wh[:, 0]
        dy = torch.abs(yy[None] - c[:, 1]) / wh[:, 1]
        rect = torch.maximum(dx, dy) < 1.0
        ell = dx * dx + dy * dy < 1.0
        holes = holes | torch.where(is_ellipse, ell, rect)
    return holes.float()[..., None]


# ---------------------------------------------------------------------------
# OpenPose targets: Body-25 joints + PAFs from SMPL
# ---------------------------------------------------------------------------

def body25_from_cocoplus(j2d_coco: torch.Tensor) -> tuple[torch.Tensor, np.ndarray]:
    """cocoplus-19 NDC joints -> (Body-25 joints (B, 25, 2), valid (25,) numpy).
    The six unmapped Body-25 channels (toes and heels, 19-24) are invalid."""
    from ipercore_tpu_torch.tools.pose2d import BODY25_TO_COCOPLUS19

    m = torch.as_tensor(np.asarray(BODY25_TO_COCOPLUS19)).to(j2d_coco.device, non_blocking=True).long()
    out = torch.zeros((j2d_coco.shape[0], 25, 2), dtype=j2d_coco.dtype, device=j2d_coco.device)
    out[:, m, :] = j2d_coco
    valid = np.zeros((25,), np.float32)
    valid[np.asarray(BODY25_TO_COCOPLUS19)] = 1.0
    return out, valid


def _limb_field(px: torch.Tensor, ja: int, jb: int, xx: torch.Tensor, yy: torch.Tensor):
    """The unit vector u (B, 2) from joint ja to joint jb and the (B, h, h)
    mask of the pixels on that limb (within 1 px along, 1.5 px across)."""
    a, bpt = px[:, ja], px[:, jb]
    ab = bpt - a
    norm = torch.clamp_min(torch.sqrt(torch.sum(ab * ab, dim=-1, keepdim=True)), 1e-5)
    u = ab / norm
    rel_x = xx[None] - a[:, 0, None, None]
    rel_y = yy[None] - a[:, 1, None, None]
    along = rel_x * u[:, 0, None, None] + rel_y * u[:, 1, None, None]
    across = torch.abs(rel_x * u[:, 1, None, None] - rel_y * u[:, 0, None, None])
    on_limb = ((along >= -1.0) & (along <= norm[:, :, None] + 1.0) & (across <= 1.5)).float()
    return u, on_limb


def _heatmaps(px: torch.Tensor, valid: torch.Tensor, xx, yy, sigma: float) -> torch.Tensor:
    """Gaussian joint heatmaps and the background channel, (B, h, h, J+1)."""
    ex = xx[None, None] - px[:, :, 0, None, None]
    ey = yy[None, None] - px[:, :, 1, None, None]
    d2 = ex * ex + ey * ey  # (B, J, h, h)
    hm = torch.exp(-d2 / (2 * sigma ** 2)) * valid
    bgc = torch.clamp(1.0 - hm.amax(dim=1, keepdim=True), 0.0, 1.0)
    return torch.movedim(torch.cat([hm, bgc], dim=1), 1, -1)


def _pose2d_targets(joints_ndc: torch.Tensor, valid: np.ndarray, hm_size: int, sigma: float,
                    limbs, paf_ids, n_paf_ch: int):
    """Gaussian heatmaps (+ background) and limb PAFs for joints shared
    valid over the batch.

    joints_ndc: (B, J, 2) NDC; valid: host (J,) 0/1. Returns (heatmaps
    (B, h, h, J+1), pafs (B, h, h, n_paf_ch), hm_weight (J+1,), paf_weight
    (n_paf_ch,)), the weights numpy.
    """
    dev = joints_ndc.device
    px = (joints_ndc + 1.0) * 0.5 * hm_size - 0.5
    B = px.shape[0]
    r = torch.arange(hm_size, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    heatmaps = _heatmaps(px, torch.as_tensor(valid).to(dev, non_blocking=True)[None, :, None, None], xx, yy, sigma)
    hm_weight = np.concatenate([valid, np.ones((1,), np.float32)])
    pafs = torch.zeros((B, n_paf_ch, hm_size, hm_size), device=dev)
    paf_weight = np.zeros((n_paf_ch,), np.float32)
    for (ja, jb), (cx, cy) in zip(limbs, paf_ids):
        if not (float(valid[ja]) and float(valid[jb])):
            continue
        u, on_limb = _limb_field(px, ja, jb, xx, yy)
        pafs[:, cx] = on_limb * u[:, 0, None, None]
        pafs[:, cy] = on_limb * u[:, 1, None, None]
        paf_weight[cx] = paf_weight[cy] = 1.0
    return heatmaps, torch.movedim(pafs, 1, -1), hm_weight, paf_weight


def make_pose2d_targets_b25(b25_ndc: torch.Tensor, valid_b: torch.Tensor, hm_size: int,
                            sigma: float = 1.5):
    """Per-sample-validity Body-25 targets (pseudo-labeled real crops).

    b25_ndc: (B, 25, 2) NDC; valid_b: (B, 25) 0/1 float. Returns (heatmaps
    (B, h, h, 26), pafs (B, h, h, 52), hm_w (B, 1, 1, 26), paf_w (B, 1, 1, 52)).
    The background channel is supervised only where every production joint
    is valid.
    """
    from ipercore_tpu_torch.tools.pose2d import BODY25_TO_COCOPLUS19
    from ipercore_tpu_torch.tools.pose2d_decode import BODY25_LIMBS, BODY25_PAF_IDS

    S, dev = hm_size, b25_ndc.device
    safe = torch.where(valid_b[..., None] > 0, b25_ndc, torch.full_like(b25_ndc, -2.0))
    px = (safe + 1.0) * 0.5 * S - 0.5
    B = px.shape[0]
    r = torch.arange(S, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    heatmaps = _heatmaps(px, valid_b[:, :, None, None], xx, yy, sigma)
    prod = np.zeros((25,), np.float32)
    prod[np.asarray(BODY25_TO_COCOPLUS19)] = 1.0
    prod_t = torch.as_tensor(prod).to(dev, non_blocking=True)
    bg_w = torch.prod(torch.where(prod_t > 0, valid_b, torch.ones_like(valid_b)), dim=1)
    hm_w = torch.cat([valid_b, bg_w[:, None]], dim=1)  # (B, 26)
    pafs = torch.zeros((B, 52, S, S), device=dev)
    paf_w = torch.zeros((B, 52), device=dev)
    for (ja, jb), (cx, cy) in zip(BODY25_LIMBS, BODY25_PAF_IDS):
        w = valid_b[:, ja] * valid_b[:, jb]
        u, on_limb = _limb_field(px, ja, jb, xx, yy)
        pafs[:, cx] = on_limb * u[:, 0, None, None]
        pafs[:, cy] = on_limb * u[:, 1, None, None]
        paf_w[:, cx] = w
        paf_w[:, cy] = w
    return (heatmaps, torch.movedim(pafs, 1, -1), hm_w[:, None, None, :], paf_w[:, None, None, :])


def make_pose2d_targets(j2d_coco: torch.Tensor, hm_size: int, sigma: float = 1.5):
    """Gaussian heatmaps + limb PAFs at `hm_size` from cocoplus joints:
    (heatmaps (B, h, h, 26), pafs (B, h, h, 52), hm_weight (26,), paf_weight
    (52,)) in `OpenPoseBody25`'s channels (25 = background)."""
    from ipercore_tpu_torch.tools.pose2d_decode import BODY25_LIMBS, BODY25_PAF_IDS

    b25, valid = body25_from_cocoplus(j2d_coco)
    return _pose2d_targets(b25, valid, hm_size, sigma, BODY25_LIMBS, BODY25_PAF_IDS, 52)


# cocoplus-19 index feeding each COCO-18 joint (Mobilenet variant head):
# nose, neck, R-sho/elb/wri, L-sho/elb/wri, R-hip/knee/ank, L-hip/knee/ank,
# R/L-eye, R/L-ear.
COCO18_FROM_COCOPLUS = np.asarray(
    [13, 12, 8, 7, 6, 9, 10, 11, 2, 1, 0, 3, 4, 5, 15, 17, 14, 16], np.int32)


def make_pose2d_targets_coco18(j2d_coco: torch.Tensor, hm_size: int, sigma: float = 1.5):
    """COCO-18 targets for `MobilenetOpenPose`: (B, h, h, 19) heatmaps
    (channel 18 = background) + (B, h, h, 38) PAFs."""
    from ipercore_tpu_torch.tools.pose2d_decode import COCO18_LIMBS, COCO18_PAF_IDS

    j18 = j2d_coco[:, torch.as_tensor(COCO18_FROM_COCOPLUS).to(j2d_coco.device, non_blocking=True).long()]
    valid = np.ones((18,), np.float32)
    return _pose2d_targets(j18, valid, hm_size, sigma, COCO18_LIMBS, COCO18_PAF_IDS, 38)
