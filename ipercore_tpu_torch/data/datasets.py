"""Datasets over preprocessed `primitives/` trees.

The port's own copy of `ipercore_tpu/data/datasets.py`:
  * `ProcessedVideoDataset`: per video, ns source frames from the front ids
    and nt random target frames;
  * `PersonalizedDataset`: one subject;
  * `BackgroundDataset`: random square background crops for aug-bg training;
  * `VideoBackgroundDataset`: zips the two.

Batches are numpy, shaped for `trainers.lwg_trainer.train_step` (NHWC,
images in [-1, 1], masks background = 1). A sample is drawn first (the
`np.random.RandomState` draws, in the JAX package's order: video index, then
the target ids; for a background its index, crop corner and flip) and loaded
after, so that `iterate(batch_size, seed, rank, world)` draws the global batch
of `batch_size * world` samples from one generator, as the JAX package's
`iterate(batch_size * n_devices)` does, and decodes only the rank's rows.
Resizing is `resize_linear`, a copy of `jax.image.resize(..., "linear")`.
"""
from __future__ import annotations

import functools
import os
import struct
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ipercore_tpu_torch.services.process_info import ProcessInfo
from ipercore_tpu_torch.utils import video as vid


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of `jax.image.scale_and_translate` with the
    triangle kernel, scale n_out / n_in, no translation, antialiased: the
    kernel widens by n_in / n_out when shrinking, each output's weights are
    normalised to sum 1, and an output whose sample lies outside the input
    gets none."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))  # in double, then rounded, as JAX takes a Python scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=None)
def _linear_weights_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """`_linear_weights(n_in, n_out)` on `device`, copied there once."""
    return torch.as_tensor(_linear_weights(n_in, n_out), device=device)


def resize_linear(x, shape: Sequence[int]):
    """`jax.image.resize(x, shape, "linear")` of a float32 numpy array (in
    numpy) or of a tensor (in torch, on its device): every axis whose size
    changes is resampled with `_linear_weights`, in axis order."""
    tensor = isinstance(x, torch.Tensor)
    out = x if tensor else np.asarray(x, np.float32)
    if len(shape) != out.ndim:
        raise ValueError(f"resize_linear: shape {tuple(shape)} for an array of {out.ndim} dims")
    for axis, n_out in enumerate(shape):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        if tensor:
            w = _linear_weights_on(n_in, int(n_out), out.device).to(out.dtype)
            out = torch.movedim(torch.tensordot(out, w, dims=([axis], [0])), -1, axis)
        else:
            w = _linear_weights(n_in, int(n_out))
            out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
    return out


def _load_image(path: str, size: Optional[int] = None) -> np.ndarray:
    img = vid.load_image(path)
    if size is not None and img.shape[:2] != (size, size):
        img = resize_linear(img, (size, size, 3))
    return img


def _image_hw(path: str) -> tuple[int, int]:
    """(height, width) of an image: a PNG's from its header, any other by
    decoding it."""
    if path.endswith((".png", ".PNG")):
        with open(path, "rb") as f:
            head = f.read(24)
        w, h = struct.unpack(">II", head[16:24])
        return int(h), int(w)
    return vid.load_image(path).shape[:2]


def _iterate(dataset, batch_size: int, seed: int, rank: int, world: int) -> Iterator[dict]:
    """Endless batches of a dataset with `draw` / `load` / `keys`: each round
    draws `batch_size * world` samples from one generator and yields rows
    `[rank * batch_size, (rank + 1) * batch_size)`, loaded and stacked."""
    rng = np.random.RandomState(seed)
    while True:
        draws = [dataset.draw(rng) for _ in range(batch_size * world)]
        samples = [dataset.load(*d) for d in draws[rank * batch_size:(rank + 1) * batch_size]]
        yield {k: np.stack([s[k] for s in samples]) for k in dataset.keys}


class ProcessedVideoDataset:
    """Multi-video training dataset.

    Args:
        dataset_dirs: roots containing `<split>.txt` (one video name per line;
            without it every video under `primitives/`) and
            `primitives/<vid>/processed/` trees.
    """

    keys = ("images", "smpls", "masks", "bg")

    def __init__(self, dataset_dirs: list[str], image_size: int = 512,
                 num_source: int = 2, time_step: int = 2, split: str = "train"):
        self.image_size = image_size
        self.ns = num_source
        self.nt = time_step
        self.videos: list[dict] = []
        for root in dataset_dirs:
            txt = os.path.join(root, f"{split}.txt")
            if os.path.exists(txt):
                with open(txt) as f:
                    names = [l.strip() for l in f if l.strip()]
            else:
                prim = os.path.join(root, "primitives")
                names = sorted(os.listdir(prim)) if os.path.isdir(prim) else []
            for name in names:
                proc = os.path.join(root, "primitives", name, "processed")
                info = ProcessInfo.deserialize(proc)
                smpls = info.get_array("smpls")
                if smpls is None or len(smpls) < self.ns + self.nt:
                    continue
                self.videos.append({"proc": proc, "info": info})

    def __len__(self):
        return len(self.videos)

    def draw(self, rng: np.random.RandomState, vid_idx: Optional[int] = None) -> tuple[int, list[int]]:
        """The random part of a sample: (video index, frame ids), the ns
        source ids from the front ids, then nt random target ids."""
        v = vid_idx if vid_idx is not None else rng.randint(len(self.videos))
        info: ProcessInfo = self.videos[v]["info"]
        src_ids = info.read_src_info(self.ns)["src_ids"]
        tgt_ids = rng.randint(0, len(info.get_array("smpls")), size=self.nt)
        return v, list(src_ids) + list(tgt_ids)

    def load(self, vid_idx: int, ids: list[int]) -> dict:
        """Decode the frames, masks and pseudo-background of a drawn sample."""
        v = self.videos[vid_idx]
        info: ProcessInfo = v["info"]
        S = self.image_size
        names = [info.meta["valid_img_names"][i] for i in ids]
        img_dir = os.path.join(v["proc"], "images")
        images = np.stack([_load_image(os.path.join(img_dir, n), S) for n in names])

        masks_arr = info.get_array("masks")
        if masks_arr is not None:
            masks = masks_arr[ids].astype(np.float32)
            if masks.ndim == 3:
                masks = masks[..., None]
            if masks.shape[1] != S:
                masks = resize_linear(masks, (len(ids), S, S, 1))
        else:
            masks = np.ones((len(ids), S, S, 1), np.float32)

        bg_path = os.path.join(v["proc"], "background.png")
        bg = _load_image(bg_path, S) if os.path.exists(bg_path) else np.zeros((S, S, 3), np.float32)
        return {
            "images": images.astype(np.float32),
            "smpls": info.get_array("smpls")[ids].astype(np.float32),
            "masks": masks,
            "bg": bg,
            "offsets": info.read_src_info(self.ns)["offsets"],
        }

    def sample(self, rng: np.random.RandomState, vid_idx: Optional[int] = None) -> dict:
        """One training sample: ns sources from the front ids + nt random targets."""
        return self.load(*self.draw(rng, vid_idx))

    def iterate(self, batch_size: int, seed: int = 0, rank: int = 0, world: int = 1) -> Iterator[dict]:
        """This rank's rows of every global batch (`_iterate`)."""
        return _iterate(self, batch_size, seed, rank, world)


class PersonalizedDataset(ProcessedVideoDataset):
    """Single-subject dataset for personalization."""

    def __init__(self, processed_dir: str, image_size: int = 512,
                 num_source: int = 2, time_step: int = 1):
        self.image_size = image_size
        self.ns = num_source
        self.nt = time_step
        info = ProcessInfo.deserialize(processed_dir)
        self.videos = [{"proc": processed_dir, "info": info}]


class BackgroundDataset:
    """Random background image crops: any folder of images serves as aug
    backgrounds."""

    def __init__(self, image_dir: str, image_size: int = 512):
        self.paths = vid.list_frames(image_dir) if os.path.isdir(image_dir) else []
        self.image_size = image_size

    def __len__(self):
        return len(self.paths)

    def draw(self, rng: np.random.RandomState) -> Optional[tuple[int, int, int, bool]]:
        """(image index, crop row, crop column, flip) of a random square crop,
        or None without images."""
        if not self.paths:
            return None
        i = rng.randint(len(self.paths))
        h, w = _image_hw(self.paths[i])
        side = min(h, w)
        y0 = rng.randint(0, h - side + 1)
        x0 = rng.randint(0, w - side + 1)
        return i, int(y0), int(x0), bool(rng.rand() < 0.5)

    def load(self, drawn: Optional[tuple[int, int, int, bool]]) -> np.ndarray:
        S = self.image_size
        if drawn is None:
            return np.zeros((S, S, 3), np.float32)
        i, y0, x0, flip = drawn
        img = vid.load_image(self.paths[i])
        side = min(img.shape[:2])
        crop = img[y0:y0 + side, x0:x0 + side]
        if flip:
            crop = crop[:, ::-1]
        return resize_linear(crop, (S, S, 3))

    def sample(self, rng: np.random.RandomState) -> np.ndarray:
        return self.load(self.draw(rng))


class VideoBackgroundDataset:
    """Zip a video sample with an aug background."""

    keys = ("images", "smpls", "masks", "bg", "aug_bg")

    def __init__(self, video_ds: ProcessedVideoDataset, bg_ds: BackgroundDataset):
        self.video_ds = video_ds
        self.bg_ds = bg_ds

    def __len__(self):
        return len(self.video_ds)

    def draw(self, rng: np.random.RandomState):
        return self.video_ds.draw(rng), self.bg_ds.draw(rng)

    def load(self, video_draw, bg_draw) -> dict:
        s = self.video_ds.load(*video_draw)
        s["aug_bg"] = self.bg_ds.load(bg_draw)
        return s

    def sample(self, rng: np.random.RandomState) -> dict:
        return self.load(*self.draw(rng))

    def iterate(self, batch_size: int, seed: int = 0, rank: int = 0, world: int = 1) -> Iterator[dict]:
        return _iterate(self, batch_size, seed, rank, world)


DATASET_REGISTRY = {
    "ProcessedVideo": ProcessedVideoDataset,
    "ProcessedVideo+Place2": VideoBackgroundDataset,
    "Personalized": PersonalizedDataset,
}


def build_dataset(name: str, **kw):
    """A dataset by registry name (the JAX package's factory): keyword
    arguments the class does not take raise TypeError, as `split` does for
    "Personalized"."""
    if name == "ProcessedVideo+Place2":
        video = ProcessedVideoDataset(
            kw["dataset_dirs"], kw.get("image_size", 512),
            kw.get("num_source", 2), kw.get("time_step", 2),
            split=kw.get("split", "train"))
        bg = BackgroundDataset(kw.get("background_dir", ""), kw.get("image_size", 512))
        return VideoBackgroundDataset(video, bg)
    if name not in DATASET_REGISTRY:
        raise KeyError(f"unknown dataset {name!r}")
    return DATASET_REGISTRY[name](**kw)
