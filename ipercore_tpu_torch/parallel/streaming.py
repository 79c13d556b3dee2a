"""Double-buffered device-to-host streaming synthesis.

Twin of `ipercore_tpu/parallel/streaming.py`. The reference writes one PNG per
frame inside its frame loop, so host IO and device compute take turns. Here
chunk i+1 is enqueued on the device before chunk i is fetched, and a thread
pool writes the fetched frames to disk while the device computes:

    synth = StreamingSynthesizer(comp, gen, cache, chunk=8)
    paths = synth.run(tgt_smpls, out_dir)

On a CUDA device one stream holds both chunks' kernels, so a plain `.cpu()` of
chunk i enqueued after chunk i+1 would wait for chunk i+1 too. Instead chunk i's
frames are copied into pinned host memory on a side stream that waits on an
event recorded right after chunk i's kernels, and the host waits on that copy
alone. Two pinned buffers alternate; a buffer is refilled only after the
writes that read it are done.

Spans (`utils.logging.span`): `stream.run` around a clip (attributes
`frames`, `padded`), `stream.enqueue` around each chunk's launch (`chunk`),
`stream.fetch` while the host waits for a chunk's frames, and inside it
`stream.write_wait` while it waits for the writes that read the buffer.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Optional

import numpy as np
import torch

from ipercore_tpu_torch.models import imitator as imit
from ipercore_tpu_torch.utils import video as vid
from ipercore_tpu_torch.utils.logging import span


class StreamingSynthesizer:
    """Chunked `synthesize_frames` with one chunk in flight on the device and
    PNG writes on `io_workers` threads. The device is the cache's. The default
    is f32 (`compute_dtype=None`), as everywhere in the port; JAX picks bf16
    on a TPU."""

    def __init__(self, comp, generator, cache: imit.SourceCache, chunk: int = 8,
                 io_workers: int = 4, offsets=0.0, links_ids=None,
                 compute_dtype: Optional[torch.dtype] = None):
        self.comp = comp
        self.generator = generator
        self.cache = cache
        self.chunk = chunk
        self.offsets = offsets
        self.links_ids = links_ids
        self.compute_dtype = compute_dtype
        self.io_workers = io_workers
        self.device = cache.bg_img.device

    def _synthesize(self, smpls: torch.Tensor) -> torch.Tensor:
        preds, _ = imit.synthesize_frames(self.comp, self.generator, self.cache, smpls,
                                          self.offsets, self.links_ids,
                                          compute_dtype=self.compute_dtype)
        return preds

    def _enqueue(self, fetch, smpls: torch.Tensor, ci: int):
        c = self.chunk
        with span("stream.enqueue", chunk=ci):
            return fetch.enqueue(self._synthesize(smpls[ci * c:(ci + 1) * c]))

    def run(self, tgt_smpls: np.ndarray, out_dir: Optional[str] = None,
            name_fmt: str = "pred_{:08d}.png") -> list:
        """Synthesize all frames with one-chunk-deep device pipelining. The
        tail chunk is padded with the last frame, so every chunk has the same
        batch size.

        Returns the list of written paths (with `out_dir`) or of (S, S, 3)
        float32 frames in [-1, 1].
        """
        tgt_smpls = np.asarray(tgt_smpls, np.float32)
        n, c = len(tgt_smpls), self.chunk
        pad = (-n) % c
        smpls = np.concatenate(
            [tgt_smpls, np.repeat(tgt_smpls[-1:], pad, axis=0)]) if pad else tgt_smpls
        smpls = torch.as_tensor(smpls, device=self.device)
        n_chunks = len(smpls) // c
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        fetch = _CudaFetch(self.device) if self.device.type == "cuda" else _HostFetch()

        results: list = [None] * n
        with span("stream.run", frames=n, padded=pad), \
                cf.ThreadPoolExecutor(max_workers=self.io_workers) as pool:
            pending = self._enqueue(fetch, smpls, 0)
            for ci in range(n_chunks):
                # enqueue the next chunk before fetching this one: device compute
                # overlaps the copy and the PNG writes below
                nxt = self._enqueue(fetch, smpls, ci + 1) if ci + 1 < n_chunks else None
                host = fetch.fetch(pending)  # waits on this chunk only
                writes = []
                for j in range(min(c, n - ci * c)):
                    fi = ci * c + j
                    if out_dir:
                        path = os.path.join(out_dir, name_fmt.format(fi))
                        writes.append(pool.submit(vid.save_image, path, host[j]))
                        results[fi] = path
                    else:
                        results[fi] = host[j].copy()
                fetch.release(writes)
                pending = nxt
            fetch.drain()
        return results


class _HostFetch:
    """CPU tensors: the chunk is computed when it is enqueued."""

    def __init__(self):
        self.writes: list = []

    def enqueue(self, preds: torch.Tensor) -> torch.Tensor:
        return preds

    def fetch(self, preds: torch.Tensor) -> np.ndarray:
        with span("stream.fetch"):
            return preds.numpy()

    def release(self, writes: list) -> None:
        self.writes += writes

    def drain(self) -> None:
        for f in self.writes:
            f.result()


class _CudaFetch:
    """The side-stream copy into two alternating pinned buffers."""

    def __init__(self, device: torch.device):
        self.device = device
        self.copy_stream = torch.cuda.Stream(device)
        self.buffers: list = [None, None]
        self.writes: list = [[], []]  # the writes that read each buffer
        self.turn = 0

    def enqueue(self, preds: torch.Tensor) -> tuple:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))  # right after this chunk's kernels
        return preds, done

    def fetch(self, pending: tuple) -> np.ndarray:
        with span("stream.fetch"):
            preds, done = pending  # `preds` stays referenced until its copy has ended
            b = self.turn
            with span("stream.write_wait"):
                for f in self.writes[b]:
                    f.result()
            self.writes[b] = []
            if self.buffers[b] is None or self.buffers[b].shape != preds.shape:
                self.buffers[b] = torch.empty(preds.shape, dtype=preds.dtype, pin_memory=True)
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(done)
                self.buffers[b].copy_(preds, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self.copy_stream)
            copied.synchronize()
            return self.buffers[b].numpy()

    def release(self, writes: list) -> None:
        self.writes[self.turn] = writes
        self.turn ^= 1

    def drain(self) -> None:
        for f in self.writes[0] + self.writes[1]:
            f.result()
