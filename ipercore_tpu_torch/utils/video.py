"""Host-side video / image IO: ffmpeg decode/encode, frame folders, fusing.

The port's own copy of `ipercore_tpu/utils/video.py`. The PNG writer and
reader keep zlib and the chunk framing in Python and filter rows with the
port's native routines (`utils/native.py`, `csrc/pngfilters.cpp`), as the JAX
package does when its library builds: the writer stores every row
Sub-filtered, so its files are byte-equal to the JAX package's, and the reader
undoes all five PNG filters natively. `unfilter_rows_plain` and
`filter_sub_plain` are the Python versions the native routines are held
against. `load_image` resizes with the port's `resize_image` (antialiased, as
`jax.image.resize` is). Everything degrades gracefully without ffmpeg (unit
tests run on image folders); `make_video` raises when neither ffmpeg nor cv2
can encode.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Iterable, Optional, Sequence

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".PNG", ".JPG", ".JPEG")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".MP4")


def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def is_image_file(p: str) -> bool:
    return p.endswith(IMAGE_EXTS)


def is_video_file(p: str) -> bool:
    return p.endswith(VIDEO_EXTS)


def list_frames(folder: str) -> list[str]:
    return sorted(
        os.path.join(folder, f) for f in os.listdir(folder) if is_image_file(f)
    )


# --- png io (zlib in python, row filters native) -------------------------------

def filter_sub_plain(rows: np.ndarray, bpp: int) -> bytes:
    """The Sub filter in numpy: (H, stride) uint8 rows -> filter-tagged
    scanline bytes, what `native.png_filter_sub` returns."""
    rows = np.asarray(rows, np.uint8)
    sub = rows.copy()
    sub[:, bpp:] = rows[:, bpp:] - rows[:, :-bpp]  # uint8 arithmetic wraps, as in C
    return np.concatenate([np.ones((len(rows), 1), np.uint8), sub], axis=1).tobytes()


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, C) uint8 image (C = 1, 3 or 4; or (H, W) gray as RGB)
    as PNG, every row Sub-filtered by the native routine."""
    import struct
    import zlib

    from ipercore_tpu_torch.utils import native

    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    h, w = img.shape[:2]
    colortype = {1: 0, 3: 2, 4: 6}.get(img.shape[2])
    if colortype is None:
        raise ValueError(f"write_png: unsupported channel count {img.shape[2]}")
    raw = native.png_filter_sub(img.reshape(h, -1), bpp=img.shape[2])
    if raw is None:
        raise ValueError(f"write_png: cannot filter an image of shape {img.shape}")

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, colortype, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def png_rows(path: str) -> tuple[bytes, int, int, int]:
    """The inflated, still filtered scanlines of an 8-bit PNG and its
    (height, width, channels)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a png"
    pos = 8
    idat = b""
    w = h = bitdepth = colortype = None
    interlace = 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bitdepth, colortype = struct.unpack(">IIBB", payload[:10])
            interlace = payload[12]
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    assert bitdepth == 8, "only 8-bit PNGs supported"
    if interlace != 0:
        raise ValueError("read_png: interlaced (Adam7) PNGs are not supported")
    if colortype == 3:
        raise ValueError("read_png: palette PNGs are not supported (colortype 3)")
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[colortype]
    return zlib.decompress(idat), h, w, nch


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB(A)/gray PNG into (H, W, 3) uint8; rows are undone by
    the native routine."""
    from ipercore_tpu_torch.utils import native

    raw, h, w, nch = png_rows(path)
    out = native.png_unfilter(raw, h, w * nch, nch)
    if out is None:
        raise ValueError(f"read_png: corrupt scanlines or an unknown row filter in {path}")
    return _png_channels(out.reshape(h, w, nch))


def unfilter_rows_plain(raw: bytes, h: int, stride: int, nch: int) -> np.ndarray:
    """Undo the five PNG row filters in Python (Sub and Up vectorised, Average
    and Paeth byte by byte): the plain version of `native.png_unfilter`."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros((stride,), np.int32)
    pos = 0
    for row in range(h):
        ft = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).astype(np.int32)
        pos += 1 + stride
        if ft == 0:
            cur = line
        elif ft == 1:  # sub: a running sum per channel
            cur = np.cumsum(line.reshape(-1, nch), axis=0).reshape(-1) & 0xFF
        elif ft == 2:  # up
            cur = (line + prev) & 0xFF
        elif ft == 3:  # average
            cur = line.copy()
            for i in range(stride):
                left = cur[i - nch] if i >= nch else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - nch] if i >= nch else 0
                b = prev[i]
                c = prev[i - nch] if i >= nch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"unknown filter {ft}")
        out[row] = cur.astype(np.uint8)
        prev = out[row].astype(np.int32)
    return out


def _png_channels(img: np.ndarray) -> np.ndarray:
    """Normalize decoded channels to (H, W, 3)."""
    nch = img.shape[2]
    if nch == 1:
        return np.repeat(img, 3, axis=2)
    if nch == 2:
        return np.repeat(img[..., :1], 3, axis=2)
    if nch == 4:
        return np.ascontiguousarray(img[..., :3])
    return img


def load_image(path: str, size: Optional[int] = None) -> np.ndarray:
    """Load an image to float32 (H, W, 3) in [-1, 1] (`filesio/cv_utils.py`
    normalization convention), optionally resized to size x size."""
    if path.endswith((".png", ".PNG")):
        img = read_png(path)
    else:
        try:
            import cv2  # noqa

            img = cv2.imread(path)[:, :, ::-1]
        except Exception:
            from PIL import Image

            img = np.asarray(Image.open(path).convert("RGB"))
    img = img.astype(np.float32) / 127.5 - 1.0
    if size is not None and img.shape[:2] != (size, size):
        import torch

        from ipercore_tpu_torch.ops.sampling import resize_image

        img = resize_image(torch.from_numpy(np.ascontiguousarray(img)), size, size).numpy()
    return img


def save_image(path: str, img: np.ndarray) -> None:
    """Save a float image in [-1, 1] (H, W, 3) as PNG."""
    u8 = np.clip((np.asarray(img) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    write_png(path, u8)


# --- ffmpeg wrappers (cv2 fallback when ffmpeg is absent) ---------------------

def _cv2():
    try:
        import cv2

        return cv2
    except Exception:
        return None


def video2frames(video_path: str, out_dir: str, fps: Optional[float] = None) -> list[str]:
    """Decode a video into numbered pngs — `video2frames:531`.

    Prefers subprocess ffmpeg (the reference's transport); falls back to an
    OpenCV VideoCapture loop on ffmpeg-less hosts. `fps` resamples by frame
    skipping in the fallback."""
    os.makedirs(out_dir, exist_ok=True)
    if has_ffmpeg():
        cmd = ["ffmpeg", "-y", "-loglevel", "error", "-i", video_path]
        if fps:
            cmd += ["-r", str(fps)]
        cmd += [os.path.join(out_dir, "frame_%08d.png")]
        subprocess.run(cmd, check=True)
        return list_frames(out_dir)
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("neither ffmpeg nor cv2 available to decode video")
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"cv2 could not open {video_path}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    step = max(src_fps / fps, 1.0) if fps else 1.0
    i_out, acc = 0, 0.0
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx >= acc:
            acc += step
            i_out += 1
            write_png(os.path.join(out_dir, f"frame_{i_out:08d}.png"),
                      frame[..., ::-1].copy())  # BGR -> RGB
        idx += 1
    cap.release()
    return list_frames(out_dir)


def get_video_fps(video_path: str, default: float = 25.0) -> float:
    """ffprobe fps — `get_video_fps:623` (cv2 fallback)."""
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "v:0",
             "-show_entries", "stream=r_frame_rate", "-of", "csv=p=0", video_path],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        num, den = out.split("/")
        return float(num) / float(den)
    except Exception:
        cv2 = _cv2()
        if cv2 is not None:
            try:
                cap = cv2.VideoCapture(video_path)
                if cap.isOpened():
                    fps = cap.get(cv2.CAP_PROP_FPS)
                    cap.release()
                    if fps and fps > 0:
                        return float(fps)
            except Exception:
                pass
        return default


def check_video_has_audio(video_path: str) -> bool:
    """`check_video_has_audio:661`."""
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "a",
             "-show_entries", "stream=codec_type", "-of", "csv=p=0", video_path],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        return "audio" in out
    except Exception:
        return False


def extract_audio_from_video(video_path: str, audio_path: str) -> Optional[str]:
    """`extract_audio_from_video:590`."""
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", "-i", video_path,
             "-vn", "-acodec", "copy", audio_path], check=True)
        return audio_path
    except Exception:
        return None


def make_video(frame_paths_or_dir, out_path: str, fps: float = 25.0,
               audio_path: Optional[str] = None) -> str:
    """Encode pngs to h264 mp4 (+ audio mux) — `make_video:54` +
    `fuse_video_audio_output:508`. cv2 VideoWriter fallback (no audio) on
    ffmpeg-less hosts."""
    if isinstance(frame_paths_or_dir, str):
        paths = list_frames(frame_paths_or_dir)
        pattern = os.path.join(frame_paths_or_dir, "frame_%08d.png")
    else:
        # symlink into a temp dir with a uniform pattern
        import tempfile

        paths = [os.path.abspath(p) for p in frame_paths_or_dir]
        tmp = tempfile.mkdtemp(prefix="ipercore_vid_")
        for i, p in enumerate(paths):
            os.symlink(p, os.path.join(tmp, f"frame_{i:08d}.png"))
        pattern = os.path.join(tmp, "frame_%08d.png")
    if has_ffmpeg():
        cmd = ["ffmpeg", "-y", "-loglevel", "error", "-framerate", str(fps),
               "-i", pattern]
        if audio_path and os.path.exists(audio_path):
            cmd += ["-i", audio_path, "-c:a", "aac", "-shortest"]
        cmd += ["-c:v", "libx264", "-pix_fmt", "yuv420p", out_path]
        subprocess.run(cmd, check=True)
        return out_path
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("neither ffmpeg nor cv2 available to encode video")
    first = read_png(paths[0])
    h, w = first.shape[:2]
    # mp4v is the most portable cv2-bundled encoder
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    for p in paths:
        writer.write(read_png(p)[..., ::-1])  # RGB -> BGR
    writer.release()
    return out_path


def fuse_side_by_side(rows: Sequence[Sequence[np.ndarray]]) -> np.ndarray:
    """Stack images into a grid (src | ref | out panels) —
    `fuse_src_ref_multi_outputs:451` visual layout, in-memory."""
    return np.concatenate([np.concatenate(list(r), axis=1) for r in rows], axis=0)
