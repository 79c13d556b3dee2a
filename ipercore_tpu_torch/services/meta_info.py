"""Input mini-language parsing + primitives directory layout.

Rebuilds `iPERCore/services/options/meta_info.py` (parse_effect_str:15,
parse_parts_str:50, SrcMetaInputInfo:97, RefMetaInputInfo:172, MetaProcess:268,
parse_ref_input:472, parse_src_input:522).

Grammar:
  inputs     := input ('|' input)*
  input      := bare_path | kv (',' kv)*
  kv         := key '?=' value
  src keys   := path, name, bg_path, parts ('-'-separated part names)
  ref keys   := path, name, audio, fps, pose_fc, cam_fc, effect
  effect     := sub (';' sub)*;  sub := 'View-<deg>' | 'BT-<frame>[-<dur>]'

The port's own copy of `ipercore_tpu/services/meta_info.py`, which imports no JAX;
the two read and write the same files.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional


def parse_effect_str(effect_str: str) -> dict:
    """`effect?=View-45;BT-30-180` -> {"View": 45.0, "BT": [(30, 180)]} —
    `meta_info.py:15-48`."""
    out: dict = {}
    for sub in effect_str.split(";"):
        if not sub:
            continue
        toks = sub.split("-")
        kind = toks[0]
        if kind == "View":
            out["View"] = float(toks[1])
        elif kind == "BT":
            frame = int(toks[1])
            dur = int(toks[2]) if len(toks) > 2 else 60
            out.setdefault("BT", []).append((frame, dur))
    return out


def parse_parts_str(parts_str: str) -> list[str]:
    """`parts?=head-torso` -> ["head", "torso"] — `meta_info.py:50-95`."""
    return [p for p in parts_str.split("-") if p]


def _parse_kv(s: str) -> dict:
    """Parse one `key1?=value1,key2?=value2` (or bare path) segment."""
    if "?=" not in s:
        return {"path": s}
    out = {}
    for pair in s.split(","):
        if not pair:
            continue
        if "?=" not in pair:
            continue
        kv = pair.split("?=")
        if len(kv) != 2 or not kv[1]:
            continue
        out[kv[0].strip()] = kv[1].strip()
    return out


@dataclass
class SrcMetaInfo:
    """Source input descriptor — `SrcMetaInputInfo:97`."""

    path: str = ""
    name: Optional[str] = None
    bg_path: str = ""
    parts: list = field(default_factory=lambda: ["all"])

    @classmethod
    def parse(cls, s: str) -> "SrcMetaInfo":
        kv = _parse_kv(s)
        info = cls(
            path=kv.get("path", ""),
            name=kv.get("name"),
            bg_path=kv.get("bg_path", ""),
        )
        if "parts" in kv:
            info.parts = parse_parts_str(kv["parts"])
        if info.name is None and info.path:
            info.name = os.path.split(info.path.rstrip("/"))[-1]
        return info

    def to_str(self) -> str:
        """Serialize back to the input mini-language (inverse of `parse`) —
        used by `post_update_opt` to rewrite opt.src_path with only the
        successfully-processed inputs."""
        kv = [f"path?={self.path}"]
        if self.name:
            kv.append(f"name?={self.name}")
        if self.bg_path:
            kv.append(f"bg_path?={self.bg_path}")
        if self.parts and self.parts != ["all"]:
            kv.append("parts?=" + "-".join(self.parts))
        return ",".join(kv)


@dataclass
class RefMetaInfo:
    """Reference input descriptor — `RefMetaInputInfo:172`."""

    path: str = ""
    name: Optional[str] = None
    audio: Optional[str] = None
    fps: float = 25.0
    fps_explicit: bool = False
    pose_fc: float = 300.0
    cam_fc: float = 100.0
    effect: dict = field(default_factory=dict)

    @classmethod
    def parse(cls, s: str) -> "RefMetaInfo":
        kv = _parse_kv(s)
        info = cls(path=kv.get("path", ""), name=kv.get("name"), audio=kv.get("audio"))
        if "fps" in kv:
            info.fps = float(kv["fps"])
            info.fps_explicit = True
        if "pose_fc" in kv:
            info.pose_fc = float(kv["pose_fc"])
        if "cam_fc" in kv:
            info.cam_fc = float(kv["cam_fc"])
        if "effect" in kv:
            info.effect = parse_effect_str(kv["effect"])
        if info.name is None and info.path:
            info.name = os.path.split(info.path.rstrip("/"))[-1]
        return info

    def to_str(self) -> str:
        """Serialize back to the input mini-language (inverse of `parse`)."""
        kv = [f"path?={self.path}"]
        if self.name:
            kv.append(f"name?={self.name}")
        if self.audio:
            kv.append(f"audio?={self.audio}")
        if self.fps_explicit:
            kv.append(f"fps?={self.fps}")
        kv.append(f"pose_fc?={self.pose_fc}")
        kv.append(f"cam_fc?={self.cam_fc}")
        if self.effect:
            subs = []
            if "View" in self.effect:
                subs.append(f"View-{self.effect['View']:g}")
            for frame, dur in self.effect.get("BT", []):
                subs.append(f"BT-{frame}-{dur}")
            kv.append("effect?=" + ";".join(subs))
        return ",".join(kv)

    def resolve_media(self, output_dir: str) -> "RefMetaInfo":
        """Fill fps/audio from the reference video via ffprobe/ffmpeg when not
        explicitly given — `MetaProcess` media extraction
        (`meta_info.py:288-303`). Extracted audio is cached next to the
        processed frames. No-op without ffmpeg or for image-folder inputs."""
        from ipercore_tpu_torch.utils import video as vid

        if not (self.path and os.path.isfile(self.path)
                and vid.is_video_file(self.path) and vid.has_ffmpeg()):
            return self
        if not self.fps_explicit:
            self.fps = vid.get_video_fps(self.path, default=self.fps)
        if self.audio is None and vid.check_video_has_audio(self.path):
            mp = MetaProcess(self.name, output_dir).make_dirs()
            audio_path = os.path.join(mp.processed_dir, "audio.aac")
            if not os.path.exists(audio_path):
                vid.extract_audio_from_video(self.path, audio_path)
            if os.path.exists(audio_path):
                self.audio = audio_path
        return self


def parse_src_input(src_input: str) -> list[SrcMetaInfo]:
    """`parse_src_input` (`meta_info.py:522-542`)."""
    return [SrcMetaInfo.parse(s) for s in src_input.split("|") if s]


def parse_ref_input(ref_input: str) -> list[RefMetaInfo]:
    """`parse_ref_input` (`meta_info.py:472-520`)."""
    return [RefMetaInfo.parse(s) for s in ref_input.split("|") if s]


@dataclass
class MetaProcess:
    """Primitive directories for one input — `MetaProcess:268`:
    `<output_dir>/primitives/<name>/{processed,synthesis}`."""

    name: str
    output_dir: str

    @property
    def primitives_dir(self) -> str:
        return os.path.join(self.output_dir, "primitives", self.name)

    @property
    def processed_dir(self) -> str:
        return os.path.join(self.primitives_dir, "processed")

    @property
    def synthesis_dir(self) -> str:
        return os.path.join(self.primitives_dir, "synthesis")

    @property
    def vid_info_path(self) -> str:
        return os.path.join(self.processed_dir, "vid_info.json")

    def make_dirs(self) -> "MetaProcess":
        os.makedirs(self.processed_dir, exist_ok=True)
        os.makedirs(self.synthesis_dir, exist_ok=True)
        return self


def checkpoints_dir(output_dir: str, model_id: str) -> str:
    """`<output_dir>/models/<model_id>/` (`options_setup.py:140-187`)."""
    d = os.path.join(output_dir, "models", model_id)
    os.makedirs(d, exist_ok=True)
    return d
