"""ProcessInfo: the resumable preprocessing manifest.

Rebuilds `iPERCore/services/options/process_info.py:10-379`: a per-input
checkpoint of every preprocessing stage (`has_run_*` flags + per-stage
sub-dicts), serialized as JSON + a sibling .npz of array payloads (the
reference pickles everything into `vid_info.pkl`). Stage granularity makes
crashed runs resume where they stopped (SURVEY.md §5, failure detection).

The port's own copy of `ipercore_tpu/services/process_info.py`, which imports no JAX;
the two read and write the same files.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np

STAGES = (
    "detector",
    "cropper",
    "pose3d",
    "parser",
    "find_front",
    "inpaintor",
    "deform",
)


class ProcessInfo:
    """dict-like manifest with per-stage flags and array payloads."""

    def __init__(self, processed_dir: str, name: str = ""):
        self.processed_dir = processed_dir
        self.name = name
        self.meta: dict[str, Any] = {
            "name": name,
            "has_run": {s: False for s in STAGES},
            "stages": {s: {} for s in STAGES},
            "valid_img_names": [],
        }
        self.arrays: dict[str, np.ndarray] = {}

    # --- stage flags ------------------------------------------------------
    def has_run(self, stage: str) -> bool:
        return bool(self.meta["has_run"].get(stage, False))

    def mark_run(self, stage: str, **stage_meta) -> None:
        self.meta["has_run"][stage] = True
        self.meta["stages"].setdefault(stage, {}).update(stage_meta)

    def check_has_been_processed(self, stages=("detector", "cropper", "pose3d", "parser", "find_front", "inpaintor")) -> bool:
        """`check_has_been_processed:150` — all required stages done."""
        return all(self.has_run(s) for s in stages)

    # --- payload ----------------------------------------------------------
    def set_array(self, key: str, value: np.ndarray) -> None:
        self.arrays[key] = np.asarray(value)

    def get_array(self, key: str) -> Optional[np.ndarray]:
        return self.arrays.get(key)

    @property
    def json_path(self) -> str:
        return os.path.join(self.processed_dir, "vid_info.json")

    @property
    def npz_path(self) -> str:
        return os.path.join(self.processed_dir, "vid_info.npz")

    # --- (de)serialization — `serialize:136` / `deserialize:140` ----------
    def serialize(self) -> None:
        os.makedirs(self.processed_dir, exist_ok=True)
        tmp = self.json_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.meta, f, indent=1)
        os.replace(tmp, self.json_path)
        if self.arrays:
            tmp_npz = self.npz_path + ".tmp.npz"
            np.savez_compressed(tmp_npz, **self.arrays)
            os.replace(tmp_npz, self.npz_path)

    @classmethod
    def deserialize(cls, processed_dir: str) -> "ProcessInfo":
        info = cls(processed_dir)
        if os.path.exists(info.json_path):
            with open(info.json_path) as f:
                info.meta = json.load(f)
            info.name = info.meta.get("name", "")
        if os.path.exists(info.npz_path):
            with np.load(info.npz_path) as z:
                info.arrays = {k: z[k] for k in z.files}
        return info

    # --- views — `read_src_infos:207` / `read_ref_infos:178` --------------
    def read_src_info(self, num_source: int = 2) -> dict:
        """Pick ns/2 front + ns/2 back source frame ids (front-count order),
        pad offsets/links to (6890, 3) — `read_src_infos:207-300`."""
        smpls = self.get_array("smpls")
        ft_ids = self.get_array("ft_ids")
        bk_ids = self.get_array("bk_ids")
        n = 0 if smpls is None else len(smpls)
        ids: list[int] = []
        if ft_ids is not None and len(ft_ids):
            ids.extend(int(i) for i in ft_ids[: (num_source + 1) // 2])
        if bk_ids is not None and len(bk_ids):
            ids.extend(int(i) for i in bk_ids[: num_source // 2])
        if not ids:
            ids = list(range(min(num_source, max(n, 1))))
        while len(ids) < num_source and n:
            ids.append(ids[len(ids) % max(len(ids), 1)])
        ids = ids[:num_source]

        offsets = self.get_array("offsets")  # None when the deform stage didn't run
        links = self.get_array("links_ids")
        out = {
            "src_ids": ids,
            "smpls": smpls[ids] if smpls is not None else None,
            "offsets": offsets,
            "links_ids": links,
            "img_names": [self.meta["valid_img_names"][i] for i in ids]
            if self.meta["valid_img_names"] else [],
        }
        return out

    def read_ref_info(self) -> dict:
        """All frames' smpls in order — `read_ref_infos:178-205`."""
        return {
            "smpls": self.get_array("smpls"),
            "img_names": list(self.meta["valid_img_names"]),
        }
