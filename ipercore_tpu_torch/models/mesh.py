"""Mesh / UV assets: OBJ loading, per-face UV coordinates, part labels, face
colour tables and k-nearest face tables.

Twin of `ipercore_tpu/models/mesh.py` and the port's own copy of its numpy
code: real asset files are read when `IPERCORE_TPU_ASSETS` names a directory
that holds them, otherwise a deterministic per-face UV atlas and height-band
part labels are derived from the body model. UV coordinates are in
grid-sample NDC (x right, y down), consistent with
`ipercore_tpu_torch.ops.rasterizer`.
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple, Union

import numpy as np
import torch

from ipercore_tpu_torch.models.smpl import SMPLModel, NUM_FACES

Device = Union[str, torch.device]

N_PARTS = 11  # 10 body parts + facial; reference PART_IDS (`flowcomposition.py:23`)

PART_IDS = {
    "head": [0],
    "torso": [1],
    "left_leg": [2],
    "right_leg": [3],
    "left_arm": [4],
    "right_arm": [5],
    "left_foot": [6],
    "right_foot": [7],
    "left_hand": [8],
    "right_hand": [9],
    "facial": [10],
    "upper": [1, 4, 5, 8, 9],
    "lower": [2, 3, 6, 7],
    "body": [1, 2, 3, 4, 5, 6, 7, 8, 9],
    "all": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9],
}

def find_asset(name: str) -> str | None:
    """Resolve an asset file by name in the directory `IPERCORE_TPU_ASSETS`
    names; None when the variable is unset or the file is absent."""
    d = os.environ.get("IPERCORE_TPU_ASSETS", "")
    if d:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


class MeshAssets(NamedTuple):
    """Static per-face tables consumed by the flow composition.

    obj_faces: (F, 3) int32 indices into the UV template's vertex list.
    f2uvs: (F, 3, 2) f32 per-face UV coords in grid-sample NDC — usable both
        as rasterizer input (UV-space fim/wim) and as flow sources (Tuv2t).
    face_parts: (F,) int32 part label per face in [0, N_PARTS).
    map_fn: (F + 1, 3) f32 face -> RGB condition color (last row background).
    face_k_nearest: (F, K) int32 k-nearest faces (UV-space, within part).
    front_face_mask / facial_face_mask: (F,) bool — faces counted by the
        find-front preprocessing stage (`preprocessors.py:257`).
    """

    obj_faces: torch.Tensor
    f2uvs: torch.Tensor
    face_parts: torch.Tensor
    map_fn: torch.Tensor
    face_k_nearest: torch.Tensor
    front_face_mask: torch.Tensor
    facial_face_mask: torch.Tensor


def load_obj(path: str) -> dict:
    """Minimal OBJ reader: vertices, UV coords (vt) and triangular faces.

    The reference templates (`mapper_uv.txt`, `mapper_fim_enc.txt`) store the
    SMPL template as `v` lines, the UV unwrap as `vt` lines, and faces in
    `f v/vt v/vt v/vt` form (6890 v / 7576 vt / 13776 f).
    """
    verts, uvs, faces, uv_faces = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(t) for t in line.split()[1:3]])
            elif line.startswith("f "):
                toks = line.split()[1:]
                vi = [int(t.split("/")[0]) - 1 for t in toks]
                ti = [
                    int(t.split("/")[1]) - 1 if ("/" in t and t.split("/")[1]) else -1
                    for t in toks
                ]
                for k in range(1, len(vi) - 1):  # fan-triangulate
                    faces.append([vi[0], vi[k], vi[k + 1]])
                    uv_faces.append([ti[0], ti[k], ti[k + 1]])
    return {
        "vertices": np.asarray(verts, np.float32),
        "uvs": np.asarray(uvs, np.float32) if uvs else None,
        "faces": np.asarray(faces, np.int32),
        "uv_faces": np.asarray(uv_faces, np.int32) if uvs else None,
    }


def uv_to_ndc(uv: np.ndarray) -> np.ndarray:
    """[0,1]^2 UV -> grid-sample NDC, v axis flipped so v=1 is the top row."""
    x = uv[..., 0] * 2.0 - 1.0
    y = (1.0 - uv[..., 1]) * 2.0 - 1.0
    return np.stack([x, y], axis=-1)


def _faces_to_f2uvs(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(V, >=2) verts + (F, 3) faces -> (F, 3, 2) per-face NDC coords.

    The reference templates store UV as vertex xy in [0, 1]
    (`mesh.get_f2vts:246` maps them to [-1, 1]).
    """
    uv = verts[:, :2]
    f2 = uv[faces]  # (F, 3, 2)
    return uv_to_ndc(f2)


def synthetic_uv_atlas(n_faces: int = NUM_FACES) -> tuple[np.ndarray, np.ndarray]:
    """Per-face triangle atlas: each face owns a tiny right triangle in a grid.

    Guarantees non-overlapping, orientation-consistent UV coverage for any mesh
    — the invariant the flow composition needs (each UV pixel belongs to at
    most one face). Returns (uv_verts (3F, 2) in [0,1], obj_faces (F, 3)).
    """
    cols = int(np.ceil(np.sqrt(n_faces)))
    rows = int(np.ceil(n_faces / cols))
    cell_w, cell_h = 1.0 / cols, 1.0 / rows
    ids = np.arange(n_faces)
    cx = (ids % cols) * cell_w
    cy = (ids // cols) * cell_h
    pad_x, pad_y = 0.12 * cell_w, 0.12 * cell_h
    v0 = np.stack([cx + pad_x, cy + pad_y], axis=-1)
    v1 = np.stack([cx + cell_w - pad_x, cy + pad_y], axis=-1)
    v2 = np.stack([cx + pad_x, cy + cell_h - pad_y], axis=-1)
    uv_verts = np.stack([v0, v1, v2], axis=1).reshape(-1, 2)  # (3F, 2)
    obj_faces = ids[:, None] * 3 + np.arange(3)[None, :]
    return uv_verts.astype(np.float32), obj_faces.astype(np.int32)


def synthetic_face_parts(model: SMPLModel, n_faces: int = NUM_FACES) -> np.ndarray:
    """Height/side bands of the template mesh -> 11 part labels per face."""
    v = model.v_template.cpu().numpy()
    faces = model.faces.cpu().numpy()
    centers = v[faces].mean(axis=1)  # (F, 3)
    y = centers[:, 1]
    x = centers[:, 0]
    z = centers[:, 2]
    parts = np.full((n_faces,), 1, np.int32)  # default torso
    parts[y > 0.62] = 0  # head
    parts[(y > 0.66) & (z > 0.0)] = 10  # facial (front of head)
    arm = (np.abs(x) > 0.22) & (y > 0.0) & (y <= 0.62)
    parts[arm & (x > 0)] = 4
    parts[arm & (x < 0)] = 5
    hand = (np.abs(x) > 0.3) & (y > 0.0) & (y <= 0.4)
    parts[hand & (x > 0)] = 8
    parts[hand & (x < 0)] = 9
    leg = (y < -0.3) & (y >= -0.75)
    parts[leg & (x > 0)] = 2
    parts[leg & (x <= 0)] = 3
    foot = y < -0.75
    parts[foot & (x > 0)] = 6
    parts[foot & (x <= 0)] = 7
    return parts


# A fixed, maximally-separated color table for part condition encoding
# (role of `mesh.create_mapping` "uv_seg" mode, `mesh.py:477`). Values in [0, 1].
_PART_COLORS = np.array(
    [
        [1.0, 0.0, 0.0],  # head
        [0.0, 1.0, 0.0],  # torso
        [0.0, 0.0, 1.0],  # left leg
        [1.0, 1.0, 0.0],  # right leg
        [1.0, 0.0, 1.0],  # left arm
        [0.0, 1.0, 1.0],  # right arm
        [0.5, 0.25, 0.0],  # left foot
        [0.25, 0.0, 0.5],  # right foot
        [1.0, 0.5, 0.0],  # left hand
        [0.0, 0.5, 1.0],  # right hand
        [1.0, 0.75, 0.8],  # facial
    ],
    np.float32,
)


def build_map_fn(face_parts: np.ndarray, background=(0.0, 0.0, 0.0)) -> np.ndarray:
    """(F,) part labels -> (F+1, 3) face color table; last row = background."""
    colors = _PART_COLORS[face_parts]  # (F, 3)
    bg = np.asarray(background, np.float32)[None]
    return np.concatenate([colors, bg], axis=0).astype(np.float32)


def find_part_k_nearest_faces(f2uvs: np.ndarray, face_parts: np.ndarray, k: int = 3) -> np.ndarray:
    """Per-face k-nearest faces within the same part, by UV barycenter distance.

    Reference parity: `mesh.find_part_k_nearest_faces:298` (used for the
    visible-face dilation in `nmr.get_vis_f2pts:639`).
    """
    centers = f2uvs.mean(axis=1).astype(np.float32)  # (F, 2)
    F = centers.shape[0]
    out = np.zeros((F, k), np.int64)
    for p in np.unique(face_parts):
        ids = np.nonzero(face_parts == p)[0]
        c = centers[ids]  # (n, 2)
        kk = min(k, len(ids))
        # chunk the row axis so memory stays bounded for big parts
        sel = np.empty((len(ids), kk), np.int64)
        chunk = max(1, int(4e7) // max(len(ids), 1))
        for s in range(0, len(ids), chunk):
            d2 = ((c[s:s + chunk, None, :] - c[None, :, :]) ** 2).sum(-1)
            sel[s:s + chunk] = np.argpartition(d2, kth=kk - 1, axis=1)[:, :kk]
        sel = ids[sel]
        if kk < k:  # pad with self
            sel = np.concatenate([sel, np.tile(ids[:, None], (1, k - kk))], axis=1)
        out[ids] = sel
    return out.astype(np.int32)


def load_assets(
    model: SMPLModel,
    uv_map_path: str | None = None,
    fim_enc_path: str | None = None,
    part_path: str | None = None,
    front_path: str | None = None,
    facial_path: str | None = None,
    k_nearest: int = 3,
    device: Device = "cuda",
    synthetic: bool = False,
) -> MeshAssets:
    """Build MeshAssets from real reference asset files when available,
    otherwise synthesize deterministic equivalents from the body model.

    Note: `fim_enc_path`/`uv_map_path` in the reference are two UV templates
    with identical topology (`nmr.py:167-209`): `mapper_fim_enc.txt` drives the
    image->UV direction and parts, `mapper_uv.txt` the UV->image direction.
    Here a single template serves both directions (they are mutually inverse
    by construction in our convention). `synthetic=True` derives the UV atlas
    and the part labels from the body model whatever files exist, as the JAX
    package's `build_runtime` does for its smoke model.
    """
    if synthetic:
        uv_map_path = part_path = None
    else:
        uv_map_path = uv_map_path or find_asset("mapper_uv.txt")
        part_path = part_path or find_asset("smpl_part_info.json")
    front_path = front_path or find_asset("front_body.json")
    facial_path = facial_path or find_asset("front_facial.json")

    n_faces = int(model.faces.shape[0])

    if uv_map_path and os.path.exists(uv_map_path):
        obj = load_obj(uv_map_path)
        if obj["uvs"] is not None:
            obj_faces = obj["uv_faces"][:n_faces]
            f2uvs = uv_to_ndc(obj["uvs"][obj_faces])
        else:
            obj_faces = obj["faces"][:n_faces]
            f2uvs = _faces_to_f2uvs(obj["vertices"], obj_faces)
    else:
        uv_verts, obj_faces = synthetic_uv_atlas(n_faces)
        f2uvs = uv_to_ndc(uv_verts[obj_faces])

    if part_path and os.path.exists(part_path):
        with open(part_path) as f:
            part_info = json.load(f)
        face_parts = np.full((n_faces,), 1, np.int32)
        # reference JSON (`smpl_part_info.json`): keys like "00_head" mapping to
        # {"vertex": [...], "face": [...]} (consumed by `mesh.get_part_ids:356`).
        for name, val in part_info.items():
            key = name.split("_", 1)[-1] if name[:2].isdigit() else name
            key = key.lower()
            if key.startswith("facial"):
                key = "facial"
            if key not in PART_IDS or len(PART_IDS[key]) != 1:
                continue
            label = PART_IDS[key][0]
            ids = val["face"] if isinstance(val, dict) else val
            fids = np.asarray(ids, np.int64).ravel()
            fids = fids[(fids >= 0) & (fids < n_faces)]
            face_parts[fids] = label
    else:
        face_parts = synthetic_face_parts(model, n_faces)

    def _face_set(path, fallback_mask):
        if path and os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            # reference front_*.json: {"vertex": [...], "face": [...]} — only
            # the face ids label faces (vertex ids would alias as bogus faces)
            if isinstance(data, dict):
                ids = np.asarray(data.get("face", []), np.int64).ravel()
            else:
                ids = np.asarray(data, np.int64).ravel()
            mask = np.zeros((n_faces,), bool)
            ids = ids[(ids >= 0) & (ids < n_faces)]
            mask[ids] = True
            return mask
        return fallback_mask

    front_mask = _face_set(front_path, face_parts == 1)
    facial_mask = _face_set(facial_path, face_parts == 10)

    map_fn = build_map_fn(face_parts)
    fkn = find_part_k_nearest_faces(f2uvs, face_parts, k=k_nearest)

    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt), device=device)
    return MeshAssets(
        obj_faces=t(obj_faces, np.int64),
        f2uvs=t(f2uvs, np.float32),
        face_parts=t(face_parts, np.int64),
        map_fn=t(map_fn, np.float32),
        face_k_nearest=t(fkn, np.int64),
        front_face_mask=t(front_mask, bool),
        facial_face_mask=t(facial_mask, bool),
    )


def part_face_mask(assets: MeshAssets, part_names: list[str]) -> torch.Tensor:
    """(F,) bool mask of faces belonging to any of the named parts."""
    labels: set[int] = set()
    for name in part_names:
        labels.update(PART_IDS[name])
    table = np.zeros((N_PARTS,), bool)
    for label in labels:
        table[label] = True
    return torch.as_tensor(table, device=assets.face_parts.device)[assets.face_parts]
