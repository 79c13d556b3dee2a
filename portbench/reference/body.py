"""The body model and its UV atlas, as numpy arrays.

These are inputs of every imitation cell: the benchmark builds them once and
hands the same arrays to the program and to the reference. The repository
ships no SMPL template files, so the body is the deterministic stand-in with
SMPL's cardinalities (6890 vertices, 13 776 faces, 24 joints): a UV sphere
pressed into a humanoid silhouette with smooth skinning and small seeded
blend shapes. The UV atlas gives each face its own small right triangle in a
grid, and the part labels come from height and side bands of the template.
The formulas follow the published description of the port's template
(`synthetic_model`, `synthetic_uv_atlas`, `synthetic_face_parts`), written
out here so that the benchmark depends on no code of the program.
"""
from __future__ import annotations

import numpy as np

NUM_SHAPE = 10
NUM_JOINTS = 24
NUM_COCOPLUS_JOINTS = 19
# 10 body parts + the face, and one colour per part for the condition map
PART_COLORS = np.array(
    [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 1.0, 0.0],
     [1.0, 0.0, 1.0], [0.0, 1.0, 1.0], [0.5, 0.25, 0.0], [0.25, 0.0, 0.5],
     [1.0, 0.5, 0.0], [0.0, 0.5, 1.0], [1.0, 0.75, 0.8]], np.float32)


def body_arrays(seed: int = 0, nu: int = 84, nv: int = 82) -> dict:
    """The template body: v_template (V, 3), shapedirs (V, 3, 10), posedirs
    (V, 3, 207), j_regressor (24, V), lbs_weights (V, 24), parents (24,),
    joint_regressor (19, V), faces (F, 3) int32, hands_mean (0,)."""
    rng = np.random.RandomState(seed)
    V = nu * nv + 2
    thetas = np.pi * (np.arange(1, nv + 1)) / (nv + 1)
    phis = 2 * np.pi * np.arange(nu) / nu
    tg, pg = np.meshgrid(thetas, phis, indexing="ij")
    x = np.sin(tg) * np.cos(pg)
    y = np.cos(tg)
    z = np.sin(tg) * np.sin(pg)
    r = 0.28 + 0.1 * np.sin(np.pi * (y + 1) / 2) - 0.08 * np.exp(-((y - 0.72) ** 2) / 0.01)
    grid = np.stack([x * r, y * 0.95, z * r], axis=-1).reshape(-1, 3)
    poles = np.array([[0.0, 0.97, 0.0], [0.0, -0.97, 0.0]])
    v_template = np.concatenate([poles[:1], grid, poles[1:]], axis=0).astype(np.float32)

    def vid(i, j):
        return 1 + i * nu + (j % nu)

    faces = [[0, vid(0, j), vid(0, j + 1)] for j in range(nu)]
    for i in range(nv - 1):
        for j in range(nu):
            a, b, c, d = vid(i, j), vid(i, j + 1), vid(i + 1, j), vid(i + 1, j + 1)
            faces += [[a, b, c], [b, d, c]]
    faces += [[V - 1, vid(nv - 1, j + 1), vid(nv - 1, j)] for j in range(nu)]
    faces = np.asarray(faces, np.int32)

    J = NUM_JOINTS
    parents = np.zeros((J,), np.int32)
    joints = np.zeros((J, 3), np.float32)
    joints[0] = [0, -0.2, 0]
    for i in range(1, J):
        parents[i] = max(0, (i - 1) // 2)
        direction = rng.randn(3) * 0.1
        joints[i] = joints[parents[i]] + direction + [0, 0.05, 0]
    d2 = ((v_template[None, :, :] - joints[:, None, :]) ** 2).sum(-1)  # (J, V)
    jr = np.exp(-d2 / 0.02)
    j_regressor = (jr / jr.sum(axis=1, keepdims=True)).astype(np.float32)
    w = np.exp(-d2.T / 0.05)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    shapedirs = (rng.randn(V, 3, NUM_SHAPE) * 0.01).astype(np.float32)
    posedirs = (rng.randn(V, 3, 9 * (J - 1)) * 0.001).astype(np.float32)
    cjr = np.stack([j_regressor[k % J] for k in range(NUM_COCOPLUS_JOINTS)]).astype(np.float32)
    return {"v_template": v_template, "shapedirs": shapedirs, "posedirs": posedirs,
            "j_regressor": j_regressor, "lbs_weights": lbs_weights, "parents": parents,
            "joint_regressor": cjr, "faces": faces, "hands_mean": np.zeros((0,), np.float32)}


def uv_atlas(n_faces: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-face triangles in a grid: obj_faces (F, 3) and f2uvs (F, 3, 2) in
    grid-sample coordinates (x right, y down, v = 1 is the top row)."""
    cols = int(np.ceil(np.sqrt(n_faces)))
    rows = int(np.ceil(n_faces / cols))
    cw, ch = 1.0 / cols, 1.0 / rows
    ids = np.arange(n_faces)
    cx, cy = (ids % cols) * cw, (ids // cols) * ch
    px, py = 0.12 * cw, 0.12 * ch
    v0 = np.stack([cx + px, cy + py], -1)
    v1 = np.stack([cx + cw - px, cy + py], -1)
    v2 = np.stack([cx + px, cy + ch - py], -1)
    uv = np.stack([v0, v1, v2], axis=1).reshape(-1, 2).astype(np.float32)
    obj_faces = (ids[:, None] * 3 + np.arange(3)[None, :]).astype(np.int32)
    f = uv[obj_faces]
    f2uvs = np.stack([f[..., 0] * 2.0 - 1.0, (1.0 - f[..., 1]) * 2.0 - 1.0], axis=-1)
    return obj_faces, f2uvs.astype(np.float32)


def face_parts(v_template: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """11 part labels per face from height and side bands of the template."""
    c = v_template[faces].mean(axis=1)
    x, y, z = c[:, 0], c[:, 1], c[:, 2]
    parts = np.full((faces.shape[0],), 1, np.int32)
    parts[y > 0.62] = 0
    parts[(y > 0.66) & (z > 0.0)] = 10
    arm = (np.abs(x) > 0.22) & (y > 0.0) & (y <= 0.62)
    parts[arm & (x > 0)] = 4
    parts[arm & (x < 0)] = 5
    hand = (np.abs(x) > 0.3) & (y > 0.0) & (y <= 0.4)
    parts[hand & (x > 0)] = 8
    parts[hand & (x < 0)] = 9
    leg = (y < -0.3) & (y >= -0.75)
    parts[leg & (x > 0)] = 2
    parts[leg & (x <= 0)] = 3
    parts[(y < -0.75) & (x > 0)] = 6
    parts[(y < -0.75) & (x <= 0)] = 7
    return parts


def k_nearest_faces(f2uvs: np.ndarray, parts: np.ndarray, k: int = 3) -> np.ndarray:
    """(F, k) nearest faces of the same part by UV barycentre distance."""
    centers = f2uvs.mean(axis=1).astype(np.float32)
    out = np.zeros((centers.shape[0], k), np.int64)
    for p in np.unique(parts):
        ids = np.nonzero(parts == p)[0]
        c = centers[ids]
        kk = min(k, len(ids))
        sel = np.empty((len(ids), kk), np.int64)
        step = max(1, int(4e7) // max(len(ids), 1))
        for s in range(0, len(ids), step):
            d2 = ((c[s:s + step, None, :] - c[None, :, :]) ** 2).sum(-1)
            sel[s:s + step] = np.argpartition(d2, kth=kk - 1, axis=1)[:, :kk]
        sel = ids[sel]
        if kk < k:
            sel = np.concatenate([sel, np.tile(ids[:, None], (1, k - kk))], axis=1)
        out[ids] = sel
    return out.astype(np.int32)


def mesh_arrays(body: dict) -> dict:
    """The per-face tables: obj_faces, f2uvs, face_parts, map_fn (F + 1, 3)
    with a black background row, face_k_nearest (F, 3), and the front and
    facial face masks."""
    faces = body["faces"]
    obj_faces, f2uvs = uv_atlas(faces.shape[0])
    parts = face_parts(body["v_template"], faces)
    map_fn = np.concatenate([PART_COLORS[parts], np.zeros((1, 3), np.float32)]).astype(np.float32)
    return {"obj_faces": obj_faces, "f2uvs": f2uvs, "face_parts": parts, "map_fn": map_fn,
            "face_k_nearest": k_nearest_faces(f2uvs, parts), "front_face_mask": parts == 1,
            "facial_face_mask": parts == 10}
