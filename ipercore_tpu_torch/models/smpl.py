"""Functional SMPL / SMPL-H body model (linear blend skinning) in PyTorch.

Twin of `ipercore_tpu/models/smpl.py`: a `SMPLModel` tuple of constant tensors
and pure functions over it. The model arrays are built with numpy from the
same seeds and formulas as the JAX package, so both hold identical meshes; the
batch axis that JAX adds with `vmap` is written out here.

The 85-dim theta layout is kept: (cam 3 | pose 72 | shape 10). SMPL-H models
(52 joints) pad a 72-dim pose with the model's mean hand pose.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ipercore_tpu_torch.ops.rotations import rodrigues

NUM_VERTS = 6890
NUM_FACES = 13776
NUM_JOINTS_SMPL = 24
NUM_SHAPE = 10
NUM_COCOPLUS_JOINTS = 19
THETA_DIM = 85  # 3 cam + 72 pose + 10 shape
THETA_DIM_HAND = 156 + 3 + 10  # an SMPL-H theta (156-dim pose)

Device = Union[str, torch.device]


class KinematicChain(NamedTuple):
    """The kinematic tree's index tensors, built once on the model's device so
    that the LBS indexes with device tensors and never copies an index from
    the host (each such copy is a host sync on a CUDA device).

    parents: (J,) int64; levels: one (joint ids, their parents' ids) pair of
    int64 tensors per depth of the tree, root excluded; bottom: (4,) f32 row
    (0, 0, 0, 1) of the homogeneous transforms.
    """

    parents: torch.Tensor
    levels: tuple
    bottom: torch.Tensor


def _kinematic_chain(parents: np.ndarray, device: Device) -> KinematicChain:
    J = parents.shape[0]
    depth = np.zeros(J, np.int64)
    for j in range(1, J):
        depth[j] = depth[parents[j]] + 1
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    levels = []
    for d in range(1, int(depth.max()) + 1):
        ids = np.nonzero(depth == d)[0]
        levels.append((idx(ids), idx(parents[ids])))
    return KinematicChain(parents=idx(parents), levels=tuple(levels),
                          bottom=torch.tensor([0.0, 0.0, 0.0, 1.0], device=device))


class SMPLModel(NamedTuple):
    """Constant tensors defining a body model (f32 / int64, on one device).

    v_template: (V, 3); shapedirs: (V, 3, 10); posedirs: (V, 3, 9*(J-1));
    j_regressor: (J, V); lbs_weights: (V, J); joint_regressor: (19, V);
    faces: (F, 3) int64; hands_mean: (pose_dim - 66,) (empty for SMPL).
    parents: (J,) numpy int32, the kinematic tree on the host; chain: the
    same tree as index tensors on the model's device.
    """

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    j_regressor: torch.Tensor
    lbs_weights: torch.Tensor
    parents: np.ndarray
    joint_regressor: torch.Tensor
    faces: torch.Tensor
    hands_mean: torch.Tensor
    chain: KinematicChain

    @property
    def n_joints(self) -> int:
        return int(self.parents.shape[0])

    @property
    def pose_dim(self) -> int:
        return self.n_joints * 3


def _to_model(device: Device, *, v_template, shapedirs, posedirs, j_regressor,
              lbs_weights, parents, joint_regressor, faces, hands_mean) -> SMPLModel:
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    return SMPLModel(
        v_template=f32(v_template),
        shapedirs=f32(shapedirs),
        posedirs=f32(posedirs),
        j_regressor=f32(j_regressor),
        lbs_weights=f32(lbs_weights),
        parents=np.asarray(parents, np.int32),
        joint_regressor=f32(joint_regressor),
        faces=torch.as_tensor(np.asarray(faces, np.int64), device=device),
        hands_mean=f32(hands_mean),
        chain=_kinematic_chain(np.asarray(parents, np.int32), device),
    )


def _np(x):
    """Convert possibly-chumpy/scipy-sparse arrays from SMPL pickles to numpy."""
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    if hasattr(x, "r"):
        return np.asarray(x.r)
    return np.asarray(x)


def load_model(path: str, device: Device = "cuda") -> SMPLModel:
    """Load a standard SMPL/SMPL-H pickle into an `SMPLModel`.

    The pickle is the licensed SMPL model file the user supplies; like any
    pickle it must come from a trusted source.
    """
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    v_template = _np(data["v_template"]).astype(np.float32)
    shapedirs = _np(data["shapedirs"]).astype(np.float32)[..., :NUM_SHAPE]
    posedirs = _np(data["posedirs"]).astype(np.float32)
    j_regressor = _np(data["J_regressor"]).astype(np.float32)
    lbs_weights = _np(data["weights"]).astype(np.float32)
    parents = _np(data["kintree_table"])[0].astype(np.int32)
    parents[0] = 0
    faces = _np(data["f"]).astype(np.int32)
    n_joints = j_regressor.shape[0]
    if "cocoplus_regressor" in data:
        joint_regressor = _np(data["cocoplus_regressor"]).astype(np.float32)
    elif "joint_regressor" in data:
        jr = _np(data["joint_regressor"]).astype(np.float32)
        joint_regressor = jr.T if jr.shape[0] == v_template.shape[0] else jr
    else:
        joint_regressor = j_regressor[:NUM_COCOPLUS_JOINTS]
    if n_joints > 24 and "hands_mean" in data:
        hands_mean = _np(data["hands_mean"]).astype(np.float32)
    elif n_joints > 24:
        hands_mean = np.zeros((n_joints * 3 - 66,), np.float32)
    else:
        hands_mean = np.zeros((0,), np.float32)

    return _to_model(
        device, v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
        j_regressor=j_regressor, lbs_weights=lbs_weights, parents=parents,
        joint_regressor=joint_regressor, faces=faces, hands_mean=hands_mean)


def synthetic_model(
    n_joints: int = NUM_JOINTS_SMPL, seed: int = 0, nu: int = 84, nv: int = 82,
    device: Device = "cuda",
) -> SMPLModel:
    """Deterministic body-shaped stand-in with exact SMPL cardinalities.

    A UV-sphere (nu x nv grid + 2 poles; default 84 x 82 -> 6890 verts, 13776
    faces) squashed into a rough humanoid silhouette, with smooth
    distance-based skinning weights and small random blendshapes. Built with
    numpy exactly as the JAX twin builds it. Pass smaller (nu, nv) for cheap
    test meshes.
    """
    rng = np.random.RandomState(seed)
    V = nu * nv + 2

    thetas = np.pi * (np.arange(1, nv + 1)) / (nv + 1)
    phis = 2 * np.pi * np.arange(nu) / nu
    tg, pg = np.meshgrid(thetas, phis, indexing="ij")
    x = np.sin(tg) * np.cos(pg)
    y = np.cos(tg)
    z = np.sin(tg) * np.sin(pg)
    r = 0.28 + 0.1 * np.sin(np.pi * (y + 1) / 2) - 0.08 * np.exp(-((y - 0.72) ** 2) / 0.01)
    verts_grid = np.stack([x * r, y * 0.95, z * r], axis=-1).reshape(-1, 3)
    poles = np.array([[0.0, 0.97, 0.0], [0.0, -0.97, 0.0]])
    v_template = np.concatenate([poles[:1], verts_grid, poles[1:]], axis=0).astype(np.float32)
    if v_template.shape[0] != V:
        raise ValueError(f"vertex count {v_template.shape[0]} != {V}")

    def vid(i, j):  # ring i (0..nv-1), column j (0..nu-1)
        return 1 + i * nu + (j % nu)

    faces = []
    for j in range(nu):  # top cap
        faces.append([0, vid(0, j), vid(0, j + 1)])
    for i in range(nv - 1):
        for j in range(nu):
            a, b, c, d = vid(i, j), vid(i, j + 1), vid(i + 1, j), vid(i + 1, j + 1)
            faces.append([a, b, c])
            faces.append([b, d, c])
    last = V - 1
    for j in range(nu):  # bottom cap
        faces.append([last, vid(nv - 1, j + 1), vid(nv - 1, j)])
    faces = np.asarray(faces, np.int32)

    J = n_joints
    parents = np.zeros((J,), np.int32)
    joints = np.zeros((J, 3), np.float32)
    joints[0] = [0, -0.2, 0]
    for i in range(1, min(J, 24)):
        parents[i] = max(0, (i - 1) // 2)
        direction = rng.randn(3) * 0.1
        joints[i] = joints[parents[i]] + direction + [0, 0.05, 0]
    for i in range(24, J):  # hand joints for SMPL-H
        parents[i] = 20 + (i % 2)
        joints[i] = joints[parents[i]] + rng.randn(3) * 0.02

    d2 = ((v_template[None, :, :] - joints[:, None, :]) ** 2).sum(-1)  # (J, V)
    jr = np.exp(-d2 / 0.02)
    j_regressor = (jr / jr.sum(axis=1, keepdims=True)).astype(np.float32)

    w = np.exp(-d2.T / 0.05)  # (V, J)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    shapedirs = (rng.randn(V, 3, NUM_SHAPE) * 0.01).astype(np.float32)
    posedirs = (rng.randn(V, 3, 9 * (J - 1)) * 0.001).astype(np.float32)

    cjr = np.zeros((NUM_COCOPLUS_JOINTS, V), np.float32)
    for k in range(NUM_COCOPLUS_JOINTS):
        cjr[k] = j_regressor[k % min(J, 24)]

    hands_mean = ((rng.randn(max(J * 3 - 66, 0)) * 0.05).astype(np.float32)
                  if J > 24 else np.zeros((0,), np.float32))

    return _to_model(
        device, v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
        j_regressor=j_regressor, lbs_weights=lbs_weights, parents=parents,
        joint_regressor=cjr, faces=faces, hands_mean=hands_mean)


# SMPL kinematic tree (24 joints).
_SMPL_PARENTS = np.array(
    [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    np.int32)
# cocoplus-19 -> SMPL-24 joint correspondence (approximate; face kps -> head).
_COCOPLUS_FROM_SMPL = np.array(
    [8, 5, 2, 1, 4, 7, 21, 19, 17, 16, 18, 20, 12, 15, 15, 15, 15, 15, 15], np.int32)


def _band_centroid(pts: np.ndarray, axis_vals: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Centroid of the points whose axis value lies in the [lo, hi] quantile band."""
    a, b = np.quantile(axis_vals, [lo, hi])
    sel = (axis_vals >= a) & (axis_vals <= b)
    return pts[sel].mean(axis=0)


def template_model(
    uv_map_path: str | None = None,
    part_path: str | None = None,
    seed: int = 0,
    device: Device = "cuda",
) -> SMPLModel:
    """Body model on the real SMPL template when its files are present:
    geometry and topology from the `mapper_uv.txt` OBJ, a skeleton derived from
    `smpl_part_info.json` part vertex sets and synthesized smooth skinning.
    The template is stored y-up and is flipped so the rest pose matches the
    screen convention (y down).

    Falls back to `synthetic_model()` when the asset files are absent, exactly
    as the JAX twin does.
    """
    from ipercore_tpu_torch.models.mesh import find_asset, load_obj

    uv_map_path = uv_map_path or find_asset("mapper_uv.txt")
    part_path = part_path or find_asset("smpl_part_info.json")
    if not (uv_map_path and part_path):
        return synthetic_model(seed=seed, device=device)

    obj = load_obj(uv_map_path)
    v = obj["vertices"].copy()
    v[:, 1] *= -1.0
    v[:, 2] *= -1.0
    faces = obj["faces"].astype(np.int32)
    V = v.shape[0]

    with open(part_path) as f:
        pi = json.load(f)

    def pverts(name):
        ids = np.asarray(pi[name]["vertex"], np.int64)
        return v[ids]

    def leg_joints(name):
        p = pverts(name)
        y = p[:, 1]
        return (_band_centroid(p, y, 0.0, 0.12), _band_centroid(p, y, 0.45, 0.55),
                _band_centroid(p, y, 0.90, 1.0))

    def arm_joints(name):
        p = pverts(name)
        d = np.abs(p[:, 0])
        return (_band_centroid(p, d, 0.0, 0.10), _band_centroid(p, d, 0.45, 0.55),
                _band_centroid(p, d, 0.92, 1.0))

    l_hip, l_knee, l_ankle = leg_joints("02_left_leg")
    r_hip, r_knee, r_ankle = leg_joints("03_right_leg")
    l_sho, l_elb, l_wri = arm_joints("04_left_arm")
    r_sho, r_elb, r_wri = arm_joints("05_right_arm")
    l_foot = pverts("06_left_foot").mean(axis=0)
    r_foot = pverts("07_right_foot").mean(axis=0)
    l_hand = pverts("08_left_hand").mean(axis=0)
    r_hand = pverts("09_right_hand").mean(axis=0)

    torso = pverts("01_torso")
    neck = _band_centroid(torso, torso[:, 1], 0.0, 0.05)
    head_p = pverts("00_head")
    head = _band_centroid(head_p, head_p[:, 1], 0.3, 0.7)

    pelvis = 0.5 * (l_hip + r_hip)
    spine1 = pelvis + 0.3 * (neck - pelvis)
    spine2 = pelvis + 0.55 * (neck - pelvis)
    spine3 = pelvis + 0.8 * (neck - pelvis)
    l_col = 0.5 * (neck + l_sho)
    r_col = 0.5 * (neck + r_sho)

    joints = np.stack([
        pelvis, l_hip, r_hip, spine1, l_knee, r_knee, spine2, l_ankle, r_ankle,
        spine3, l_foot, r_foot, neck, l_col, r_col, head, l_sho, r_sho,
        l_elb, r_elb, l_wri, r_wri, l_hand, r_hand,
    ]).astype(np.float32)
    parents = _SMPL_PARENTS.copy()
    J = joints.shape[0]

    children: list[list[int]] = [[] for _ in range(J)]
    for j in range(1, J):
        children[parents[j]].append(j)

    def seg_dist(p, a, b):
        ab = b - a
        t = np.clip(((p - a) @ ab) / max(float(ab @ ab), 1e-8), 0.0, 1.0)
        proj = a + t[:, None] * ab
        return np.linalg.norm(p - proj, axis=1)

    d = np.empty((V, J), np.float32)
    for j in range(J):
        if children[j]:
            d[:, j] = np.min(
                np.stack([seg_dist(v, joints[j], joints[c]) for c in children[j]]),
                axis=0)
        else:
            d[:, j] = np.linalg.norm(v - joints[j], axis=1)
    w = np.exp(-(d / 0.08) ** 2)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    jr = np.exp(-(d.T / 0.05) ** 2)
    j_regressor = (jr / jr.sum(axis=1, keepdims=True)).astype(np.float32)

    rng = np.random.RandomState(seed)
    shapedirs = (rng.randn(V, 3, NUM_SHAPE) * 0.01).astype(np.float32)
    posedirs = (rng.randn(V, 3, 9 * (J - 1)) * 0.001).astype(np.float32)

    return _to_model(
        device, v_template=v.astype(np.float32), shapedirs=shapedirs,
        posedirs=posedirs, j_regressor=j_regressor, lbs_weights=lbs_weights,
        parents=parents, joint_regressor=j_regressor[_COCOPLUS_FROM_SMPL],
        faces=faces, hands_mean=np.zeros((0,), np.float32))


def resolve_body_model(opt=None, device: Device = "cuda") -> SMPLModel:
    """The one body-model choice of every service: the pickle that
    `opt.smpl_model` names when it exists, else the small smoke mesh
    (`opt.smoke_model`: `synthetic_model(nu=20, nv=18)`), else
    `template_model()` (the real SMPL template when its files are present,
    otherwise the synthetic stand-in)."""
    get = getattr(opt, "get", None) if opt is not None else None
    smpl_path = get("smpl_model", "") if get else ""
    if smpl_path and os.path.exists(smpl_path):
        return load_model(smpl_path, device=device)
    if get and get("smoke_model", False):
        return synthetic_model(nu=20, nv=18, device=device)
    return template_model(device=device)


def _rigid_transform_chain(rot_mats: torch.Tensor, joints: torch.Tensor,
                           chain: KinematicChain) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-kinematics chain. rot_mats: (N, J, 3, 3); joints: (N, J, 3).

    Returns posed joint locations (N, J, 3) and relative vertex transforms
    (N, J, 4, 4) with the rest-pose joint location factored out. The tree is
    walked level by level (the SMPL tree is about 8 deep), as in the JAX twin.
    """
    N, J = joints.shape[0], joints.shape[1]
    rel = joints - joints[:, chain.parents]
    rel[:, 0] = joints[:, 0]

    top = torch.cat([rot_mats, rel[..., None]], dim=-1)  # (N, J, 3, 4)
    bottom = chain.bottom.to(rot_mats.dtype).expand(N, J, 1, 4)
    locals_T = torch.cat([top, bottom], dim=-2)  # (N, J, 4, 4)

    A = locals_T.clone()
    for ids, par in chain.levels:
        A[:, ids] = A[:, par] @ locals_T[:, ids]

    posed_joints = A[..., :3, 3].clone()
    correction = torch.einsum("njab,njb->nja", A[..., :3, :3], joints)
    A_rel = A.clone()
    A_rel[..., :3, 3] = A_rel[..., :3, 3] - correction
    return posed_joints, A_rel


def lbs(
    model: SMPLModel,
    shape: torch.Tensor,
    pose: torch.Tensor,
    offsets: torch.Tensor | float = 0.0,
    links_ids: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Linear blend skinning for a batch.

    Args:
        shape: (N, 10) betas.
        pose: (N, J*3) axis-angle per joint (or (N, 72) for SMPL-H, padded
            with the mean hand pose).
        offsets: (V, 3) or (N, V, 3) per-vertex offsets, or 0.
        links_ids: optional (L, 3) int (from_vert, to_vert, flag): where
            flag == 1, vertex `from` is snapped to vertex `to` after offsets.

    Returns:
        verts (N, V, 3); posed kinematic joints (N, J, 3).
    """
    J = model.n_joints
    N = pose.shape[0]
    if pose.shape[-1] < J * 3:
        hands = model.hands_mean.expand(N, model.hands_mean.shape[0])
        pose = torch.cat([pose[..., :66], hands], dim=-1)

    rot = rodrigues(pose.reshape(N, J, 3))  # (N, J, 3, 3)
    return lbs_from_rot(model, shape, rot, offsets, links_ids)


def lbs_from_rot(
    model: SMPLModel,
    shape: torch.Tensor,
    rot: torch.Tensor,
    offsets: torch.Tensor | float = 0.0,
    links_ids: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`lbs` with the per-joint rotation matrices rot (N, J, 3, 3) already
    computed: the entry for paths that predict rotations directly (SPIN's
    rot6d output), which need not pass through the axis-angle round trip."""
    N = rot.shape[0]
    v_shaped = model.v_template + torch.einsum("vds,ns->nvd", model.shapedirs, shape)
    joints = torch.einsum("jv,nvd->njd", model.j_regressor, v_shaped)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    pose_feature = (rot[:, 1:] - eye).reshape(N, -1)
    v_posed = v_shaped + torch.einsum("vdp,np->nvd", model.posedirs, pose_feature)

    if not isinstance(offsets, (int, float)):
        v_posed = v_posed + offsets

    if links_ids is not None:
        flag = links_ids[:, 2] == 1
        src = links_ids[:, 0].long()
        tgt = links_ids[:, 1].long()
        replacement = torch.where(flag[None, :, None], v_posed[:, tgt], v_posed[:, src])
        v_posed = v_posed.clone()
        v_posed[:, src] = replacement

    posed_joints, A = _rigid_transform_chain(rot, joints, model.chain)

    T = torch.einsum("vj,njab->nvab", model.lbs_weights, A)  # (N, V, 4, 4)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("nvab,nvb->nva", T, v_h)[..., :3]
    return verts, posed_joints


def batch_orth_proj_idrot(x3d: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Weak-perspective projection: x3d (..., P, 3), cam (..., 3) = (s, tx, ty)
    -> (..., P, 2)."""
    return cam[..., None, 0:1] * (x3d[..., 0:2] + cam[..., None, 1:3])


def get_details(
    model: SMPLModel,
    theta: torch.Tensor,
    offsets: torch.Tensor | float = 0.0,
    links_ids: Optional[torch.Tensor] = None,
) -> dict:
    """Batched SMPL details.

    Args:
        theta: (N, 85) = cam(3) + pose(72) + shape(10), or (N, 3+156+10).

    Returns:
        dict with theta/cam/pose/shape, verts (N, V, 3), j3d (N, 19, 3),
        j2d (N, 19, 2).
    """
    cam = theta[:, 0:3]
    pose = theta[:, 3:-NUM_SHAPE]
    shape = theta[:, -NUM_SHAPE:]
    verts, _ = lbs(model, shape, pose, offsets, links_ids)
    j3d = torch.einsum("kv,nvd->nkd", model.joint_regressor, verts)
    j2d = batch_orth_proj_idrot(j3d, cam)
    return {"theta": theta, "cam": cam, "pose": pose, "shape": shape,
            "verts": verts, "j3d": j3d, "j2d": j2d}


def pad_theta_with_hands(theta: torch.Tensor, model: SMPLModel) -> torch.Tensor:
    """85-dim theta (N, 85) -> (N, 3 + pose_dim + 10) with the model's mean
    hand pose in place of SMPL's two hand joints (`add_hands_params_to_smpl`)."""
    n = theta.shape[0]
    cam, pose, shape = theta[:, :3], theta[:, 3:75], theta[:, 75:]
    hands = model.hands_mean.expand(n, model.hands_mean.shape[0])
    return torch.cat([cam, pose[:, :66], hands, shape], dim=1)
