"""The program's body model and mesh tables, built from the benchmark's own
arrays (`portbench/reference/body.py`), so that the program and the
reference run on the same inputs."""
from __future__ import annotations

import numpy as np
import torch


def body_and_assets(body_np: dict, mesh_np: dict, device) -> tuple:
    """(`SMPLModel`, `MeshAssets`) of the port on `device`."""
    from ipercore_tpu_torch.models import smpl as smpl_mod
    from ipercore_tpu_torch.models.mesh import MeshAssets

    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt), device=device)
    assets = MeshAssets(
        obj_faces=t(mesh_np["obj_faces"], np.int64), f2uvs=t(mesh_np["f2uvs"], np.float32),
        face_parts=t(mesh_np["face_parts"], np.int64), map_fn=t(mesh_np["map_fn"], np.float32),
        face_k_nearest=t(mesh_np["face_k_nearest"], np.int64),
        front_face_mask=t(mesh_np["front_face_mask"], bool),
        facial_face_mask=t(mesh_np["facial_face_mask"], bool))
    return smpl_mod._to_model(device, **body_np), assets
