"""Keypoint format families -> the 45-joint SMPL convention.

The port's copy of `ipercore_tpu/utils/keypoints.py` (the reference's
`tools/utils/geometry/keypoints.py`): three 2D-pose format families
(OpenPose-Body-25, CocoWhole-Body-23, Halpe-Body-26), each re-normalised to
HMR's 224-pixel frame and scattered into the SMPL 45-joint slot layout that
SMPLify's reprojection losses read. Host-side numpy: these run once per
sequence.
"""
from __future__ import annotations

import numpy as np

NUM_SMPL_JOINTS = 45

# SMPL-45 slot ids by joint name — `keypoints.py:148-163` (data table).
_SMPL45 = {
    "MidHip": 0, "LHip": 1, "RHip": 2, "LKnee": 4, "RKnee": 5,
    "LAnkle": 7, "RAnkle": 8, "Neck": 12, "LShoulder": 16, "RShoulder": 17,
    "LElbow": 18, "RElbow": 19, "LWrist": 20, "RWrist": 21, "Nose": 24,
    "REye": 25, "LEye": 26, "REar": 27, "LEar": 28, "LBigToe": 29,
    "LSmallToe": 30, "LHeel": 31, "RBigToe": 32, "RSmallToe": 33, "RHeel": 34,
}

OPENPOSE_BODY_25_NAMES = [
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow",
    "LWrist", "MidHip", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle",
    "REye", "LEye", "REar", "LEar", "LBigToe", "LSmallToe", "LHeel",
    "RBigToe", "RSmallToe", "RHeel",
]

COCO_WHOLEBODY_23_NAMES = [
    "Nose", "LEye", "REye", "LEar", "REar", "LShoulder", "RShoulder",
    "LElbow", "RElbow", "LWrist", "RWrist", "LHip", "RHip", "LKnee", "RKnee",
    "LAnkle", "RAnkle", "LBigToe", "LSmallToe", "LHeel", "RBigToe",
    "RSmallToe", "RHeel",
]


def _renormalize(kps: np.ndarray, im_shape) -> np.ndarray:
    """[0, W/H] pixels (or [-1, 1] NDC when im_shape is None) -> [0, 224]
    HMR frame — `keypoints.py:193-200`."""
    kps = np.array(kps, np.float32, copy=True).reshape(-1, 3)
    if im_shape is None:
        kps[:, 0:2] = (kps[:, 0:2] + 1.0) * 112.0
    else:
        height, width = im_shape[:2]
        kps[:, 0] = kps[:, 0] / width * 224.0
        kps[:, 1] = kps[:, 1] / height * 224.0
    return kps


class _NamedFormatter:
    """Shared machinery for name-mapped families — `KeypointFormater:25`."""

    JOINT_NAMES: list[str] = []
    JOINT_TYPE = ""
    IGNORE: tuple = ()

    def __init__(self, num_smpl_joints: int = NUM_SMPL_JOINTS):
        self.num_smpl_joints = num_smpl_joints
        self.mapper = [_SMPL45[n] for n in self.JOINT_NAMES]
        self.ignore_ids = [_SMPL45[n] for n in self.IGNORE if n in _SMPL45]

    def format_keypoints(self, keypoints: dict, im_shape=None) -> np.ndarray:
        """One frame's dict {pose_keypoints_2d: (J*3,)} -> (45, 3)."""
        kps = _renormalize(keypoints["pose_keypoints_2d"], im_shape)
        out = np.zeros((self.num_smpl_joints, 3), np.float32)
        out[self.mapper] = kps
        out[self.ignore_ids] = 0.0
        return out

    def format_stacked_keypoints(self, ids: int, keypoints: dict, im_shape=None) -> np.ndarray:
        return self.format_keypoints(
            {"pose_keypoints_2d": keypoints["pose_keypoints_2d"][ids]}, im_shape)

    def stack_keypoints(self, keypoints_list) -> dict:
        if isinstance(keypoints_list, dict):
            return keypoints_list
        return {"pose_keypoints_2d": np.asarray(
            [k["pose_keypoints_2d"] for k in keypoints_list], np.float32)}


class OpenPoseBody25Formatter(_NamedFormatter):
    """`OpenPoseBody25KeypointFormater:116` — Neck/hips come from SMPL's own
    regressor during fitting, so their 2D targets are zeroed."""

    JOINT_NAMES = OPENPOSE_BODY_25_NAMES
    JOINT_TYPE = "OpenPose-Body-25"
    IGNORE = ("Neck", "RHip", "LHip")


class CocoWholeBody23Formatter(_NamedFormatter):
    """`CocoWholeBody23KeypointFormater:262`."""

    JOINT_NAMES = COCO_WHOLEBODY_23_NAMES
    JOINT_TYPE = "CocoWhole-Body-23"
    IGNORE = ("RHip", "LHip")


class HalpeBody26Formatter:
    """`HalpeBody26KeypointFormater:406`: Halpe's 26 joints are appended after
    the 25 OpenPose + 24 extra slots -> a (75, 3) layout."""

    JOINT_TYPE = "Halpe-Body-26"
    NUM_JOINTS = 26

    def format_keypoints(self, keypoints: dict, im_shape=None) -> np.ndarray:
        kps = _renormalize(keypoints["pose_keypoints_2d"], im_shape)
        return np.concatenate([np.zeros((25 + 24, 3), np.float32), kps], axis=0)

    def format_stacked_keypoints(self, ids: int, keypoints: dict, im_shape=None) -> np.ndarray:
        return self.format_keypoints(
            {"pose_keypoints_2d": keypoints["pose_keypoints_2d"][ids]}, im_shape)

    def stack_keypoints(self, keypoints_list) -> dict:
        if isinstance(keypoints_list, dict):
            return keypoints_list
        return {"pose_keypoints_2d": np.asarray(
            [k["pose_keypoints_2d"] for k in keypoints_list], np.float32)}


FORMATTERS = {
    "OpenPose-Body-25": OpenPoseBody25Formatter,
    "CocoWhole-Body-23": CocoWholeBody23Formatter,
    "Halpe-Body-26": HalpeBody26Formatter,
}


def build_formatter(joint_type: str):
    """`KEYPOINTS_FORMATER` registry (`keypoints.py:502`)."""
    return FORMATTERS[joint_type]()


def temporal_smooth_keypoints(stack_keypoints: dict, min_frames: int = 10) -> dict:
    """Interpolate invalid joints + low-pass over time —
    `KeypointFormater.temporal_smooth_keypoints` (`keypoints.py:28-50`)."""
    from ipercore_tpu_torch.utils.smoothing import interpolate_invalid_kps, lowpass_filtfilt

    out = {}
    for key, val in stack_keypoints.items():
        val = np.asarray(val, np.float32)
        if key.endswith("keypoints_2d") and val.shape[0] > min_frames:
            n = val.shape[0]
            kps = val.reshape(n, -1, 3)
            valid = kps[..., 2] > 0.05
            xy = interpolate_invalid_kps(kps[..., :2], valid)
            xy = lowpass_filtfilt(xy.reshape(n, -1), fc=120.0).reshape(n, -1, 2)
            out[key] = np.concatenate([xy, kps[..., 2:3]], axis=-1).reshape(val.shape)
        else:
            out[key] = val
    return out
