"""Pinhole camera intrinsics and world<->camera pose algebra (a copy of
cotr_tpu/geometry/camera.py, numpy): validated quaternion and translation
containers, every pose representation as a property, and the crop-aware
rewriting of intrinsics (``crop_pinhole_camera``). The dtypes are the JAX
package's: quaternions and translations float32, matrices float64.
"""

from __future__ import annotations

import copy
from typing import Union

import numpy as np

from cotr_tpu_torch.geometry import transforms
from cotr_tpu_torch.utils.constants import MAX_SIZE


class Rotation:
    """Validated unit quaternion, (w, x, y, z)."""

    def __init__(self, quaternion: np.ndarray):
        q = np.asarray(quaternion, dtype=np.float32)
        if q.shape != (4,):
            raise ValueError(f"quaternion must be (4,), got {q.shape}")
        norm = np.linalg.norm(q)
        if not abs(norm - 1.0) < 1e-2:
            raise ValueError(f"quaternion not normalized: |q|={norm}")
        self.quaternion = q / norm

    @property
    def rotation_matrix(self) -> np.ndarray:
        return transforms.quaternion_matrix(self.quaternion)

    def __str__(self):
        return f"Rotation(wxyz={self.quaternion})"


class UnstableRotation:
    """Raw (possibly non-orthonormal) rotation matrix, for rectified COLMAP
    models whose rotations do not renormalize cleanly."""

    def __init__(self, matrix: np.ndarray):
        m = np.asarray(matrix, dtype=np.float64)
        if m.shape != (4, 4):
            raise ValueError(f"rotation matrix must be (4, 4), got {m.shape}")
        m = m.copy()
        m[:3, 3] = 0
        self._matrix = m

    @property
    def rotation_matrix(self) -> np.ndarray:
        return self._matrix

    @property
    def quaternion(self) -> np.ndarray:
        return transforms.quaternion_from_matrix(self._matrix)


class Translation:
    def __init__(self, vector: np.ndarray):
        v = np.asarray(vector, dtype=np.float32)
        if v.shape != (3,):
            raise ValueError(f"translation must be (3,), got {v.shape}")
        self.translation_vector = v

    @property
    def translation_matrix(self) -> np.ndarray:
        return transforms.translation_matrix(self.translation_vector)


class PinholeCamera:
    """Intrinsics container."""

    def __init__(self, width, height, fx, fy, cx, cy):
        self.width = int(width)
        self.height = int(height)
        self.fx = fx
        self.fy = fy
        self.cx = cx
        self.cy = cy

    @property
    def shape(self):
        return (self.height, self.width)

    @property
    def intrinsic_mat(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx],
                         [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]], dtype=np.float64)

    def __str__(self):
        return (f"PinholeCamera({self.width}x{self.height}, f=({self.fx},"
                f"{self.fy}), c=({self.cx},{self.cy}))")


class CameraPose:
    """World-to-camera pose from (translation, rotation)."""

    def __init__(self, t: Translation, r: Union[Rotation, UnstableRotation]):
        self.t = t
        self.r = r

    @classmethod
    def from_world_to_camera(cls, world_to_camera: np.ndarray,
                             unstable: bool = False) -> "CameraPose":
        if world_to_camera.shape != (4, 4):
            raise ValueError(f"world_to_camera must be (4, 4), got "
                             f"{world_to_camera.shape}")
        t = Translation(
            transforms.translation_from_matrix(world_to_camera).astype(
                np.float32))
        if unstable:
            r = UnstableRotation(world_to_camera)
        else:
            r = Rotation(transforms.quaternion_from_matrix(
                world_to_camera).astype(np.float32))
        return cls(t, r)

    @classmethod
    def from_camera_to_world(cls, camera_to_world: np.ndarray,
                             unstable: bool = False) -> "CameraPose":
        w2c = np.linalg.inv(camera_to_world)
        w2c /= w2c[3, 3]
        return cls.from_world_to_camera(w2c, unstable)

    @classmethod
    def from_pose_vector(cls, pose_vector: np.ndarray) -> "CameraPose":
        return cls(Translation(pose_vector[:3]), Rotation(pose_vector[3:]))

    @property
    def translation_vector(self):
        return self.t.translation_vector

    @property
    def quaternion(self):
        return self.r.quaternion

    @property
    def rotation_matrix(self):
        return self.r.rotation_matrix

    @property
    def pose_vector(self):
        return np.concatenate([self.translation_vector, self.quaternion])

    @property
    def world_to_camera(self) -> np.ndarray:
        m = np.matmul(self.t.translation_matrix, self.r.rotation_matrix)
        return m / m[3, 3]

    @property
    def world_to_camera_3x4(self) -> np.ndarray:
        return self.world_to_camera[0:3, 0:4]

    extrinsic_mat = world_to_camera_3x4

    @property
    def camera_to_world(self) -> np.ndarray:
        m = np.linalg.inv(self.world_to_camera)
        return m / m[3, 3]

    @property
    def camera_center_in_world(self):
        return self.camera_to_world[:3, 3]

    @property
    def forward(self):
        return self.camera_to_world[:3, 2]

    @property
    def essential_matrix(self) -> np.ndarray:
        """Row-wise cross product of R with the camera center,
        normalized."""
        rot = self.world_to_camera[:3, :3]
        e = np.cross(rot, self.camera_center_in_world)
        return e / np.linalg.norm(e)

    def __str__(self):
        return f"CameraPose(center={self.camera_center_in_world})"


def inverse_camera_pose(pose: CameraPose) -> CameraPose:
    return CameraPose.from_world_to_camera(
        np.linalg.inv(pose.world_to_camera))


def rotate_camera_pose(pose: CameraPose, rot_deg: float) -> CameraPose:
    """Roll augmentation: the camera turned ``rot_deg`` about its axis."""
    if rot_deg == 0:
        return copy.deepcopy(pose)
    rot = rot_deg / 180 * np.pi
    c, s = np.cos(rot), np.sin(rot)
    rot_mat = np.array([[c, -s, 0, 0],
                        [s, c, 0, 0],
                        [0, 0, 1, 0],
                        [0, 0, 0, 1]])
    return CameraPose.from_world_to_camera(rot_mat @ pose.world_to_camera)


def crop_pinhole_camera(cam: PinholeCamera, crop_cam) -> PinholeCamera:
    """Crop-aware intrinsic rewriting.

    crop_cam: 'no_crop' | 'crop_center' | 'crop_center_and_resize' |
    CropCamConfig-like object with x, y, w, h, out_w, out_h attributes."""
    if crop_cam == "no_crop":
        return cam
    if crop_cam == "crop_center":
        size = min(*cam.shape)
        return PinholeCamera(size, size, cam.fx, cam.fy, size / 2, size / 2)
    if crop_cam == "crop_center_and_resize":
        scale = MAX_SIZE / min(*cam.shape)
        return PinholeCamera(MAX_SIZE, MAX_SIZE, cam.fx * scale,
                             cam.fy * scale, MAX_SIZE / 2, MAX_SIZE / 2)
    scale = crop_cam.out_h / crop_cam.h
    return PinholeCamera(crop_cam.out_w, crop_cam.out_h,
                         cam.fx * scale, cam.fy * scale,
                         (cam.cx - crop_cam.x) * scale,
                         (cam.cy - crop_cam.y) * scale)
