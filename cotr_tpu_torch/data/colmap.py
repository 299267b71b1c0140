"""COLMAP ASCII model parsers -> SfmScene (counterpart of
cotr_tpu/data/colmap.py): strict-format readers for cameras.txt (PINHOLE
only), images.txt (quaternion + translation) and points3D.txt, and the
depth-augmented reader that finds each image's .h5 (MegaDepth) or COLMAP
.geometric.bin depth and keeps the images of a valid-list JSON.

The file-format checks raise ``ValueError`` where the JAX package asserts.
``native.parse_images_txt`` reads the same image lines in C++.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Optional, Set

import numpy as np

from cotr_tpu_torch.data.scenes import SfmScene
from cotr_tpu_torch.geometry.camera import (CameraPose, PinholeCamera,
                                            Rotation, Translation)
from cotr_tpu_torch.geometry.capture import (RGBDPinholeCapture,
                                             RGBPinholeCapture)


def _expect(ok: bool, path: str, what) -> None:
    if not ok:
        raise ValueError(f"{path}: not a COLMAP text file ({what!r})")


@dataclass
class ImageMeta:
    image_id: int
    r: Rotation
    t: Translation
    camera_id: int
    image_path: str
    # sorted unique 3D point ids observed by this image (covisibility mode
    # only)
    point3d_id: Optional[np.ndarray] = None
    # (x, y) keypoints with valid 3D ids, aligned with point3d index order
    points2d_xy: Optional[np.ndarray] = None


def read_cameras_txt(path: str) -> Dict[int, PinholeCamera]:
    """cameras.txt parser; PINHOLE only."""
    cameras: Dict[int, PinholeCamera] = {}
    with open(path) as fid:
        for want in ("# Camera list with one line of data per camera:\n",
                     "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"):
            line = fid.readline()
            _expect(line == want, path, line)
        line = fid.readline()
        _expect(re.search(r"^# Number of cameras: \d+\n$", line), path, line)
        num = int(re.findall(r"\d+", line)[0])
        for _ in range(num):
            elems = fid.readline().split()
            cam_id = int(elems[0])
            if elems[1] != "PINHOLE":
                raise ValueError(
                    "Please rectify the 3D model to pinhole cameras "
                    f"(got {elems[1]})")
            w, h, fx, fy, cx, cy = map(float, elems[2:8])
            _expect(cam_id not in cameras, path, f"camera {cam_id} twice")
            cameras[cam_id] = PinholeCamera(w, h, fx, fy, cx, cy)
    return cameras


def read_images_meta(path: str, images_dir: str,
                     valid_list: Optional[Set[str]] = None,
                     require_files: bool = True,
                     covisibility: bool = False) -> Dict[int, ImageMeta]:
    """images.txt parser.

    When ``valid_list`` is given, images whose path relative to the dataset
    root (4 levels above the image file) is absent are skipped. With
    ``covisibility``, the POINTS2D line is parsed into the observed 3D point
    ids + keypoints.
    """
    metas: Dict[int, ImageMeta] = {}
    with open(path) as fid:
        for want in ("# Image list with two lines of data per image:\n",
                     "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, "
                     "CAMERA_ID, NAME\n",
                     "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"):
            line = fid.readline()
            _expect(line == want, path, line)
        line = fid.readline()
        _expect(re.search(r"^# Number of images: \d+", line), path, line)
        num = int(re.findall(r"[-+]?\d*\.\d+|\d+", line)[0])
        for _ in range(num):
            elems = fid.readline().split()
            _expect(len(elems) == 10, path, elems)
            p2d_line = fid.readline()  # POINTS2D[] as (X, Y, POINT3D_ID)
            point3d_id = points2d_xy = None
            if covisibility:
                vals = np.asarray(list(map(float, p2d_line.split())),
                                  np.float64).reshape(-1, 3)
                obs = vals[vals[:, 2] != -1]
                point3d_id = np.sort(np.unique(obs[:, 2].astype(np.int64)))
                points2d_xy = obs[:, :2]
            image_path = os.path.join(images_dir, elems[9])
            if valid_list is not None:
                prefix = os.path.abspath(
                    os.path.join(image_path, "../../../../")) + "/"
                rel = image_path.replace(prefix, "")
                if rel not in valid_list:
                    continue
            if require_files and not os.path.isfile(image_path):
                raise FileNotFoundError(f"missing {image_path}")
            image_id = int(elems[0])
            qw, qx, qy, qz, tx, ty, tz = map(float, elems[1:8])
            _expect(image_id not in metas, path, f"image {image_id} twice")
            metas[image_id] = ImageMeta(
                image_id,
                Rotation(np.array([qw, qx, qy, qz], np.float32)),
                Translation(np.array([tx, ty, tz], np.float32)),
                int(elems[8]), image_path,
                point3d_id=point3d_id, points2d_xy=points2d_xy)
    return metas


def _points3d_header(fid, path: str) -> None:
    for want in ("# 3D point list with one line of data per point:\n",
                 "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                 "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"):
        line = fid.readline()
        _expect(line == want, path, line)


def read_points3d_meta(path: str) -> Dict[int, np.ndarray]:
    """points3D.txt -> {point3d_id: observing image ids} from the TRACK
    columns."""
    meta: Dict[int, np.ndarray] = {}
    with open(path) as fid:
        _points3d_header(fid, path)
        line = fid.readline()
        num = int(re.findall(r"[-+]?\d*\.\d+|\d+", line)[0])
        for _ in range(num):
            elems = fid.readline().split()
            pid = int(elems[0])
            track = np.asarray(list(map(int, elems[8:]))).reshape(-1, 2)
            meta[pid] = np.unique(track[:, 0])
    return meta


def read_points3d_txt(path: str) -> np.ndarray:
    """points3D.txt -> (N, 6) xyzrgb."""
    with open(path) as fid:
        _points3d_header(fid, path)
        line = fid.readline()
        num = int(re.findall(r"[-+]?\d*\.\d+|\d+", line)[0])
        xyz = np.zeros((num, 3), np.float32)
        rgb = np.zeros((num, 3), np.float32)
        for i in range(num):
            elems = fid.readline().split()
            xyz[i] = list(map(float, elems[1:4]))
            rgb[i] = list(map(int, elems[4:7]))
    return np.concatenate([xyz, rgb], axis=1)


def read_valid_list(path: str) -> Set[str]:
    with open(path) as f:
        valid = json.load(f)
    if len(valid) != len(set(valid)):
        raise ValueError(f"{path} lists an image twice")
    return set(valid)


def image_path_to_depth_path(image_path: str, depth_dir: str) -> str:
    """MegaDepth .h5 first, then COLMAP .geometric.bin (``image_path`` joined
    to ``depth_dir``: beside the image when the path is absolute). Raises
    FileNotFoundError when neither is there."""
    depth_path = os.path.join(
        depth_dir, os.path.splitext(os.path.basename(image_path))[0] + ".h5")
    if not os.path.isfile(depth_path):
        depth_path = os.path.join(depth_dir, image_path + ".geometric.bin")
    if not os.path.isfile(depth_path):
        raise FileNotFoundError(f"{depth_path} is not a file")
    return depth_path


class ColmapAsciiReader:
    """RGB-only scene reader."""

    @classmethod
    def read_sfm_scene(cls, scene_dir: str, images_dir: str,
                       crop_cam="no_crop") -> SfmScene:
        cameras = read_cameras_txt(os.path.join(scene_dir, "cameras.txt"))
        metas = read_images_meta(os.path.join(scene_dir, "images.txt"),
                                 images_dir)
        captures = [
            RGBPinholeCapture(m.image_path, cameras[m.camera_id],
                              CameraPose(m.t, m.r), crop_cam)
            for m in metas.values()
        ]
        return SfmScene(captures)


class ColmapWithDepthAsciiReader(ColmapAsciiReader):
    """Depth-augmented scene reader."""

    @classmethod
    def read_sfm_scene(cls, scene_dir: str, images_dir: str, depth_dir: str,
                       crop_cam="no_crop", covisibility: bool = False
                       ) -> SfmScene:
        cameras = read_cameras_txt(os.path.join(scene_dir, "cameras.txt"))
        metas = read_images_meta(os.path.join(scene_dir, "images.txt"),
                                 images_dir, covisibility=covisibility)
        captures = []
        for m in metas.values():
            try:
                depth_path = image_path_to_depth_path(
                    m.image_path[len(images_dir) + 1:], depth_dir)
            except FileNotFoundError:
                # degrade to a dummy zero-depth capture
                depth_path = f"{m.image_path}dummy"
            cap = RGBDPinholeCapture(m.image_path, depth_path,
                                     cameras[m.camera_id],
                                     CameraPose(m.t, m.r), crop_cam)
            cap.image_id = m.image_id
            if covisibility:
                cap.point3d_id = m.point3d_id
            captures.append(cap)
        point_meta = None
        if covisibility:
            point_meta = read_points3d_meta(
                os.path.join(scene_dir, "points3D.txt"))
        return SfmScene(captures, point_meta=point_meta)

    @classmethod
    def read_sfm_scene_given_valid_list_path(
            cls, scene_dir: str, images_dir: str, depth_dir: str,
            valid_list_json_path: str, crop_cam="no_crop") -> SfmScene:
        valid_list = read_valid_list(valid_list_json_path)
        cameras = read_cameras_txt(os.path.join(scene_dir, "cameras.txt"))
        metas = read_images_meta(os.path.join(scene_dir, "images.txt"),
                                 images_dir, valid_list=valid_list)
        captures = []
        for m in metas.values():
            try:
                depth_path = image_path_to_depth_path(m.image_path, depth_dir)
            except FileNotFoundError:
                continue  # skip images without usable depth
            cap = RGBDPinholeCapture(m.image_path, depth_path,
                                     cameras[m.camera_id],
                                     CameraPose(m.t, m.r), crop_cam)
            cap.image_id = m.image_id
            captures.append(cap)
        return SfmScene(captures)
