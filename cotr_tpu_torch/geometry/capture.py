"""Lazy-IO capture objects and crop algebra (counterpart of
cotr_tpu/geometry/capture.py).

Images and depths are read from disk when accessed, rotated, then put
through a crop_cam pipeline ('no_crop' | 'crop_center' |
'crop_center_and_resize' | CropCamConfig), and the pinhole intrinsics are
rewritten to match. Depth is resampled NEAREST, images BILINEAR, as the JAX
package does with PIL; here without PIL, in numpy, with PIL's arithmetic:

* BILINEAR resize of uint8 images: ``ops.sampling.resize_pil_u8_host``
  (equal to PIL);
* NEAREST resize: :func:`resize_nearest_host`, PIL's pixel-centre sampling
  with its running sum of the scale (equal to PIL);
* rotation: :func:`rotate_image`, PIL's ``rotate(expand=False)``: NEAREST
  in PIL's 16.16 fixed point, BILINEAR in float64 with PIL's truncation to
  uint8 (both equal to PIL for uint8 and float32 images under NEAREST, and
  for uint8 under BILINEAR).

Images are ``.npy`` uint8 (H, W, 3) arrays, or image files read through
imageio, imported when one is read. Depths are COLMAP ``.bin`` arrays,
``.npy`` float arrays, or HDF5 ``.h5`` files read through h5py, imported
when one is read; '<image path>dummy' is a zero depth of the image's size.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import math

import numpy as np

from cotr_tpu_torch.geometry.camera import (CameraPose, PinholeCamera,
                                            crop_pinhole_camera,
                                            rotate_camera_pose)
from cotr_tpu_torch.geometry.projector import img_2d_to_pcd_3d
from cotr_tpu_torch.ops.sampling import resize_pil_u8_host
from cotr_tpu_torch.utils.constants import MAX_SIZE


@dataclass
class CropCamConfig:
    """Crop window (x, y upper-left; w, h) resized to (out_w, out_h)."""

    x: int
    y: int
    w: int
    h: int
    out_w: int
    out_h: int
    orig_w: int
    orig_h: int


CropCam = Union[str, CropCamConfig]


def crop_center_max(img: np.ndarray) -> np.ndarray:
    """Center square crop of side min(h, w)."""
    h, w = img.shape[:2]
    size = min(h, w)
    sx = w // 2 - size // 2
    sy = h // 2 - size // 2
    return img[sy:sy + size, sx:sx + size]


def pad_to_square(img: np.ndarray, till_divisible_by: int = 1,
                  return_starts: bool = False):
    """Zero-pad to a centered square."""
    h, w = img.shape[:2]
    if till_divisible_by == 1:
        size = max(h, w)
    else:
        size = (max(h, w) + till_divisible_by) - (max(h, w) % till_divisible_by)
    sx = size // 2 - w // 2
    sy = size // 2 - h // 2
    canvas = np.zeros((size, size) + img.shape[2:], dtype=img.dtype)
    canvas[sy:sy + h, sx:sx + w] = img
    if return_starts:
        return canvas, sx, sy
    return canvas


def _pil_rotate_matrix(angle_deg: float, w: int, h: int) -> list:
    """The inverse affine map of PIL's ``Image.rotate`` about the image
    centre: output pixel centre -> input coordinates."""
    angle = -math.radians(angle_deg % 360.0)
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    cx, cy = w / 2, h / 2
    m[2] = m[0] * -cx + m[1] * -cy + m[2] + cx
    m[5] = m[3] * -cx + m[4] * -cy + m[5] + cy
    return m


def _rotate_nearest(image: np.ndarray, a: list) -> np.ndarray:
    """PIL's affine NEAREST: coordinates in 16.16 fixed point, stepped by
    whole pixels from the first pixel's centre."""
    h, w = image.shape[:2]

    def fix(v):
        return math.floor(v * 65536.0 + 0.5)

    x0 = fix(a[2] + a[1] * 0.5 + a[0] * 0.5)
    y0 = fix(a[5] + a[4] * 0.5 + a[3] * 0.5)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.int64)
    xin = (x0 + ys * fix(a[1]) + xs * fix(a[0])) >> 16
    yin = (y0 + ys * fix(a[4]) + xs * fix(a[3])) >> 16
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.zeros_like(image)
    out[inside] = image[yin[inside], xin[inside]]
    return out


def _rotate_bilinear_u8(image: np.ndarray, a: list) -> np.ndarray:
    """PIL's affine BILINEAR for 8-bit images: float64 coordinates of each
    pixel centre, edge-clamped taps, the result truncated to uint8, 0 where
    the centre maps outside the input."""
    h, w = image.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xin = a[0] * (xs + 0.5) + a[1] * (ys + 0.5) + a[2]
    yin = a[3] * (xs + 0.5) + a[4] * (ys + 0.5) + a[5]
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x, y = np.floor(xin).astype(np.int64), np.floor(yin).astype(np.int64)
    dx, dy = (xin - x)[..., None], (yin - y)[..., None]
    f = image.reshape(h, w, -1).astype(np.float64)
    x0, x1 = np.clip(x, 0, w - 1), np.clip(x + 1, 0, w - 1)
    y0, y1 = np.clip(y, 0, h - 1), np.clip(y + 1, 0, h - 1)
    top = f[y0, x0] + (f[y0, x1] - f[y0, x0]) * dx
    bottom = f[y1, x0] + (f[y1, x1] - f[y1, x0]) * dx
    # PIL reuses the top row where the row below lies outside the image
    bottom = np.where(((y + 1 >= 0) & (y + 1 < h))[..., None], bottom, top)
    v = (top + (bottom - top) * dy).astype(np.uint8)
    return np.where(inside[..., None], v, 0).astype(np.uint8).reshape(
        image.shape)


def rotate_image(image: np.ndarray, angle_deg: float,
                 nearest: bool = False) -> np.ndarray:
    """Rotate about the image centre keeping the frame size, counter-clockwise
    for positive angles: PIL's ``rotate(angle_deg, resample, expand=False)``
    in numpy. NEAREST takes any dtype; BILINEAR takes uint8."""
    angle = angle_deg % 360.0
    h, w = image.shape[:2]
    if angle == 0:
        return image.copy()
    # PIL's exact transposes
    if angle == 180:
        return np.ascontiguousarray(image[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(image, 1 if angle == 90 else 3))
    a = _pil_rotate_matrix(angle, w, h)
    if nearest:
        return _rotate_nearest(image, a)
    if image.dtype != np.uint8:
        raise ValueError(f"BILINEAR rotation takes uint8, got {image.dtype}")
    return _rotate_bilinear_u8(image, a)


def read_colmap_array(path: str) -> np.ndarray:
    """COLMAP dense .bin (geometric depth) reader: "width&height&channels&"
    then float32 data in column-major order. (The JAX package decodes the
    header's line as UTF-8, binary data up to the first newline byte
    included, which fails for most data; here only the header is parsed.)"""
    with open(path, "rb") as fid:
        header = b""
        while header.count(b"&") < 3:
            c = fid.read(1)
            if not c:
                raise ValueError(f"{path}: no COLMAP array header")
            header += c
        width, height, channels = map(int, header.split(b"&")[:3])
        array = np.fromfile(fid, np.float32)
    array = array.reshape((width, height, channels), order="F")
    return np.transpose(array, (1, 0, 2)).squeeze()


def resize_nearest_host(arr: np.ndarray,
                        shape_hw: Tuple[int, int]) -> np.ndarray:
    """PIL ``Image.resize(size, NEAREST)`` of an (H, W[, C]) array: each
    output pixel takes the input pixel under its centre, the centres found
    as PIL finds them, by adding the scale to a running sum (float64), not
    by one product each (which differs from PIL at some sizes)."""
    out_h, out_w = shape_hw

    def sources(n_in: int, n_out: int) -> np.ndarray:
        steps = np.full(n_out, n_in / n_out)
        steps[0] *= 0.5
        return np.cumsum(steps).astype(np.int64)

    return arr[sources(arr.shape[0], out_h)][:, sources(arr.shape[1], out_w)]


def _resize_pil(arr: np.ndarray, shape_hw: Tuple[int, int],
                nearest: bool = False) -> np.ndarray:
    if nearest:
        return resize_nearest_host(arr, shape_hw)
    if arr.dtype != np.uint8:
        raise ValueError(f"BILINEAR resize takes uint8, got {arr.dtype}")
    return resize_pil_u8_host(arr, shape_hw)


def _apply_crop_cam(arr: np.ndarray, crop_cam: CropCam,
                    nearest: bool) -> np.ndarray:
    if crop_cam == "no_crop":
        return arr
    if crop_cam == "crop_center":
        return crop_center_max(arr)
    if crop_cam == "crop_center_and_resize":
        return _resize_pil(crop_center_max(arr), (MAX_SIZE, MAX_SIZE), nearest)
    if isinstance(crop_cam, CropCamConfig):
        c = crop_cam
        if arr.shape[:2] != (c.orig_h, c.orig_w):
            raise ValueError(f"crop of a {c.orig_h}x{c.orig_w} frame given "
                             f"a {arr.shape[:2]} array")
        cropped = arr[c.y:c.y + c.h, c.x:c.x + c.w]
        return _resize_pil(cropped, (c.out_h, c.out_w), nearest)
    raise ValueError(f"unknown crop_cam: {crop_cam}")


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB from a ``.npy`` array or an image file (the
    latter through imageio, as the JAX package reads it)."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"{path}: want a uint8 (H, W, 3) array, got "
                             f"{img.dtype} {img.shape}")
        return img
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(f"reading {path} needs imageio; store images as "
                          ".npy uint8 (H, W, 3) arrays where it is "
                          "missing") from e
    return imageio.imread(path, pilmode="RGB")


class CapturedImage:
    """Lazy image: path + rotation + crop pipeline applied at access."""

    def __init__(self, img_path: str, crop_cam: CropCam,
                 pinhole_cam_before: Optional[PinholeCamera] = None):
        if not os.path.isfile(img_path):
            raise FileNotFoundError(f"file does not exist: {img_path}")
        self.img_path = img_path
        self.crop_cam = crop_cam
        self.pinhole_cam_before = pinhole_cam_before
        self.rotation = 0.0
        self._image: Optional[np.ndarray] = None

    def read_image_to_ram(self) -> int:
        if self._image is not None:
            raise RuntimeError(f"{self.img_path} is already in RAM")
        self._image = self.image
        return self._image.nbytes

    @property
    def image(self) -> np.ndarray:
        if self._image is not None:
            return self._image
        img = read_image(self.img_path)
        if self.rotation != 0:
            img = rotate_image(img, self.rotation)
        if (self.pinhole_cam_before is not None and
                img.shape[:2] != self.pinhole_cam_before.shape):
            img = _resize_pil(img, self.pinhole_cam_before.shape)
        return _apply_crop_cam(img, self.crop_cam, nearest=False)


class CapturedDepth:
    """Lazy depth: .h5 (MegaDepth), COLMAP .bin, .npy, or '<img>dummy' zero
    depth."""

    def __init__(self, depth_path: str, crop_cam: CropCam,
                 pinhole_cam_before: Optional[PinholeCamera] = None):
        if not (depth_path.endswith("dummy") or os.path.isfile(depth_path)):
            raise FileNotFoundError(f"file does not exist: {depth_path}")
        self.depth_path = depth_path
        self.crop_cam = crop_cam
        self.pinhole_cam_before = pinhole_cam_before
        self.rotation = 0.0
        self._depth: Optional[np.ndarray] = None

    def _read(self) -> np.ndarray:
        if self.depth_path.endswith("dummy"):
            h, w = read_image(self.depth_path[:-5]).shape[:2]
            return np.zeros([h, w], np.float32)
        if self.depth_path.endswith(".h5"):
            try:
                import h5py
            except ImportError as e:
                raise ImportError(f"reading {self.depth_path} needs h5py; "
                                  "store depths as COLMAP .bin or .npy "
                                  "where it is missing") from e
            with h5py.File(self.depth_path, "r") as f:
                return np.asarray(f["depth"]).astype(np.float32)
        if self.depth_path.endswith(".bin"):
            return read_colmap_array(self.depth_path).astype(np.float32)
        if self.depth_path.endswith(".npy"):
            return np.load(self.depth_path).astype(np.float32)
        raise ValueError(f"unsupported depth format: {self.depth_path}")

    def read_depth_to_ram(self) -> int:
        if self._depth is not None:
            raise RuntimeError(f"{self.depth_path} is already in RAM")
        self._depth = self.depth_map
        return self._depth.nbytes

    @property
    def depth_map(self) -> np.ndarray:
        if self._depth is not None:
            return self._depth
        depth = self._read()
        if self.rotation != 0:
            depth = rotate_image(depth, self.rotation, nearest=True)
        if (self.pinhole_cam_before is not None and
                depth.shape != self.pinhole_cam_before.shape):
            depth = _resize_pil(depth, self.pinhole_cam_before.shape,
                                nearest=True)
        depth = _apply_crop_cam(depth, self.crop_cam, nearest=True)
        if not (depth >= 0).all():
            raise ValueError(f"negative depth in {self.depth_path}")
        return depth


class BasePinholeCapture:
    """camera + pose + crop config."""

    def __init__(self, pinhole_cam: PinholeCamera, cam_pose: CameraPose,
                 crop_cam: CropCam):
        self.crop_cam = crop_cam
        self.cam_pose = cam_pose
        self.pinhole_cam = crop_pinhole_camera(pinhole_cam, crop_cam)
        self.pinhole_cam_before = pinhole_cam

    @property
    def intrinsic_mat(self):
        return self.pinhole_cam.intrinsic_mat

    @property
    def extrinsic_mat(self):
        return self.cam_pose.extrinsic_mat

    @property
    def shape(self):
        return self.pinhole_cam.shape

    size = shape

    @property
    def mvp_mat(self):
        return np.matmul(self.pinhole_cam.intrinsic_mat,
                         self.cam_pose.world_to_camera_3x4)


class RGBPinholeCapture(BasePinholeCapture):
    def __init__(self, img_path, pinhole_cam, cam_pose, crop_cam):
        # explicit base call: RGBDPinholeCapture diamond-inherits this class
        # and DepthPinholeCapture, so super() would hit the sibling
        BasePinholeCapture.__init__(self, pinhole_cam, cam_pose, crop_cam)
        self.captured_image = CapturedImage(img_path, crop_cam,
                                            self.pinhole_cam_before)

    def read_image_to_ram(self) -> int:
        return self.captured_image.read_image_to_ram()

    @property
    def img_path(self):
        return self.captured_image.img_path

    @property
    def image(self):
        img = self.captured_image.image
        if img.shape[0:2] != self.pinhole_cam.shape:
            raise ValueError(f"{self.img_path}: image {img.shape[:2]}, "
                             f"camera {self.pinhole_cam.shape}")
        return img

    @property
    def seq_id(self):
        return os.path.dirname(self.captured_image.img_path)


class DepthPinholeCapture(BasePinholeCapture):
    def __init__(self, depth_path, pinhole_cam, cam_pose, crop_cam):
        BasePinholeCapture.__init__(self, pinhole_cam, cam_pose, crop_cam)
        self.captured_depth = CapturedDepth(depth_path, crop_cam,
                                            self.pinhole_cam_before)

    def read_depth_to_ram(self) -> int:
        return self.captured_depth.read_depth_to_ram()

    @property
    def depth_path(self):
        return self.captured_depth.depth_path

    @property
    def depth_map(self):
        return self.captured_depth.depth_map

    @property
    def point_cloud_world(self):
        return self.get_point_cloud_world_from_depth(None)

    def get_point_cloud_world_from_depth(self, feat_map=None):
        return img_2d_to_pcd_3d(self.depth_map, self.pinhole_cam.intrinsic_mat,
                                img=feat_map,
                                motion=self.cam_pose.camera_to_world)


class RGBDPinholeCapture(RGBPinholeCapture, DepthPinholeCapture):
    def __init__(self, img_path, depth_path, pinhole_cam, cam_pose, crop_cam):
        RGBPinholeCapture.__init__(self, img_path, pinhole_cam, cam_pose,
                                   crop_cam)
        DepthPinholeCapture.__init__(self, depth_path, pinhole_cam, cam_pose,
                                     crop_cam)

    @property
    def point_cloud_w_rgb_world(self):
        return self.get_point_cloud_world_from_depth(self.image)


def rotate_capture(cap, rot_deg: float):
    """Functional rotation: a copy of ``cap`` rolled by ``rot_deg``."""
    if rot_deg == 0:
        return copy.deepcopy(cap)
    out = copy.deepcopy(cap)
    out.cam_pose = rotate_camera_pose(cap.cam_pose, rot_deg)
    if hasattr(out, "captured_image"):
        out.captured_image.rotation = rot_deg
    if hasattr(out, "captured_depth"):
        out.captured_depth.rotation = rot_deg
    return out


def crop_capture(cap, crop_cam: CropCam):
    """Functional crop: re-derives the capture with a new crop config applied
    on top of the current camera."""
    if isinstance(cap, RGBDPinholeCapture):
        out = RGBDPinholeCapture(cap.img_path, cap.depth_path,
                                 cap.pinhole_cam, cap.cam_pose, crop_cam)
    elif isinstance(cap, RGBPinholeCapture):
        out = RGBPinholeCapture(cap.img_path, cap.pinhole_cam, cap.cam_pose,
                                crop_cam)
    else:
        raise ValueError(f"cannot crop {type(cap)}")
    if hasattr(out, "captured_image"):
        out.captured_image.rotation = cap.captured_image.rotation
    if hasattr(out, "captured_depth"):
        out.captured_depth.rotation = cap.captured_depth.rotation
    return out
