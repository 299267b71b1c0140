"""Point-cloud (un)projection (counterpart of cotr_tpu/geometry/projector.py).

The numpy functions are the JAX package's, line for line: they feed the
host's supervision synthesis, so the order of the filters and the index
bookkeeping decide which rows a sample draws. ``project_points`` and
``unproject_depth`` are their batched torch counterparts (the JAX module's
``*_jnp`` functions), which run on their input's device and keep static
shapes: callers mask invalid rows themselves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def pcd_2d_to_pcd_3d(pcd: np.ndarray, depth: np.ndarray,
                     intrinsic: np.ndarray, motion: Optional[np.ndarray] = None,
                     return_index: bool = False):
    """Lift 2D points+depth to 3D.

    pcd (N, >=2) pixel xy [+features]; depth (N, 1); intrinsic (3, 3);
    motion optional (4, 4) e.g. camera_to_world. Filters z<=0 (and w==0
    after motion), tracks surviving indices when return_index.
    """
    if not (pcd.ndim == 2 and pcd.shape[1] >= 2 and depth.ndim == 2
            and depth.shape[1] == 1 and intrinsic.shape == (3, 3)):
        raise ValueError(f"pcd {pcd.shape}, depth {depth.shape}, intrinsic "
                         f"{intrinsic.shape}: want (N, >=2), (N, 1), (3, 3)")

    x, y, z = pcd[:, 0], pcd[:, 1], depth[:, 0]
    ones = np.ones_like(x)
    xyz = np.stack([x, y, ones], axis=1)
    xyz = (np.linalg.inv(intrinsic) @ xyz.T).T * z[..., None]
    mask1 = np.where(xyz[:, 2] > 0)
    xyz = xyz[mask1]

    mask2 = None
    if motion is not None:
        if motion.shape != (4, 4):
            raise ValueError(f"motion must be (4, 4), got {motion.shape}")
        xyzw = np.concatenate([xyz, np.ones_like(xyz[:, 0:1])], axis=1)
        xyzw = (motion @ xyzw.T).T
        mask2 = np.where(xyzw[:, 3] != 0)
        xyzw = xyzw[mask2]
        xyzw /= xyzw[:, 3:4]
        xyz = xyzw[:, 0:3]

    if pcd.shape[1] > 2:
        features = pcd[:, 2:][mask1]
        if mask2 is not None:
            features = features[mask2]
        xyz = np.concatenate([xyz, features], axis=1)

    if return_index:
        idx = np.arange(pcd.shape[0])[mask1]
        if mask2 is not None:
            idx = idx[mask2]
        return xyz, idx
    return xyz


def pcd_3d_to_pcd_2d(pcd: np.ndarray, intrinsic: np.ndarray,
                     extrinsic: np.ndarray, size: Tuple[int, int],
                     keep_z: bool, crop: bool = True, filter_neg: bool = True,
                     norm_coord: bool = True, return_index: bool = False):
    """Project 3D points into a camera.

    size (h, w); crop keeps points with 0 <= x < w-1 and 0 <= y < h-1;
    norm_coord maps to [-1, 1].
    """
    if not (pcd.ndim == 2 and pcd.shape[1] >= 3):
        raise ValueError(f"pcd must be (N, >=3), got {pcd.shape}")
    xyzw = np.concatenate([pcd[:, 0:3], np.ones_like(pcd[:, 0:1])], axis=1)
    cam_pts = (np.matmul(intrinsic, extrinsic) @ xyzw.T).T
    if filter_neg:
        mask1 = cam_pts[:, 2] > 0.0
    else:
        mask1 = np.ones_like(cam_pts[:, 2], dtype=bool)
    cam_pts = cam_pts[mask1]
    img_pts = (cam_pts / cam_pts[:, 2:3])[:, :2]
    if crop:
        mask2 = ((img_pts[:, 0] >= 0) & (img_pts[:, 0] < size[1] - 1) &
                 (img_pts[:, 1] >= 0) & (img_pts[:, 1] < size[0] - 1))
    else:
        mask2 = np.ones_like(img_pts[:, 0], dtype=bool)
    if norm_coord:
        img_pts = (img_pts / np.asarray(size)[::-1]) * 2 - 1

    feats = pcd[mask1][:, 3:][mask2]
    if keep_z:
        out = np.concatenate([img_pts[mask2], cam_pts[mask2][:, 2:3], feats],
                             axis=1)
    else:
        out = np.concatenate([img_pts[mask2], feats], axis=1)
    if return_index:
        return out, np.arange(pcd.shape[0])[mask1][mask2]
    return out


def pcd_2d_to_img_2d(pcd: np.ndarray, size: Tuple[int, int],
                     has_z: bool = False, keep_z: bool = False) -> np.ndarray:
    """Z-ordered point splatting onto an image grid: nearer points (smaller
    z) overwrite farther ones by sorting descending and painting last-wins."""
    if not (pcd.ndim == 2 and pcd.shape[-1] >= 2):
        raise ValueError(f"pcd must be (N, >=2), got {pcd.shape}")
    if has_z:
        pcd = pcd[pcd[:, 2].argsort()[::-1]]
        if not keep_z:
            pcd = np.delete(pcd, [2], axis=1)
    idx = np.round(pcd[:, 0:2]).astype(np.int32)
    idx[:, 0] = np.clip(idx[:, 0], 0, size[1] - 1)
    idx[:, 1] = np.clip(idx[:, 1], 0, size[0] - 1)
    c = pcd.shape[-1] - 2
    if c == 0:
        canvas = np.zeros((*size, 1))
        canvas[idx[:, 1], idx[:, 0]] = 1.0
    else:
        canvas = np.zeros((*size, c))
        canvas[idx[:, 1], idx[:, 0]] = pcd[:, 2:]
    return canvas


def img_2d_to_pcd_2d(img: np.ndarray, norm_coord: bool = True) -> np.ndarray:
    """(h, w, c) image -> (h*w, 2+c) [x, y, features]."""
    h, w, c = img.shape
    if norm_coord:
        x, y = np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h))
    else:
        x, y = np.meshgrid(np.linspace(0, w - 1, w), np.linspace(0, h - 1, h))
    return np.concatenate([x.reshape(-1, 1), y.reshape(-1, 1),
                           img.reshape(-1, c)], axis=1)


def img_2d_to_pcd_3d(depth: np.ndarray, intrinsic: np.ndarray,
                     img: Optional[np.ndarray] = None,
                     motion: Optional[np.ndarray] = None) -> np.ndarray:
    """Depth image -> 3D cloud."""
    if depth.ndim != 2:
        raise ValueError(f"depth must be (h, w), got {depth.shape}")
    pcd_img = img_2d_to_pcd_2d(depth[..., None], norm_coord=False)
    mask = np.where(pcd_img[:, 2] > 0)
    pcd_img = pcd_img[mask]
    xy, z = pcd_img[:, :2], pcd_img[:, 2:3]
    if img is not None:
        feat = img.reshape(-1, img.shape[-1])[mask]
        xy = np.concatenate([xy, feat], axis=1)
    return pcd_2d_to_pcd_3d(xy, z, intrinsic, motion=motion)


def optical_flow_from_a_to_b(cap_a, cap_b) -> np.ndarray:
    """Ground-truth flow between two RGBD captures: for each pixel of
    ``cap_a``, the pixel of ``cap_b`` that sees the same point (0 where
    none does)."""
    h, w = cap_b.pinhole_cam.shape[:2]
    x, y = np.meshgrid(np.linspace(0, w - 1, w), np.linspace(0, h - 1, h))
    coord_map = np.stack([x, y], axis=2)
    pcd_world = cap_b.get_point_cloud_world_from_depth(coord_map)
    projected = pcd_3d_to_pcd_2d(
        pcd_world, cap_a.pinhole_cam.intrinsic_mat,
        cap_a.cam_pose.world_to_camera[0:3, :],
        cap_a.pinhole_cam.shape[:2], keep_z=True, crop=True, filter_neg=True,
        norm_coord=False)
    return pcd_2d_to_img_2d(projected, cap_a.pinhole_cam.shape[:2],
                            has_z=True, keep_z=False)


# --------------------------------------------------------- torch versions

def project_points(pcd_xyz: torch.Tensor, intrinsic: torch.Tensor,
                   extrinsic_3x4: torch.Tensor) -> torch.Tensor:
    """Maskless batched projection on the input's device: (N, 3) -> (N, 3)
    [x, y, z_cam]; a point with z_cam == 0 keeps its unscaled x, y."""
    xyzw = torch.cat([pcd_xyz, torch.ones_like(pcd_xyz[:, :1])], dim=1)
    cam = (intrinsic @ extrinsic_3x4 @ xyzw.T).T
    z = cam[:, 2:3]
    xy = cam[:, :2] / torch.where(z == 0, torch.ones_like(z), z)
    return torch.cat([xy, z], dim=1)


def unproject_depth(depth: torch.Tensor, intrinsic: torch.Tensor,
                    camera_to_world: torch.Tensor) -> torch.Tensor:
    """(h, w) depth -> (h*w, 3) world points on the input's device; a
    zero-depth pixel gives the camera centre (mask with depth > 0
    downstream)."""
    h, w = depth.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=depth.device),
                            torch.arange(w, device=depth.device),
                            indexing="ij")
    pix = torch.stack([xs.to(depth.dtype), ys.to(depth.dtype),
                       torch.ones_like(depth)], dim=-1).reshape(-1, 3)
    rays = (torch.linalg.inv(intrinsic) @ pix.T).T
    cam_pts = rays * depth.reshape(-1, 1)
    xyzw = torch.cat([cam_pts, torch.ones_like(cam_pts[:, :1])], dim=1)
    world = (camera_to_world @ xyzw.T).T
    return world[:, :3] / world[:, 3:4]


def splat_reprojections(points: torch.Tensor, proj: torch.Tensor,
                        size: Tuple[int, int]) -> torch.Tensor:
    """Project world points into a block of cameras at once and splat each
    camera's depths: ``points`` (N, 3), ``proj`` (B, 3, 4) (each camera's
    intrinsic @ extrinsic) -> (B, h, w), on the inputs' device and dtype.

    Per camera it is ``pcd_3d_to_pcd_2d(keep_z=True, crop=True,
    filter_neg=True, norm_coord=False)`` then ``pcd_2d_to_img_2d`` (no z
    sort): a point counts where z > 0 and 0 <= x < w - 1, 0 <= y < h - 1;
    its pixel is its position rounded half to even; where several points
    hit one pixel the last in point order wins, as numpy's fancy
    assignment keeps the last write; 0 where none hits. Duplicate indices
    in a CUDA ``index_put_`` leave the winner undefined, so the winner is
    the largest point ordinal (``scatter_reduce`` "amax", deterministic on
    every device) and its z is gathered after."""
    h, w = size
    xyzw = torch.cat([points, torch.ones_like(points[:, :1])], dim=1)
    cam = torch.matmul(proj, xyzw.T)                         # (B, 3, N)
    z = cam[:, 2]
    x, y = cam[:, 0] / z, cam[:, 1] / z
    keep = (z > 0) & (x >= 0) & (x < w - 1) & (y >= 0) & (y < h - 1)
    pixel = torch.where(keep, torch.round(y).long() * w
                        + torch.round(x).long(), 0)
    ordinal = torch.arange(points.shape[0], device=points.device)
    ordinal = torch.where(keep, ordinal, -1)
    winner = torch.full((proj.shape[0], h * w), -1, dtype=torch.long,
                        device=points.device)
    winner.scatter_reduce_(1, pixel, ordinal, "amax")
    hit = winner >= 0
    depth = torch.where(hit, torch.gather(z, 1, winner.clamp(min=0)), 0)
    return depth.reshape(-1, h, w)
