"""Computer-vision solvers (counterpart of cotr_tpu/ops/geometry_cv.py):

* affine from 3 point pairs, homography from 4 pairs and its application,
  two-view midpoint triangulation and pixel rays: numpy, copied as they are;
* :func:`warp_perspective`: a bilinear inverse warp in torch, on the image's
  device;
* the normalized 8-point fundamental matrix, the Sampson distance and
  RANSAC over all hypotheses at once, in torch. RANSAC draws its
  hypotheses from a ``torch.Generator`` seeded with ``seed``; the JAX
  package draws them from a threefry key, so the two agree on the outcome
  (the inlier set, the refitted F), not on the draws.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from cotr_tpu_torch.ops.sampling import gather_bilinear
from cotr_tpu_torch.utils.device import resolve_device

Array = Union[np.ndarray, torch.Tensor]


def affine_from_3pts(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 2x3 affine A with dst = src @ A[:, :2].T + A[:, 2]."""
    src_h = np.concatenate([src, np.ones((3, 1))], axis=1)  # (3, 3)
    sol = np.linalg.solve(src_h, dst)  # (3, 2)
    return sol.T  # (2, 3)


def homography_from_4pts(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 3x3 homography (DLT on 4 correspondences)."""
    a = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    a = np.asarray(a)
    _, _, vt = np.linalg.svd(a)
    h = vt[-1].reshape(3, 3)
    return h / h[2, 2]


def apply_homography(h: np.ndarray, pts: np.ndarray) -> np.ndarray:
    p = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1)
    q = p @ h.T
    return q[:, :2] / q[:, 2:3]


def _gather_bilinear_zero_outside(image: torch.Tensor, x: torch.Tensor,
                                  y: torch.Tensor) -> torch.Tensor:
    """The zero-padded bilinear gather of :func:`warp_perspective`
    (``ops.sampling.gather_bilinear``)."""
    return gather_bilinear(image, x, y, zero_outside=True)


def warp_perspective(img: torch.Tensor, h: np.ndarray,
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse-warp ``img`` (H, W, C) through the homography ``h`` onto an
    (out_h, out_w) grid: output pixel p gets img[h^-1 p], bilinear, zero
    where a corner falls outside (cv2.warpPerspective's convention). Runs
    on the tensor's device and returns float32 there."""
    image = img.float()
    dev = image.device
    oh, ow = out_hw
    ys, xs = torch.meshgrid(torch.arange(oh, device=dev),
                            torch.arange(ow, device=dev), indexing="ij")
    pts = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(oh * ow, device=dev, dtype=torch.long)],
                      dim=1).float()
    hinv = torch.as_tensor(np.linalg.inv(h), dtype=torch.float32,
                           device=dev)
    # summed elementwise: no TF32 product touches the coordinates
    src = (pts[:, None, :] * hinv[None]).sum(-1)
    sx = (src[:, 0] / src[:, 2]).reshape(oh, ow)
    sy = (src[:, 1] / src[:, 2]).reshape(oh, ow)
    return _gather_bilinear_zero_outside(image, sx, sy)


# --------------------------------------------------------------- fundamental

def _points(p: Array, device=None) -> torch.Tensor:
    """Points as a float32 tensor (numpy input is taken in float32, as the
    JAX package takes it)."""
    if torch.is_tensor(p):
        return p.to(device) if device is not None else p
    return torch.as_tensor(np.asarray(p), dtype=torch.float32, device=device)


def _normalize_pts(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalization of (..., N, 2) points: centroid to the origin,
    mean distance sqrt(2). Returns (normalized points, (..., 3, 3) T)."""
    mean = pts.mean(dim=-2)
    dist = torch.linalg.norm(pts - mean[..., None, :], dim=-1).mean(dim=-1)
    scale = np.sqrt(2.0) / dist.clamp(min=1e-8)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    t = torch.stack([torch.stack([scale, zero, -scale * mean[..., 0]], -1),
                     torch.stack([zero, scale, -scale * mean[..., 1]], -1),
                     torch.stack([zero, zero, one], -1)], dim=-2)
    shift = (scale[..., None] * mean)[..., None, :]
    return pts * scale[..., None, None] - shift, t


def eight_point(p1: Array, p2: Array) -> torch.Tensor:
    """Normalized 8-point fundamental matrix from (..., 8+, 2) pairs, with
    unit Frobenius norm (f[2, 2] can be geometrically zero, and the Sampson
    distance does not see the scale). Leading dimensions are a batch."""
    p1 = _points(p1)
    p2 = _points(p2, p1.device)
    n1, t1 = _normalize_pts(p1)
    n2, t2 = _normalize_pts(p2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    f = vt[..., -1, :].reshape(*a.shape[:-2], 3, 3)
    # enforce rank 2
    u, s, v = torch.linalg.svd(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    f = (u * s[..., None, :]) @ v
    f = t2.transpose(-1, -2) @ f @ t1
    norm = torch.linalg.norm(f, dim=(-2, -1), keepdim=True)
    return f / norm.clamp(min=1e-12)


def _sampson_dist(f: torch.Tensor, p1: torch.Tensor,
                  p2: torch.Tensor) -> torch.Tensor:
    """Sampson distances of (N, 2) pairs under (..., 3, 3) F: (..., N)."""
    ph1 = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=1)
    ph2 = torch.cat([p2, torch.ones_like(p2[:, :1])], dim=1)
    fx1 = ph1 @ f.transpose(-1, -2)
    ftx2 = ph2 @ f
    num = (ph2 * fx1).sum(-1) ** 2
    den = (fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2
           + ftx2[..., 1] ** 2)
    return num / den.clamp(min=1e-12)


def find_fundamental_ransac(pts1: Array, pts2: Array,
                            threshold: float = 1.0,
                            num_hypotheses: int = 2048, seed: int = 0,
                            refine: bool = True, device="cuda"
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """cv2.findFundamentalMat(FM_RANSAC) equivalent: every hypothesis (8
    distinct pairs each) is solved in one batched pass on ``device`` (the
    card unless the caller asks for the CPU), the one with the most inliers
    wins, and with ``refine`` the 8-point fit is redone on its inliers.

    Returns (F, inlier_mask) as numpy arrays."""
    if len(pts1) < 8 or len(pts1) != len(pts2):
        raise ValueError(f"need at least 8 correspondences in pairs, got "
                         f"{len(pts1)} and {len(pts2)}")
    dev = resolve_device(device)
    p1 = _points(pts1, dev)
    p2 = _points(pts2, dev)
    n = p1.shape[0]
    gen = torch.Generator().manual_seed(seed)
    idx = torch.rand(num_hypotheses, n, generator=gen).argsort(dim=1)[:, :8]
    idx = idx.to(dev)
    fs = eight_point(p1[idx], p2[idx])  # (H, 3, 3)
    counts = (_sampson_dist(fs, p1, p2) < threshold).sum(dim=1)
    f = fs[counts.argmax()]
    mask = (_sampson_dist(f, p1, p2) < threshold).cpu().numpy()
    if refine and mask.sum() >= 8:
        keep = torch.from_numpy(np.where(mask)[0]).to(dev)
        f = eight_point(p1[keep], p2[keep])
        mask = (_sampson_dist(f, p1, p2) < threshold).cpu().numpy()
    return f.cpu().numpy(), mask


# -------------------------------------------------------------- triangulation

def triangulate_rays_midpoint(origins_a: np.ndarray, dirs_a: np.ndarray,
                              origins_b: np.ndarray, dirs_b: np.ndarray
                              ) -> np.ndarray:
    """Closed-form midpoint of the common perpendicular of two ray bundles.
    All inputs (N, 3)."""
    da = dirs_a / np.linalg.norm(dirs_a, axis=1, keepdims=True)
    db = dirs_b / np.linalg.norm(dirs_b, axis=1, keepdims=True)
    w0 = origins_a - origins_b
    a = np.sum(da * da, axis=1)
    b = np.sum(da * db, axis=1)
    c = np.sum(db * db, axis=1)
    d = np.sum(da * w0, axis=1)
    e = np.sum(db * w0, axis=1)
    denom = a * c - b * b
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    s = (b * e - c * d) / denom
    t = (a * e - b * d) / denom
    pa = origins_a + s[:, None] * da
    pb = origins_b + t[:, None] * db
    return 0.5 * (pa + pb)


def pixel_rays(pts_xy: np.ndarray, intrinsic: np.ndarray,
               camera_to_world: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Back-project pixels to world-space rays: (origins, directions)."""
    n = pts_xy.shape[0]
    ph = np.concatenate([pts_xy, np.ones((n, 1))], axis=1)
    dirs_cam = (np.linalg.inv(intrinsic) @ ph.T).T
    r = camera_to_world[:3, :3]
    t = camera_to_world[:3, 3]
    dirs_world = (r @ dirs_cam.T).T
    origins = np.broadcast_to(t, (n, 3))
    return origins, dirs_world
