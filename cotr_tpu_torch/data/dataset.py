"""Correspondence supervision for training (counterpart of
cotr_tpu/data/dataset.py), on the host.

* ``compute_corrs``: lift every valid depth pixel of one capture to 3D,
  project into the other camera, keep it where the other depth agrees
  (|z_proj - z_depth| < 0.5). In C++ (``native.synth_corrs``) or numpy, the
  same rows in the same order.
* ``CotrDataset`` (stages 1 and 2): a query capture and a kNN neighbour,
  both pre-cropped to 256 squares, their correspondences resampled to
  ``num_kp``, flipped at random, on one normalized canvas, doubled both
  ways; or, with ``device_synth``, the candidate layout of
  ``data.device_synth`` whose supervision the train step synthesizes.
* ``CotrZoomDataset`` (stage 3): both captures cropped around a seed
  correspondence at a random log-spaced scale.
* The helpers: resample to ``num_kp``, flip, normalize, double, batch.

Each dataset draws from three streams as the JAX package does, and so gives
the same sample for the same (seed, index): ``random.Random(seed)`` for the
kNN pick, ``RandomState(seed)`` for trims, flips, rotations and re-draws,
``random.Random(seed + 1)`` for the rotation chance.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, Optional

import numpy as np

from cotr_tpu_torch import native
from cotr_tpu_torch.data.device_synth import emit_device_sample
from cotr_tpu_torch.data.megadepth import DataConfig, MegadepthDataset
from cotr_tpu_torch.geometry import capture as capture_mod
from cotr_tpu_torch.geometry.capture import CropCamConfig
from cotr_tpu_torch.geometry.projector import (pcd_2d_to_pcd_3d,
                                               pcd_3d_to_pcd_2d)
from cotr_tpu_torch.inference.grouped import patch_box_np
from cotr_tpu_torch.utils.constants import (IMAGENET_MEAN, IMAGENET_STD,
                                           MAX_SIZE)


def two_images_side_by_side(img_a: np.ndarray,
                            img_b: np.ndarray) -> np.ndarray:
    """Concatenate two equal-shaped HWC images along width."""
    if img_a.shape != img_b.shape:
        raise ValueError(f"{img_a.shape} vs {img_b.shape}")
    return np.concatenate([img_a, img_b], axis=1)


def normalize_canvas(canvas: np.ndarray) -> np.ndarray:
    """uint8 or float (N)HWC canvas -> ImageNet-normalized float32 (uint8 is
    scaled by 1/255 first)."""
    x = np.asarray(canvas, dtype=np.float32)
    if canvas.dtype == np.uint8:
        x = x / 255.0
    mean = np.asarray(IMAGENET_MEAN, dtype=np.float32)
    std = np.asarray(IMAGENET_STD, dtype=np.float32)
    return (x - mean) / std


def compute_corrs(from_cap, to_cap, reduced_size: Optional[int] = None,
                  rng: Optional[np.random.RandomState] = None,
                  impl: Optional[str] = None) -> Optional[np.ndarray]:
    """Depth-consistent correspondences from ``from_cap`` to ``to_cap``:
    (N, 4) float64 [x_from, y_from, x_to, y_to], or None when no pixel
    survives.

    ``impl``: "native" (C++, every valid pixel, the values rounded to
    float32 as the JAX package's native path returns them) or "numpy"
    (float64; with ``reduced_size``, ``reduced_size`` pixels drawn from
    ``rng`` first). By default "native" without ``reduced_size`` and
    "numpy" with it, as the JAX package chooses where its library is built.
    The native path builds or raises; it never falls back to numpy."""
    if impl is None:
        impl = "native" if reduced_size is None else "numpy"
    if impl == "native":
        if reduced_size is not None:
            raise ValueError("the native path takes every valid pixel; "
                             "reduced_size needs impl='numpy'")
        out = native.synth_corrs(
            from_cap.depth_map,
            np.linalg.inv(from_cap.pinhole_cam.intrinsic_mat),
            from_cap.cam_pose.camera_to_world,
            to_cap.pinhole_cam.intrinsic_mat @
            to_cap.cam_pose.world_to_camera[0:3, :],
            to_cap.depth_map)
        return out.astype(np.float64) if out.shape[0] else None
    if impl != "numpy":
        raise ValueError(f"impl must be 'native' or 'numpy', got {impl!r}")
    ys, xs = np.where(from_cap.depth_map > 0)
    ys, xs = ys[..., None], xs[..., None]
    if reduced_size is not None and ys.shape[0] > 0:
        rng = rng or np.random
        take = min(reduced_size, ys.shape[0])
        sel = rng.choice(ys.shape[0], take, replace=False)
        ys, xs = ys[sel], xs[sel]
    if ys.shape[0] == 0:
        return None
    zs = from_cap.depth_map[ys[:, 0], xs[:, 0]][..., None]
    from_xy = np.concatenate([xs, ys], axis=1)
    world, idx1 = pcd_2d_to_pcd_3d(from_xy, zs,
                                   from_cap.pinhole_cam.intrinsic_mat,
                                   motion=from_cap.cam_pose.camera_to_world,
                                   return_index=True)
    to_xyz, idx2 = pcd_3d_to_pcd_2d(
        world, to_cap.pinhole_cam.intrinsic_mat,
        to_cap.cam_pose.world_to_camera[0:3, :], to_cap.image.shape[:2],
        keep_z=True, crop=True, filter_neg=True, norm_coord=False,
        return_index=True)
    to_xy = to_xyz[:, 0:2]
    z_proj = to_xyz[:, 2:3]
    z_depth = to_cap.depth_map[
        np.floor(to_xy[:, 1:2]).astype(int)[:, 0],
        np.floor(to_xy[:, 0:1]).astype(int)[:, 0]][..., None]
    mask = (np.abs(z_depth - z_proj) < 0.5)[:, 0]
    if mask.sum() == 0:
        return None
    return np.concatenate([from_xy[idx1][idx2][mask], to_xy[mask]], axis=1)


def _trim_corrs(corrs: np.ndarray, num_kp: int,
                rng: np.random.RandomState) -> np.ndarray:
    """Resample with replacement to exactly num_kp rows."""
    n = corrs.shape[0]
    if n >= num_kp:
        return corrs[rng.choice(n, num_kp)]
    extra = corrs[rng.choice(n, num_kp - n)]
    return np.concatenate([corrs, extra], axis=0)


def _package(query_img: np.ndarray, nn_img: np.ndarray, corrs: np.ndarray,
             bidirectional: bool, rng: np.random.RandomState,
             raw_uint8: bool = False) -> Dict[str, np.ndarray]:
    """Flip augmentation + canvas normalization + bidirectional doubling.

    With ``raw_uint8`` the canvas stays uint8 and is normalized on the
    device inside the step (a quarter of the bytes to upload)."""
    corrs = corrs.astype(np.float64).copy()
    if rng.uniform() < 0.5:
        corrs[:, 0] = MAX_SIZE - 1 - corrs[:, 0]
        corrs[:, 2] = MAX_SIZE - 1 - corrs[:, 2]
        sbs = two_images_side_by_side(np.fliplr(query_img), np.fliplr(nn_img))
    else:
        sbs = two_images_side_by_side(query_img, nn_img)
    corrs[:, 2] += MAX_SIZE
    corrs /= np.array([MAX_SIZE * 2, MAX_SIZE, MAX_SIZE * 2, MAX_SIZE])
    if not ((0.0 <= corrs[:, 0]).all() and (corrs[:, 0] <= 0.5).all()
            and (0.0 <= corrs[:, 1]).all() and (corrs[:, 1] <= 1.0).all()
            and (0.5 <= corrs[:, 2]).all() and (corrs[:, 2] <= 1.0).all()
            and (0.0 <= corrs[:, 3]).all() and (corrs[:, 3] <= 1.0).all()):
        raise ValueError("correspondences outside their canvas halves")
    sbs = np.ascontiguousarray(sbs)
    out = {
        "image": (sbs.astype(np.uint8) if raw_uint8
                  else normalize_canvas(sbs)),
        "corrs": corrs.astype(np.float32),
    }
    if bidirectional:
        out["queries"] = np.concatenate([corrs[:, :2], corrs[:, 2:]],
                                        axis=0).astype(np.float32)
        out["targets"] = np.concatenate([corrs[:, 2:], corrs[:, :2]],
                                        axis=0).astype(np.float32)
    else:
        out["queries"] = corrs[:, :2].astype(np.float32)
        out["targets"] = corrs[:, 2:].astype(np.float32)
    return out


class CotrDataset:
    """Stage 1/2 dataset: captures pre-cropped to 256 squares by crop_cam
    ('crop_center_and_resize'); correspondences from full-frame depth
    reprojection. With ``device_synth`` a sample is the candidate layout of
    ``data.device_synth.emit_device_sample`` (a uint8 canvas, candidate
    pixels, cameras and the quantized query depth), whose supervision the
    train step synthesizes on the device."""

    def __init__(self, cfg: DataConfig, dataset_type: str, seed: int = 0,
                 device_synth: bool = False, cand_factor: int = 6):
        self.cfg = cfg
        self.dataset_type = dataset_type
        self.sfm = MegadepthDataset(cfg, dataset_type,
                                    rng=random.Random(seed))
        self.rng = np.random.RandomState(seed)
        self._py_rng = random.Random(seed + 1)
        self.device_synth = device_synth
        self.cand_factor = cand_factor

    def __len__(self):
        if self.dataset_type == "val":
            return min(1000, self.sfm.num_queries)
        return self.sfm.num_queries

    def _augment_rotation(self, query_cap, nn_cap):
        cfg = self.cfg
        if cfg.need_rotation:
            if self._py_rng.random() < cfg.rotation_chance:
                theta = self.rng.uniform(-1, 1) * cfg.max_rotation
                query_cap = capture_mod.rotate_capture(query_cap, theta)
            if self._py_rng.random() < cfg.rotation_chance:
                theta = self.rng.uniform(-1, 1) * cfg.max_rotation
                nn_cap = capture_mod.rotate_capture(nn_cap, theta)
        return query_cap, nn_cap

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        for _attempt in range(64):
            query_cap, nn_caps = self.sfm.get_query_with_knn(index)
            nn_cap = nn_caps[0]
            query_cap, nn_cap = self._augment_rotation(query_cap, nn_cap)
            if self.device_synth:
                # a cheap viability check only: projection and occlusion run
                # on the device, where too few valid picks weigh less
                if (np.count_nonzero(nn_cap.depth_map) < self.cfg.num_kp
                        or np.count_nonzero(query_cap.depth_map) == 0):
                    index = self.rng.randint(0, len(self))
                    continue
                return emit_device_sample(query_cap, nn_cap,
                                          self.cfg.num_kp, self.rng,
                                          cand_factor=self.cand_factor)
            corrs = compute_corrs(nn_cap, query_cap)
            # corrs: nn -> query; packaged as (query, nn), query keypoints
            # first
            if corrs is not None and corrs.shape[0] >= self.cfg.num_kp:
                corrs = np.concatenate([corrs[:, 2:], corrs[:, :2]], axis=1)
                corrs = _trim_corrs(corrs, self.cfg.num_kp, self.rng)
                return _package(query_cap.image, nn_cap.image, corrs,
                                self.cfg.bidirectional, self.rng)
            index = self.rng.randint(0, len(self))
        raise RuntimeError("could not synthesize a sample after 64 attempts")


class CotrZoomDataset(CotrDataset):
    """Stage 3 zoom dataset: both captures cropped around a seed
    correspondence at a random log-spaced scale, the query side jittered,
    correspondences recomputed inside the crops."""

    def __init__(self, cfg: DataConfig, dataset_type: str, seed: int = 0):
        if cfg.crop_cam not in ("no_crop", "crop_center") or cfg.use_ram:
            raise ValueError("the zoom dataset crops full frames: crop_cam "
                             "'no_crop' or 'crop_center', use_ram off")
        super().__init__(cfg, dataset_type, seed)
        self.zooms = np.logspace(np.log10(cfg.zoom_start),
                                 np.log10(cfg.zoom_end),
                                 num=cfg.zoom_levels)

    def _get_zoomed_cap(self, cap, pos, scale, jitter):
        h, w = cap.image.shape[:2]
        x0, y0, size = patch_box_np(np.asarray(pos, np.float64)[None],
                                    scale, h, w)
        jit = np.array([size, size]) * self.rng.uniform(-jitter, jitter, 2)
        x0, y0, size = patch_box_np(
            (np.asarray(pos, np.float64) + jit)[None], scale, h, w)
        cfg = CropCamConfig(x=int(x0[0]), y=int(y0[0]), w=int(size),
                            h=int(size), out_w=MAX_SIZE, out_h=MAX_SIZE,
                            orig_w=w, orig_h=h)
        return capture_mod.crop_capture(cap, cfg)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        for _attempt in range(64):
            query_cap, nn_caps = self.sfm.get_query_with_knn(index)
            nn_cap = nn_caps[0]
            query_cap, nn_cap = self._augment_rotation(query_cap, nn_cap)

            seed_corrs = compute_corrs(nn_cap, query_cap, reduced_size=100,
                                       rng=self.rng)
            if seed_corrs is None:
                index = self.rng.randint(0, len(self))
                continue
            seed = seed_corrs[self.rng.permutation(len(seed_corrs))[0]]

            s = self.rng.choice(self.zooms)
            nn_zoom = self._get_zoomed_cap(nn_cap, seed[:2], s, 0)
            query_zoom = self._get_zoomed_cap(query_cap, seed[2:], s,
                                              self.cfg.zoom_jitter)
            corrs = compute_corrs(query_zoom, nn_zoom)
            if corrs is None or corrs.shape[0] < self.cfg.num_kp:
                index = self.rng.randint(0, len(self))
                continue
            corrs = corrs[self.rng.permutation(corrs.shape[0])]
            corrs = _trim_corrs(corrs, self.cfg.num_kp, self.rng)
            return _package(query_zoom.image, nn_zoom.image, corrs,
                            self.cfg.bidirectional, self.rng)
        raise RuntimeError("could not synthesize a zoom sample")


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Stack dataset samples into fixed-shape batches, in one thread (the
    prefetching version is ``data.loader.PrefetchLoader``)."""
    order = np.arange(len(dataset))
    rng = np.random.RandomState(seed)
    if shuffle:
        rng.shuffle(order)
    batch = []
    for idx in order:
        batch.append(dataset[int(idx)])
        if len(batch) == batch_size:
            yield {k: np.stack([s[k] for s in batch]) for k in batch[0]}
            batch = []
    if batch and not drop_last:
        yield {k: np.stack([s[k] for s in batch]) for k in batch[0]}
