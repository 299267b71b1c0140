"""Synthetic homography correspondence dataset (counterpart of
cotr_tpu/data/synthetic.py).

A 256-square crop of a texture image is warped through a random perspective
transform, and the exact grid correspondences supervise it. Samples are the
fixed-shape dicts of ``data.dataset._package`` (``image`` layout) or, with
``device_warp``, ``{crop, h_mat, corrs, queries, targets[, photo]}``, whose B
side the train step warps on the device.

A sample draws the same ``np.random.RandomState`` stream as the JAX one, so
the same (seed, index) gives the same homography, correspondences and
photometric jitter, bit for bit. Images are resized by
``ops.sampling.resize_pil_u8_host``, PIL's bilinear resize without PIL.
Textures are image files (read with PIL, imported only there) or ``.npy``
files holding uint8 (H, W, 3) arrays, which need no PIL.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from cotr_tpu_torch.data.dataset import _package, _trim_corrs
from cotr_tpu_torch.ops.geometry_cv import (apply_homography,
                                            homography_from_4pts)
from cotr_tpu_torch.ops.sampling import resize_pil_u8_host
from cotr_tpu_torch.utils.constants import MAX_SIZE

#: the JAX package's default texture directory (cotr_tpu/data/synthetic.py):
#: the reference's sample images, absent from most checkouts
SAMPLE_IMAGES_DIR = os.path.join(os.sep, "root", "reference", "sample_data",
                                 "imgs")


def default_texture_paths() -> List[str]:
    """The JAX package's default glob (``*.jpg`` and ``*.JPG`` of
    :data:`SAMPLE_IMAGES_DIR`), without the held-out evaluation images."""
    return [p for p in sorted(
        glob.glob(os.path.join(SAMPLE_IMAGES_DIR, "*.jpg")) +
        glob.glob(os.path.join(SAMPLE_IMAGES_DIR, "*.JPG")))
        if os.path.basename(p) not in SyntheticHomographyDataset.EVAL_TEXTURES]


def read_texture(path: str) -> np.ndarray:
    """A texture as a uint8 (H, W, 3) array: a ``.npy`` file as it is
    stored, any other file through PIL (imported here, so a machine without
    PIL reads ``.npy`` textures)."""
    if path.endswith(".npy"):
        img = np.load(path, allow_pickle=False)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"{path}: a texture is uint8 (H, W, 3), got "
                             f"{img.dtype} {img.shape}")
        return img
    import PIL.Image

    with PIL.Image.open(path) as im:
        return np.array(im.convert("RGB"))


def _warp_host(img: np.ndarray, h_mat: np.ndarray, out_hw) -> np.ndarray:
    """Inverse bilinear warp on the host, edge-clamped: one gather for all
    channels."""
    oh, ow = out_hw
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:oh, 0:ow]
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(oh * ow)], axis=0)
    src = np.linalg.inv(h_mat) @ pts
    sx = np.clip(src[0] / src[2], 0.0, w - 1.0)
    sy = np.clip(src[1] / src[2], 0.0, h - 1.0)
    x0 = np.minimum(sx.astype(np.int32), w - 2)
    y0 = np.minimum(sy.astype(np.int32), h - 2)
    fx = (sx - x0)[:, None]
    fy = (sy - y0)[:, None]
    flat = img.reshape(-1, img.shape[-1])
    i00 = flat[y0 * w + x0]
    i01 = flat[y0 * w + x0 + 1]
    i10 = flat[(y0 + 1) * w + x0]
    i11 = flat[(y0 + 1) * w + x0 + 1]
    top = i00 + (i01 - i00) * fx
    bot = i10 + (i11 - i10) * fx
    return (top + (bot - top) * fy).reshape(oh, ow, img.shape[-1])


def _apply_photo_host(img_u8: np.ndarray, gb: np.ndarray) -> np.ndarray:
    """Per-channel gain + bias on a uint8 frame (the host twin of the
    photometric jitter in ops.canvas.canvas_from_crops_and_homographies)."""
    f = img_u8.astype(np.float32) / 255.0
    f = np.clip(f * gb[:3] + gb[3], 0.0, 1.0)
    return (f * 255.0).astype(np.uint8)


def make_procedural_texture(rng: np.random.RandomState,
                            size: int = 512) -> np.ndarray:
    """One contour-rich procedural texture (uint8 RGB).

    Multi-octave smooth noise gives structure at many scales; random
    quantization turns a share of them into sharp-edged blob fields (smooth
    noise alone has weak gradients, which under-constrains correspondence).
    """
    acc = np.zeros((size, size, 3), np.float32)
    amp, total = 1.0, 0.0
    for cells in (4, 8, 16, 32, 64, 128):
        octave = rng.rand(cells, cells, 3).astype(np.float32)
        up = resize_pil_u8_host((octave * 255).astype(np.uint8),
                                (size, size)).astype(np.float32) / 255.0
        acc += amp * up
        total += amp
        amp *= float(rng.uniform(0.4, 0.7))
    acc /= total
    # normalize contrast per channel
    lo = acc.min(axis=(0, 1), keepdims=True)
    hi = acc.max(axis=(0, 1), keepdims=True)
    acc = (acc - lo) / np.maximum(hi - lo, 1e-6)
    mode = rng.randint(3)
    if mode == 0:
        # quantized blob field: sharp iso-contours at random levels
        levels = rng.randint(3, 9)
        acc = np.floor(acc * levels) / max(levels - 1, 1)
    elif mode == 1:
        # high-contrast sigmoid: edge-like transitions, smooth interiors
        acc = 1.0 / (1.0 + np.exp(-12.0 * (acc - 0.5)))
    # mode 2: left smooth (keeps low-texture regions in the distribution)
    # random affine color mix decorrelates channels
    mix = rng.uniform(-0.3, 0.3, (3, 3)) + np.eye(3)
    acc = np.clip(acc @ mix.T, 0.0, 1.0)
    return (acc * 255.0).astype(np.uint8)


class SyntheticHomographyDataset:
    """len() sets the epoch size; a sample is fully determined by (seed,
    index), so epochs shuffle deterministically.

    Options as in the JAX package: ``device_warp`` (emit the crop and the
    homography; the step warps the B side), ``zoom``/``zoom_prob``
    (re-crop both frames around a correspondence at a scale of the
    logspace(1 -> 0.1) ladder), ``rot_deg`` and ``scale_range`` (composed
    into the pair homography), ``photo_jitter`` (per-side gain and bias),
    ``proc_textures`` (procedural textures appended to the pool, drawn from
    the seed), ``tex_aug`` (channel permutation and flips of the crop before
    the warp), ``bidirectional``, ``raw_uint8`` and ``max_crop_side``.
    """

    #: held-out evaluation images (tools/eval_synthetic_pair.py evaluates
    #: on cathedral_1; cathedral_2 is the same scene), never in the default
    #: training set
    EVAL_TEXTURES = ("cathedral_1.jpg", "cathedral_2.jpg",
                     "petrzin_01.png", "petrzin_02.png")

    def __init__(self, image_paths: Optional[Sequence[str]] = None,
                 length: int = 2048, num_kp: int = 100,
                 bidirectional: bool = True, max_corner_jitter: float = 0.2,
                 seed: int = 0, raw_uint8: bool = True,
                 max_crop_side: int = 512, device_warp: bool = False,
                 zoom: bool = False, zoom_prob: float = 1.0,
                 rot_deg: float = 0.0, scale_range=None,
                 photo_jitter: float = 0.0,
                 proc_textures: int = 0, tex_aug: bool = False):
        if image_paths is None:
            image_paths = default_texture_paths()
        if not image_paths:
            raise ValueError("no texture images found")
        self.images: List[np.ndarray] = []
        for p in image_paths:
            img = read_texture(p)
            if min(img.shape[:2]) >= MAX_SIZE:
                self.images.append(img)
        if not self.images:
            raise ValueError("no usable texture images (need sides of at "
                             f"least {MAX_SIZE} px)")
        tex_rng = np.random.RandomState((seed * 7_368_787 + 0x5EED)
                                        % (2 ** 32))
        for _ in range(proc_textures):
            self.images.append(make_procedural_texture(tex_rng))
        self.tex_aug = tex_aug
        self.length = length
        self.num_kp = num_kp
        self.bidirectional = bidirectional
        self.max_corner_jitter = max_corner_jitter
        self.seed = seed
        self.raw_uint8 = raw_uint8
        self.max_crop_side = max_crop_side
        self.device_warp = device_warp
        self.zoom = zoom
        self.zoom_prob = zoom_prob
        self.zoom_levels = np.logspace(0.0, -1.0, 10)
        self.rot_deg = rot_deg
        self.scale_range = scale_range  # e.g. (0.8, 1.25), log-uniform
        self.photo_jitter = photo_jitter

    def __len__(self):
        return self.length

    def _zoom_crop(self, a: np.ndarray, h_mat: np.ndarray,
                   rng: np.random.RandomState):
        """Re-crop both frames around a seed correspondence at a sampled
        zoom scale (query side jittered by half a crop side, target side
        centered). Returns the new frame A and the crop-to-crop homography
        S_b^-1 H S_a; frame B is warp(A', H') in both layouts."""
        zoom = float(self.zoom_levels[rng.randint(len(self.zoom_levels))])
        side_z = MAX_SIZE * zoom
        lim = MAX_SIZE - 1.0
        for _ in range(8):
            p_a = rng.uniform(0.1 * lim, 0.9 * lim, 2)
            p_b = apply_homography(h_mat, p_a[None])[0]
            if (p_b >= 0).all() and (p_b <= lim).all():
                break
        else:
            return a, h_mat  # the warp pushed everything out; no zoom

        def crop_mat(center, jitter_frac):
            c = center + rng.uniform(-jitter_frac, jitter_frac, 2) * side_z
            x0 = float(np.clip(c[0] - side_z / 2, 0, MAX_SIZE - side_z))
            y0 = float(np.clip(c[1] - side_z / 2, 0, MAX_SIZE - side_z))
            return np.array([[zoom, 0, x0], [0, zoom, y0], [0, 0, 1.0]])

        s_a = crop_mat(p_a, 0.5)
        s_b = crop_mat(p_b, 0.0)
        a_crop = _warp_host(a.astype(np.float32), np.linalg.inv(s_a),
                            (MAX_SIZE, MAX_SIZE)).astype(np.uint8)
        return a_crop, np.linalg.inv(s_b) @ h_mat @ s_a

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 1_000_003 + index)
        img = self.images[rng.randint(len(self.images))]
        h, w = img.shape[:2]

        # square crop resized to 256 = image A (the side is capped: resizing
        # megapixel crops would dominate synthesis time)
        side = rng.randint(MAX_SIZE, min(h, w, self.max_crop_side) + 1)
        y0 = rng.randint(0, h - side + 1)
        x0 = rng.randint(0, w - side + 1)
        crop = img[y0:y0 + side, x0:x0 + side]
        a = resize_pil_u8_host(crop, (MAX_SIZE, MAX_SIZE))
        if self.tex_aug:
            # before the warp: both frames see the same recolored texture,
            # so the supervision's geometry is unchanged
            perm = rng.permutation(3)
            a = a[:, :, perm]
            if rng.uniform() < 0.5:
                a = a[:, ::-1]
            if rng.uniform() < 0.5:
                a = a[::-1]
            a = np.ascontiguousarray(a)

        # random perspective: jitter the corners, warp A into B
        s = MAX_SIZE - 1.0
        corners = np.array([[0.0, 0], [s, 0], [s, s], [0, s]])
        jitter = rng.uniform(-self.max_corner_jitter, self.max_corner_jitter,
                             (4, 2)) * s
        h_mat = homography_from_4pts(corners, corners + jitter)
        if self.rot_deg or self.scale_range:
            # rotation and scale about the canvas center, composed into the
            # pair homography: pts_b = M H pts_a
            theta = (np.deg2rad(rng.uniform(-self.rot_deg, self.rot_deg))
                     if self.rot_deg else 0.0)
            sc = 1.0
            if self.scale_range:
                lo, hi = self.scale_range
                sc = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            c, sn = np.cos(theta) * sc, np.sin(theta) * sc
            ctr = s / 2.0
            m = np.array([[c, -sn, ctr - c * ctr + sn * ctr],
                          [sn, c, ctr - sn * ctr - c * ctr],
                          [0.0, 0.0, 1.0]])
            h_mat = m @ h_mat
        if self.zoom and rng.uniform() < self.zoom_prob:
            a, h_mat = self._zoom_crop(a, h_mat, rng)
        photo = None
        if self.photo_jitter:
            j = self.photo_jitter
            photo = np.stack([
                np.concatenate([rng.uniform(1 - j, 1 + j, 3),
                                rng.uniform(-0.5 * j, 0.5 * j, 1)]),
                np.concatenate([rng.uniform(1 - j, 1 + j, 3),
                                rng.uniform(-0.5 * j, 0.5 * j, 1)]),
            ]).astype(np.float32)  # (2, 4): per-side [gain_rgb, bias]
        if not self.device_warp:
            b = _warp_host(a.astype(np.float32), h_mat,
                           (MAX_SIZE, MAX_SIZE)).astype(np.uint8)
            if photo is not None:
                a = _apply_photo_host(a, photo[0])
                b = _apply_photo_host(b, photo[1])

        # grid correspondences that stay inside both frames
        n_side = int(np.ceil(np.sqrt(self.num_kp * 3)))
        lin = np.linspace(8, MAX_SIZE - 9, n_side)
        gx, gy = np.meshgrid(lin, lin)
        pts_a = np.stack([gx.ravel(), gy.ravel()], axis=1)
        pts_a += rng.uniform(-3, 3, pts_a.shape)
        pts_a = np.clip(pts_a, 0, MAX_SIZE - 1.001)
        pts_b = apply_homography(h_mat, pts_a)
        ok = ((pts_b >= 0.0) & (pts_b <= MAX_SIZE - 1.001)).all(axis=1)
        corrs = np.concatenate([pts_a[ok], pts_b[ok]], axis=1)
        if corrs.shape[0] < 8:
            return self.__getitem__((index + 1) % len(self))
        corrs = _trim_corrs(corrs, self.num_kp, rng)
        if not self.device_warp:
            return _package(a, b, corrs, self.bidirectional, rng,
                            raw_uint8=self.raw_uint8)

        # the flip augmentation folded into the homography: flipping both
        # frames maps B = warp(A, H) to flip(B) = warp(flip(A), F H F)
        corrs = corrs.astype(np.float64).copy()
        if rng.uniform() < 0.5:
            s = MAX_SIZE - 1.0
            flip = np.array([[-1.0, 0, s], [0, 1, 0], [0, 0, 1]])
            h_mat = flip @ h_mat @ flip
            a = np.ascontiguousarray(a[:, ::-1])
            corrs[:, 0] = s - corrs[:, 0]
            corrs[:, 2] = s - corrs[:, 2]
        corrs[:, 2] += MAX_SIZE
        corrs /= np.array([MAX_SIZE * 2, MAX_SIZE, MAX_SIZE * 2, MAX_SIZE])
        out = {"crop": a.astype(np.uint8),
               "h_mat": h_mat.astype(np.float32),
               "corrs": corrs.astype(np.float32)}
        if photo is not None:
            out["photo"] = photo
        if self.bidirectional:
            out["queries"] = np.concatenate(
                [corrs[:, :2], corrs[:, 2:]], axis=0).astype(np.float32)
            out["targets"] = np.concatenate(
                [corrs[:, 2:], corrs[:, :2]], axis=0).astype(np.float32)
        else:
            out["queries"] = corrs[:, :2].astype(np.float32)
            out["targets"] = corrs[:, 2:].astype(np.float32)
        return out
