"""Canvas construction: side-by-side composition, ImageNet normalization
and the device-side homography warp of the synthetic training batches
(counterpart of cotr_tpu/ops/canvas.py), on tensors, on the input's device.
Nothing here makes the host wait for the device."""

from __future__ import annotations

from typing import Optional

import torch

from cotr_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD
from cotr_tpu_torch.utils.device import constant


def two_images_side_by_side(img_a: torch.Tensor,
                            img_b: torch.Tensor) -> torch.Tensor:
    """Concatenate two equal-shaped (..., H, W, C) images along width."""
    if img_a.shape != img_b.shape:
        raise ValueError(f"{tuple(img_a.shape)} vs {tuple(img_b.shape)}")
    return torch.cat([img_a, img_b], dim=-2)


def normalize_canvas(canvas: torch.Tensor) -> torch.Tensor:
    """uint8 or float (N)HWC canvas -> ImageNet-normalized float32 (uint8 is
    scaled by 1/255 first, as torchvision's to_tensor does)."""
    x = canvas.float()
    if canvas.dtype == torch.uint8:
        x = x / 255.0
    mean = constant(IMAGENET_MEAN, torch.float32, x.device)
    std = constant(IMAGENET_STD, torch.float32, x.device)
    return (x - mean) / std


def _inverse_3x3(m: torch.Tensor) -> torch.Tensor:
    """Inverse of (B, 3, 3) matrices by the adjugate, in float64 and returned
    in float32. ``torch.linalg.inv`` would read its error code on the host
    once a call; this is elementwise."""
    m = m.double()
    r0, r1, r2 = m[:, 0], m[:, 1], m[:, 2]
    adj = torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                       torch.linalg.cross(r0, r1)], dim=2)
    det = (r0 * adj[:, :, 0]).sum(dim=1)
    return (adj / det[:, None, None]).float()


def warp_homography_batch(images: torch.Tensor,
                          h_mats: torch.Tensor) -> torch.Tensor:
    """Inverse-warp a batch of images through per-image homographies
    (bilinear, border-clamped). images (B, H, W, C) float; h_mats (B, 3, 3)
    mapping source to destination pixels."""
    b, h, w, c = images.shape
    dev = images.device
    inv = _inverse_3x3(h_mats)
    xs = torch.arange(w, device=dev, dtype=torch.float32).repeat(h)
    ys = torch.arange(h, device=dev,
                      dtype=torch.float32).repeat_interleave(w)

    def row(i):  # (B, H*W), summed elementwise: no TF32 product in the way
        return (inv[:, i, 0:1] * xs + inv[:, i, 1:2] * ys) + inv[:, i, 2:3]

    depth = row(2)
    sx = (row(0) / depth).clamp(0.0, w - 1.0)
    sy = (row(1) / depth).clamp(0.0, h - 1.0)
    x0 = sx.long().clamp(max=w - 2)
    y0 = sy.long().clamp(max=h - 2)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    flat = images.reshape(b, h * w, c)
    bidx = torch.arange(b, device=dev)[:, None]
    i00 = flat[bidx, y0 * w + x0]
    i01 = flat[bidx, y0 * w + x0 + 1]
    i10 = flat[bidx, (y0 + 1) * w + x0]
    i11 = flat[bidx, (y0 + 1) * w + x0 + 1]
    top = i00 + (i01 - i00) * fx
    bot = i10 + (i11 - i10) * fx
    return (top + (bot - top) * fy).reshape(b, h, w, c)


def canvas_from_crops_and_homographies(crops: torch.Tensor,
                                       h_mats: torch.Tensor,
                                       photo: Optional[torch.Tensor] = None
                                       ) -> torch.Tensor:
    """(B, 256, 256, 3) uint8 source crops + (B, 3, 3) homographies ->
    normalized (B, 256, 512, 3) training canvases on the crops' device: warp
    the B side, join side by side, ImageNet-normalize.

    ``photo`` (B, 2, 4), optional per-side photometric jitter [gain_rgb,
    bias], applied to the A and B frames independently: the geometry, and
    so the supervision, is unchanged."""
    a = crops.float() / 255.0
    b_img = warp_homography_batch(a, h_mats)
    if photo is not None:
        def jitter(img, gain_bias):  # (B, 4)
            gain = gain_bias[:, None, None, :3]
            return (img * gain + gain_bias[:, None, None, 3:4]).clamp(0.0,
                                                                      1.0)
        a = jitter(a, photo[:, 0])
        b_img = jitter(b_img, photo[:, 1])
    return normalize_canvas(torch.cat([a, b_img], dim=2))


def denormalize_canvas(canvas: torch.Tensor) -> torch.Tensor:
    mean = constant(IMAGENET_MEAN, torch.float32, canvas.device)
    std = constant(IMAGENET_STD, torch.float32, canvas.device)
    return canvas * std + mean


def make_canvas_batch(crops_a: torch.Tensor,
                      crops_b: torch.Tensor) -> torch.Tensor:
    """(N, 256, 256, 3) x2 -> normalized (N, 256, 512, 3) canvas batch."""
    return normalize_canvas(torch.cat([crops_a, crops_b], dim=2))
