"""Bilinear sampling and crop-and-resize (counterpart of
cotr_tpu/ops/sampling.py), images in HWC layout.

* :func:`gather_bilinear`: bilinear samples at float pixel coordinates,
  each corner outside the image contributing zero (or read clamped).
* :func:`grid_sample`: torch semantics, ``align_corners=False``, zero
  padding; a normalized coordinate g in [-1, 1] maps to pixel
  ((g + 1) * size - 1) / 2.
* :func:`resize_bilinear`: the JAX package's ``jax.image.resize(method=
  "linear", antialias=True)``: a center-aligned triangle filter, widened on
  downscale.
* :func:`crop_and_resize_matmul`: PIL-exact anti-aliased crop-and-resize as
  two batched matrix products with per-box triangle-filter matrices
  (:func:`pil_axis_weights`).
* :func:`crop_and_resize_windowed` and
  :func:`crop_and_resize_window_indexed`: the same crop for the squad
  engine, which first gathers a small window around each box and so
  multiplies over the window instead of the whole image.
* :func:`resize_pil`: PIL's BILINEAR resize of a float field without PIL,
  on the field's device, where the JAX package calls PIL on the host.
* :func:`resize_pil_host`: the same of a host array; an 8-bit image goes
  to :func:`resize_pil_u8_host`, equal to PIL's output (its taps, fixed
  point and rounding).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def gather_bilinear(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    zero_outside: bool = True) -> torch.Tensor:
    """Sample image (H, W, C) at float pixel coordinates x, y (any shape),
    on the image's device. The gather reads clamped; with ``zero_outside``
    each of the four corners outside the image contributes zero (torch's
    ``grid_sample`` zero padding)."""
    h, w = image.shape[0], image.shape[1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = (x - x0)[..., None]
    ty = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()

    def corner(dx, dy):
        val = image[(y0i + dy).clamp(0, h - 1), (x0i + dx).clamp(0, w - 1)]
        if not zero_outside:
            return val
        xf, yf = x0 + dx, y0 + dy
        inside = (xf >= 0) & (xf <= w - 1) & (yf >= 0) & (yf <= h - 1)
        return val * inside[..., None]

    top = corner(0, 0) * (1 - tx) + corner(1, 0) * tx
    bot = corner(0, 1) * (1 - tx) + corner(1, 1) * tx
    return top * (1 - ty) + bot * ty


def grid_sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """image (H, W, C) with grid (..., 2), or image (B, H, W, C) with grid
    (B, ..., 2); grid holds normalized (x, y). Returns (..., C) or
    (B, ..., C)."""
    batched = image.dim() == 4
    if not batched:
        image, grid = image[None], grid[None]
    b = image.shape[0]
    lead = grid.shape[1:-1]
    g = grid.reshape(b, -1, 1, 2).to(image.dtype)
    out = F.grid_sample(image.permute(0, 3, 1, 2), g, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    out = out[..., 0].permute(0, 2, 1).reshape(b, *lead, image.shape[-1])
    return out if batched else out[0]


def resize_bilinear(image: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """(H, W, C) or (N, H, W, C) float image -> (out_h, out_w) with an
    anti-aliased triangle filter (matches jax.image.resize 'linear' with
    antialias=True)."""
    batched = image.dim() == 4
    x = (image if batched else image[None]).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                        align_corners=False, antialias=True)
    out = out.permute(0, 2, 3, 1)
    return out if batched else out[0]


def pil_axis_weights(starts: torch.Tensor, sizes: torch.Tensor,
                     in_extent: int, out_size: int) -> torch.Tensor:
    """Per-box separable PIL-BILINEAR interpolation matrices (G, out, in).

    PIL's triangle filter on a crop [start, start+size) resized to
    out_size: filter scale max(size/out, 1) (anti-aliasing on downscale),
    support clipped to the crop, weights renormalized over it. starts and
    sizes are integer-valued floats."""
    dev, dt = starts.device, starts.dtype
    scale = sizes / out_size  # (G,)
    filt = torch.clamp(scale, min=1.0)
    centers = (starts[:, None]
               + (torch.arange(out_size, dtype=dt, device=dev)[None] + 0.5)
               * scale[:, None])
    ys = torch.arange(in_extent, dtype=dt, device=dev)  # centers at y + 0.5
    d = torch.abs(ys[None, None, :] + 0.5 - centers[..., None]) \
        / filt[:, None, None]
    w = torch.clamp(1.0 - d, min=0.0)
    inbox = ((ys[None, :] >= starts[:, None])
             & (ys[None, :] <= starts[:, None] + sizes[:, None] - 1))
    w = w * inbox[:, None, :]
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)


@contextlib.contextmanager
def _exact_products(compute_dtype):
    """float32 crop products run without TF32 whatever the process-wide
    setting is (``load_model`` turns TF32 off for a float32 model, but the
    crops must not depend on who loaded what): the JAX package asks for
    ``Precision.HIGHEST`` here."""
    if compute_dtype != torch.float32:
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def crop_and_resize_matmul(image: torch.Tensor, boxes: torch.Tensor,
                           out_size: int,
                           compute_dtype=torch.float32) -> torch.Tensor:
    """PIL-exact anti-aliased crop-and-resize as two matrix products:
    out[g] = Wy[g] @ img @ Wx[g]^T per channel.

    image (H, W, C); boxes (G, 4) integer-valued (x0, y0, w, h) float32.
    Returns (G, out_size, out_size, C) float32."""
    h, w = image.shape[0], image.shape[1]
    wy = pil_axis_weights(boxes[:, 1], boxes[:, 3], h, out_size)  # (G,o,H)
    wx = pil_axis_weights(boxes[:, 0], boxes[:, 2], w, out_size)  # (G,o,W)
    img = image.to(compute_dtype)
    with _exact_products(compute_dtype):
        tmp = torch.einsum("giy,yxc->gixc", wy.to(compute_dtype), img)
        out = torch.einsum("gjx,gixc->gijc", wx.to(compute_dtype), tmp)
    return out.float()


def _host_boxes(boxes) -> np.ndarray:
    """(G, 4) boxes as a host float32 array: the windowed crops check the
    range and compute their gather indices on the host, where the engine
    builds the boxes, so no device value is waited for."""
    boxes = np.asarray(boxes, np.float32)
    if boxes.ndim != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes must be (G, 4), got {boxes.shape}")
    return boxes


def _check_inside(boxes: np.ndarray, h: int, w: int) -> None:
    if len(boxes) and not (
            (boxes[:, 0] >= 0).all() and (boxes[:, 1] >= 0).all()
            and (boxes[:, 0] + boxes[:, 2] <= w).all()
            and (boxes[:, 1] + boxes[:, 3] <= h).all()):
        raise ValueError(f"a crop box leaves the {h}x{w} image")


def _gather_windows(img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                    size: int, idx: torch.Tensor = None) -> torch.Tensor:
    """(G, size, size, C) windows with corners (x0, y0) (int64, on the
    image's device) out of an (H, W, C) image or, with ``idx``, out of image
    idx[g] of a (P, H, W, C) stack: one gather, no loop over G."""
    offs = torch.arange(size, device=img.device)
    ys = (y0[:, None] + offs)[:, :, None]  # (G, S, 1)
    xs = (x0[:, None] + offs)[:, None, :]  # (G, 1, S)
    if idx is None:
        return img[ys, xs]
    return img[idx[:, None, None], ys, xs]


def crop_and_resize_windowed(image: torch.Tensor, boxes, out_size: int,
                             patch: int,
                             compute_dtype=torch.float32) -> torch.Tensor:
    """PIL-exact crop-and-resize for boxes that share one patch size.

    Every box of one squad dispatch has the same side, so each patch is
    gathered first and resampled with one shared (out, patch) weight
    matrix: G*out*patch^2*C products in place of
    :func:`crop_and_resize_matmul`'s G*out*H*W*C. The filter's support is
    clipped to the crop in both, so the result is the same sum with its
    zero terms left out (within 1e-6 in float32 on [0, 1] images; the order
    of summation differs).

    image (H, W, C); boxes (G, 4) integer-valued (x0, y0, w, h) with
    w == h == patch, a host array. The JAX package's ``dynamic_slice`` silently moves a window that
    would leave the image back inside; here such a box raises ValueError.
    Returns (G, out_size, out_size, C) float32."""
    host = _host_boxes(boxes)
    h, w = image.shape[0], image.shape[1]
    if len(host) and not ((host[:, 2:] == patch).all()):
        raise ValueError(f"every box must be {patch} px square")
    _check_inside(host, h, w)
    dev = image.device
    corners = torch.from_numpy(host[:, :2].astype(np.int64)).to(dev)
    img = image.to(compute_dtype)
    wins = _gather_windows(img, corners[:, 0], corners[:, 1], patch)
    one = torch.tensor([float(patch)], device=dev)
    wgt = pil_axis_weights(torch.zeros_like(one), one, patch,
                           out_size)[0].to(compute_dtype)  # (out, S)
    with _exact_products(compute_dtype):
        tmp = torch.einsum("iy,gyxc->gixc", wgt, wins)
        out = torch.einsum("jx,gixc->gijc", wgt, tmp)
    return out.float()


def crop_and_resize_window_indexed(images: torch.Tensor, boxes, idx,
                                   out_size: int, window: int,
                                   compute_dtype=torch.float32
                                   ) -> torch.Tensor:
    """PIL-exact crop-and-resize from a STACK of images, with an image
    index and an integral size for every box, the sizes bounded by
    ``window``: the crop of the multi-pair squad engine, where squads of
    different image pairs share one dispatch.

    Each box gathers a (window, window) region of its own image, moved
    inside the image where the box sits near the far edge, and is resampled
    by per-box triangle-filter matrices clipped to the true box, as in
    :func:`crop_and_resize_matmul` (the window's other columns have weight
    zero).

    images (P, H, W, C); boxes (G, 4) integer-valued (x0, y0, w, h) with
    w, h <= window <= min(H, W); idx (G,) image index of each box; both
    host arrays. A box outside
    its image, a size above ``window`` or an index outside the stack raises
    ValueError. Returns (G, out_size, out_size, C) float32."""
    host = _host_boxes(boxes)
    idx = np.asarray(idx, np.int64)
    p, h, w = images.shape[0], images.shape[1], images.shape[2]
    if window > min(h, w):
        raise ValueError(f"window {window} exceeds the {h}x{w} images")
    if len(host) and (host[:, 2:] > window).any():
        raise ValueError(f"a crop box exceeds the {window}-px window")
    if idx.shape != (len(host),) or (len(idx) and not (
            (idx >= 0).all() and (idx < p).all())):
        raise ValueError(f"idx must be (G,) image indices below {p}")
    _check_inside(host, h, w)
    dev = images.device
    # window corner: moved so the window stays inside the image; the true
    # box then starts at (bx - wx0, by - wy0) within the window
    wx0 = np.clip(host[:, 0], 0.0, float(w - window))
    wy0 = np.clip(host[:, 1], 0.0, float(h - window))
    table = torch.from_numpy(np.stack(
        [wx0, wy0, host[:, 0] - wx0, host[:, 1] - wy0, host[:, 2],
         host[:, 3], idx.astype(np.float32)], axis=1)).to(dev)
    img = images.to(compute_dtype)
    wins = _gather_windows(img, table[:, 0].long(), table[:, 1].long(),
                           window, table[:, 6].long())
    wy = pil_axis_weights(table[:, 3], table[:, 5], window, out_size)
    wx = pil_axis_weights(table[:, 2], table[:, 4], window, out_size)
    with _exact_products(compute_dtype):
        tmp = torch.einsum("giy,gyxc->gixc", wy.to(compute_dtype), wins)
        out = torch.einsum("gjx,gixc->gijc", wx.to(compute_dtype), tmp)
    return out.float()


def _pil_axis_weights_full(in_size: int, out_size: int,
                           device) -> torch.Tensor:
    """(out, in) float64 PIL-BILINEAR weights over a whole axis."""
    scale = in_size / out_size
    filt = max(scale, 1.0)
    centers = (np.arange(out_size) + 0.5) * scale
    d = np.abs(np.arange(in_size)[None, :] + 0.5 - centers[:, None]) / filt
    w = np.maximum(0.0, 1.0 - d)
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-8)
    return torch.from_numpy(w).to(device)


def resize_pil(img: torch.Tensor, shape_hw: Tuple[int, int]) -> torch.Tensor:
    """PIL ``Image.resize(size, BILINEAR)`` of an (H, W) or (H, W, C) float
    tensor ('F' mode, per channel) on its own device, without PIL.

    PIL resamples horizontally, then vertically, each pass skipped when its
    extent is unchanged, and stores the intermediate in float32. Both passes
    are float64 matrix products over (C, H, W) planes. 8-bit images go
    through :func:`resize_pil_host`."""
    if img.dtype == torch.uint8:
        raise ValueError("resize_pil takes float fields; resize 8-bit images "
                         "with resize_pil_host")
    out_h, out_w = shape_hw
    in_h, in_w = img.shape[:2]
    x = img.double().reshape(in_h, in_w, -1).permute(2, 0, 1)
    if out_w != in_w:
        x = (x @ _pil_axis_weights_full(in_w, out_w, x.device).T
             ).float().double()
    if out_h != in_h:
        x = (_pil_axis_weights_full(in_h, out_h, x.device) @ x
             ).float().double()
    x = x.permute(1, 2, 0).reshape((out_h, out_w) + tuple(img.shape[2:]))
    return x.float()


def resize_pil_host(img: np.ndarray, shape_hw: Tuple[int, int]) -> np.ndarray:
    """PIL's BILINEAR resize of a host array: :func:`resize_pil_u8_host` for
    uint8, :func:`resize_pil` for a float field."""
    if img.dtype == np.uint8:
        return resize_pil_u8_host(img, shape_hw)
    return resize_pil(torch.from_numpy(np.ascontiguousarray(img)),
                      shape_hw).numpy()


#: PIL's fixed point for 8-bit images: 32 - 8 - 2 fraction bits
_PIL_PRECISION_BITS = 22


def _pil_u8_taps(in_size: int, out_size: int) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """PIL's BILINEAR taps for one axis of an 8-bit image, computed as
    Pillow's ``precompute_coeffs`` computes them: (out, k) input indices and
    (out, k) fixed-point weights, k = 2 * ceil(filter support) + 1. Taps
    past an output's window have weight 0 (their index is clamped)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support is 1
    k = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # (int) truncates toward zero, as astype does
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    count = np.minimum((center + support + 0.5).astype(np.int64),
                       in_size) - xmin
    j = np.arange(k)
    t = np.abs(((xmin[:, None] + j) - center[:, None] + 0.5)
               * (1.0 / filterscale))
    w = np.where((t < 1.0) & (j < count[:, None]), 1.0 - t, 0.0)
    total = np.zeros(out_size)
    for col in range(k):  # summed in PIL's order
        total = total + w[:, col]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0,
                                                     total)[:, None], w)
    weights = (0.5 + w * (1 << _PIL_PRECISION_BITS)).astype(np.int64)
    return np.minimum(xmin[:, None] + j, in_size - 1), weights


def resize_pil_u8_host(img: np.ndarray,
                       shape_hw: Tuple[int, int]) -> np.ndarray:
    """PIL ``Image.resize(size, BILINEAR)`` of an (H, W) or (H, W, C) uint8
    array, equal to PIL's output: its taps, its fixed-point weights and its
    rounding, horizontal pass first, each pass skipped when its extent is
    unchanged. Each output reads at most 2 * ceil(scale) + 1 inputs an axis,
    so the work grows with the output, not with (out, in) matrices as in
    :func:`resize_pil`. Runs on the host, without PIL."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_pil_u8_host takes uint8, got {img.dtype}")
    out_h, out_w = shape_hw
    # (C, H, W) int32: a sum of 8-bit values times weights that sum to
    # 2**22 stays below 2**31
    x = np.moveaxis(img.reshape(img.shape[0], img.shape[1], -1), -1, 0)
    x = np.ascontiguousarray(x).astype(np.int32)
    half = 1 << (_PIL_PRECISION_BITS - 1)
    if x.shape[2] != out_w:
        idx, weights = _pil_u8_taps(x.shape[2], out_w)
        acc = np.full(x.shape[:2] + (out_w,), half, np.int32)
        for col in range(idx.shape[1]):
            acc += x[:, :, idx[:, col]] * weights[:, col].astype(np.int32)
        x = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255)
    if x.shape[1] != out_h:
        idx, weights = _pil_u8_taps(x.shape[1], out_h)
        acc = np.full((x.shape[0], out_h, x.shape[2]), half, np.int32)
        for col in range(idx.shape[1]):
            acc += (x[:, idx[:, col], :]
                    * weights[:, col, None].astype(np.int32))
        x = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255)
    return np.moveaxis(x.astype(np.uint8), 0, -1).reshape(
        (out_h, out_w) + img.shape[2:])
