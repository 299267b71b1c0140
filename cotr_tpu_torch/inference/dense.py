"""Dense flow: full-grid decode, cycle-consistency confidence, patch tiling
(counterpart of cotr_tpu/inference/dense.py).

* one canvas encode, then the (256/s, 512/s) query grid decoded in chunks;
* cycle confidence samples the predicted flow field through itself;
* patch tiling (:func:`to_square_patches`) and min-confidence merging
  (:func:`merge_flow_patches`) are host numpy around the device passes; the
  patch-to-frame affines (closed form) and PIL's field resize run on the
  device, where the JAX package ran them on the host with PIL.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from cotr_tpu_torch.inference.runner import ModelRunner
from cotr_tpu_torch.ops.canvas import normalize_canvas
from cotr_tpu_torch.ops.sampling import (grid_sample, resize_bilinear,
                                         resize_pil)
from cotr_tpu_torch.utils.constants import MAX_SIZE


@dataclass
class ImagePatch:
    """Patch content (or None), (x, y) upper-left in the original frame,
    patch (w, h), original (ow, oh)."""

    patch: Optional[np.ndarray]
    x: int
    y: int
    w: int
    h: int
    ow: int
    oh: int


def to_square_patches(img: np.ndarray) -> List[ImagePatch]:
    """Cover a (possibly non-square) image with 1-2 max-square patches
    (aspect ratios beyond 2:1 are not supported, as in the reference)."""
    h, w = img.shape[:2]
    size = min(h, w)
    if h == w:
        return [ImagePatch(img[:size, :size], 0, 0, size, size, w, h)]
    if max(h, w) <= 2 * size:
        return [
            ImagePatch(img[:size, :size], 0, 0, size, size, w, h),
            ImagePatch(img[-size:, -size:], w - size, h - size, size, size,
                       w, h),
        ]
    raise NotImplementedError("aspect ratio > 2 not supported")


@functools.lru_cache(maxsize=4)
def full_grid_queries(h: int = MAX_SIZE, w: int = 2 * MAX_SIZE,
                      stride: int = 1) -> np.ndarray:
    """The dense query grid x = j/w, y = i/h -> (h*w, 2) float32. At
    ``stride`` > 1 each point sits at the CENTER of its stride-block, so the
    center-aligned host resizes of the coarse field carry no half-block
    shift."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    if stride > 1:
        xs = xs + (stride - 1) / (2 * stride)
        ys = ys + (stride - 1) / (2 * stride)
    grid = np.stack([xs / w, ys / h], axis=-1).reshape(-1, 2)
    grid = grid.astype(np.float32)
    grid.setflags(write=False)  # shared by every caller through the cache
    return grid


@torch.inference_mode()
def dense_pass_device(runner: ModelRunner, canvas: torch.Tensor,
                      stride: int = 1) -> torch.Tensor:
    """canvas (B, 256, 512, 3) normalized -> (B, 256/stride, 512/stride, 3)
    stacked [corr_x, corr_y, confidence]: per-query targets in the other
    half's [-1, 1] coords and the cycle error (``_make_fused_dense``).

    At stride s the field comes back at the subsampled resolution; the host
    consumers resize fields to the original image size anyway."""
    h, w = MAX_SIZE // stride, 2 * MAX_SIZE // stride
    b = canvas.shape[0]
    grid = torch.tensor(full_grid_queries(h, w, stride), device=runner.device)
    queries = grid[None].expand(b, -1, -1)
    memory = runner.encode(canvas)
    out = runner.decode_chunked(memory, queries)

    out_grid = out.reshape(b, h, w, 2) * 2 - 1
    in_grid = queries.reshape(b, h, w, 2) * 2 - 1
    # the flow sampled through itself
    cycle = grid_sample(out_grid, out_grid)
    confidence = torch.linalg.vector_norm(cycle - in_grid, dim=-1)
    # x into per-image [-1, 1]: left-half queries predict into the right
    # image and vice versa
    half = MAX_SIZE // stride
    corr_x = torch.cat([out_grid[:, :, :half, 0] * 2 - 1,
                        out_grid[:, :, half:, 0] * 2 + 1], dim=2)
    return torch.stack([corr_x, out_grid[..., 1], confidence], dim=-1)


def _canvases_for_jobs(runner: ModelRunner, jobs_imgs) -> torch.Tensor:
    """Normalized (N, 256, 512, 3) canvases on the runner's device for a
    list of (img_a_sq, img_b_sq) pairs. Images move to the device in their
    own dtype (uint8 stays uint8), one transfer per source shape, and are
    converted and resized there. A float image whose maximum exceeds 2 is
    taken as [0, 255], as in the JAX package."""
    imgs = [np.asarray(im) for pair in jobs_imgs for im in pair]
    groups = {}
    for i, im in enumerate(imgs):
        groups.setdefault((im.shape, im.dtype.str), []).append(i)
    halves = [None] * len(imgs)
    for idxs in groups.values():
        stack = torch.from_numpy(np.stack([imgs[i] for i in idxs])).to(
            runner.device)
        f = stack.float()
        if stack.dtype == torch.uint8:
            f = f / 255.0
        else:
            big = torch.tensor([float(imgs[i].max()) > 2.0 for i in idxs],
                               device=runner.device)
            f = torch.where(big[:, None, None, None], f / 255.0, f)
        out = resize_bilinear(f, (MAX_SIZE, MAX_SIZE))
        for j, i in enumerate(idxs):
            halves[i] = out[j]
    return normalize_canvas(torch.cat([torch.stack(halves[0::2]),
                                       torch.stack(halves[1::2])], dim=2))


def _patch_affine(p: ImagePatch) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form affine from patch-local [-1, 1] coords to global [-1, 1]
    coords of the original image (both rects are axis-aligned)."""
    sx, sy = p.w / p.ow, p.h / p.oh
    tx = 2 * p.x / p.ow - 1 + sx
    ty = 2 * p.y / p.oh - 1 + sy
    return np.array([sx, sy]), np.array([tx, ty])


def merge_flow_patches(corrs: List[ImagePatch]
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Min-confidence merge of per-patch flow fields into the full frame.
    Returns (flow, confidence, provenance)."""
    oh, ow = corrs[0].oh, corrs[0].ow
    if (len(corrs) == 1 and corrs[0].x == 0 and corrs[0].y == 0
            and corrs[0].w == ow and corrs[0].h == oh):
        c = corrs[0]
        return (c.patch[..., :2].astype(np.float64),
                c.patch[..., 2].astype(np.float64), np.zeros([oh, ow]))
    confidence = np.full([oh, ow], 100.0)
    flow = np.zeros([oh, ow, 2])
    cmap = np.full([oh, ow], -1.0)
    for i, c in enumerate(corrs):
        conf_i = np.full([oh, ow], 100.0)
        conf_i[c.y:c.y + c.h, c.x:c.x + c.w] = c.patch[..., 2]
        flow_i = np.zeros([oh, ow, 2])
        flow_i[c.y:c.y + c.h, c.x:c.x + c.w] = c.patch[..., :2]
        better = conf_i < confidence
        confidence[better] = conf_i[better]
        flow[better] = flow_i[better]
        cmap[better] = i
    return flow, confidence, cmap


def dense_flow_many(runner: ModelRunner, pairs, canvas_batch: int = 8,
                    seed_stride: int = 1) -> List[Tuple]:
    """Dense flow over many image pairs: every patch-pair canvas of every
    pair joins one device batch (chunked to ``canvas_batch``); the affine
    mapping, field resize and min-confidence merge stay per pair on the
    host. Returns one (corr_a, con_a, corr_b, con_b) tuple per pair."""
    if seed_stride < 1 or MAX_SIZE % seed_stride:
        raise ValueError(f"seed_stride must divide MAX_SIZE={MAX_SIZE}, "
                         f"got {seed_stride}")
    jobs = []  # (pair_index, p_i, p_j)
    for pi, (img_a, img_b) in enumerate(pairs):
        for p_i in to_square_patches(img_a):
            for p_j in to_square_patches(img_b):
                jobs.append((pi, p_i, p_j))

    outs = []
    for start in range(0, len(jobs), canvas_batch):
        chunk = jobs[start:start + canvas_batch]
        canvas = _canvases_for_jobs(
            runner, [(p_i.patch, p_j.patch) for _, p_i, p_j in chunk])
        outs.append(dense_pass_device(runner, canvas, seed_stride))
    corr_all = torch.cat(outs, dim=0)

    def to_frame(field, affine, p):
        # patch-local predictions -> global [-1, 1] of the other image
        # (float64 arithmetic, stored back in float32), then PIL's resize
        # to the patch size, on the device
        s, t = (torch.from_numpy(a).to(field.device) for a in affine)
        field = torch.cat([(field[..., :2].double() * s + t).float(),
                           field[..., 2:]], dim=-1)
        return resize_pil(field, (p.h, p.w)).cpu().numpy()

    per_pair_a: List[List[ImagePatch]] = [[] for _ in pairs]
    per_pair_b: List[List[ImagePatch]] = [[] for _ in pairs]
    half = MAX_SIZE // seed_stride
    for k, (pi, p_i, p_j) in enumerate(jobs):
        c_i = to_frame(corr_all[k, :, :half], _patch_affine(p_j), p_i)
        c_j = to_frame(corr_all[k, :, half:], _patch_affine(p_i), p_j)
        per_pair_a[pi].append(ImagePatch(c_i, p_i.x, p_i.y, p_i.w, p_i.h,
                                         p_i.ow, p_i.oh))
        per_pair_b[pi].append(ImagePatch(c_j, p_j.x, p_j.y, p_j.w, p_j.h,
                                         p_j.ow, p_j.oh))

    results = []
    for pi in range(len(pairs)):
        corr_a, con_a, _ = merge_flow_patches(per_pair_a[pi])
        corr_b, con_b, _ = merge_flow_patches(per_pair_b[pi])
        results.append((corr_a, con_a, corr_b, con_b))
    return results


def dense_flow(runner: ModelRunner, img_a: np.ndarray, img_b: np.ndarray):
    """Exhaustive patch-pair dense passes, merged into full-frame flow.

    Returns (corr_a, con_a, corr_b, con_b): corr_* are (H, W, 2) flows in
    the other image's [-1, 1] coords; con_* are (H, W) cycle errors."""
    return dense_flow_many(runner, [(img_a, img_b)], canvas_batch=4)[0]
