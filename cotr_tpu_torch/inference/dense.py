"""Dense flow: full-grid decode, cycle-consistency confidence, patch tiling
(counterpart of cotr_tpu/inference/dense.py).

* one canvas encode, then the (256/s, 512/s) query grid decoded in chunks;
* cycle confidence samples the predicted flow field through itself;
* patch tiling (:func:`to_square_patches`) is host numpy before the
  device passes; the patch-to-frame affines (closed form), PIL's field
  resize and the min-confidence merge run on the device after them, where
  the JAX package ran them on the host with PIL and numpy, and each call's
  merged fields come back in one copy per frame shape
  (:func:`merge_flow_patches` stays as the host form of the merge);
* :func:`dense_pass` is one such pass over one square pair, and
  :func:`warp_by_flow` resamples an image through a field.
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
from cotr_tpu_torch.utils.device import resolve_device


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


def dense_pass(runner: ModelRunner, img_a_sq: np.ndarray,
               img_b_sq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Two square uint8 or float images -> (corr_a, corr_b), each
    (256, 256, 3) numpy: per-pixel [-1, 1] target coordinates in the
    *other* image and the cycle confidence. One canvas, one full-grid pass
    on the runner's device."""
    canvas = _canvases_for_jobs(runner, [(img_a_sq, img_b_sq)])
    corr = dense_pass_device(runner, canvas)[0].cpu().numpy()
    return corr[:, :MAX_SIZE], corr[:, MAX_SIZE:]


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


def _job_affines(jobs, device) -> torch.Tensor:
    """(J, 2, 2, 2) float64 on ``device``: for each job (pair, p_i, p_j)
    and side (a, then b), the scale and shift of :func:`_patch_affine` of
    the patch that side predicts into (p_j for a, p_i for b). One upload,
    made before the device passes are queued, so it waits for none of
    them."""
    aff = np.array([[_patch_affine(p_j), _patch_affine(p_i)]
                    for _, p_i, p_j in jobs])
    return torch.from_numpy(aff).to(device)


def _merge_on_device(fields: List[Tuple[ImagePatch, torch.Tensor]]
                     ) -> torch.Tensor:
    """:func:`merge_flow_patches` of one side on the fields' device, to the
    bit: (patch, (h, w, 3) field) in job order -> the (oh, ow, 3) frame.
    The frame starts at confidence 100 and flow 0; each patch takes its
    window where its confidence is strictly lower, so ties keep the earlier
    patch and a NaN confidence never wins. One patch covering the frame is
    the frame, as it is there."""
    p0, f0 = fields[0]
    if len(fields) == 1 and (p0.x, p0.y, p0.w, p0.h) == (0, 0, p0.ow, p0.oh):
        return f0
    frame = f0.new_zeros((p0.oh, p0.ow, 3))
    frame[..., 2] = 100.0
    for p, f in fields:
        win = frame[p.y:p.y + p.h, p.x:p.x + p.w]
        win.copy_(torch.where(f[..., 2:] < win[..., 2:], f, win))
    return frame


@torch.inference_mode()
def _frames_on_device(corr_all: torch.Tensor, jobs, affines: torch.Tensor,
                      n_pairs: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every job's two patch-local fields (``corr_all``, (J, h, 2h, 3)) to
    the frames of their images, on their device: predictions mapped to the
    other image's global [-1, 1] by the patch affine (float64 arithmetic,
    stored in float32), PIL's resize of each field to its patch's size (one
    field at a time, as the host path resized them), then the
    min-confidence merge of each pair's side. Returns (frame_a, frame_b)
    per pair; nothing is copied to the host and ``corr_all`` is not
    written."""
    half = corr_all.shape[2] // 2
    # side a's columns take side a's affine, side b's columns side b's
    scale, shift = (affines[:, :, i].repeat_interleave(half, dim=1)[:, None]
                    for i in (0, 1))
    mapped = torch.cat([(corr_all[..., :2].double() * scale + shift).float(),
                        corr_all[..., 2:]], dim=-1)
    sides = [([], []) for _ in range(n_pairs)]
    for k, (pi, p_i, p_j) in enumerate(jobs):
        for side, p in enumerate((p_i, p_j)):
            field = mapped[k, :, side * half:(side + 1) * half]
            sides[pi][side].append((p, resize_pil(field, (p.h, p.w))))
    return [(_merge_on_device(a), _merge_on_device(b)) for a, b in sides]


def _copy_to_host(t: torch.Tensor) -> torch.Tensor:
    """Start ``t``'s copy to the host without waiting for it: into a pinned
    buffer from the card; a CPU tensor is already there."""
    if t.device.type == "cpu":
        return t
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=True).copy_(t, non_blocking=True)


def _fetch_fields(frames) -> List[Tuple]:
    """Per pair (frame_a, frame_b), (h, w, 3) float32 on the device -> per
    pair (corr_a, con_a, corr_b, con_b), float64 numpy of shapes (h, w, 2)
    and (h, w). The frames of one shape are cast to float64 on the device
    and laid out as [flow | confidence] per frame, so each returned array is
    a contiguous view of one host buffer; one copy per frame shape, and one
    wait for all of them."""
    groups = {}
    for pi, pair in enumerate(frames):
        for side, f in enumerate(pair):
            groups.setdefault(tuple(f.shape[:2]), []).append((pi, side))
    copies = []
    for (h, w), members in groups.items():
        stack = torch.stack([frames[pi][side] for pi, side in members])
        flat = torch.cat([stack[..., :2].reshape(len(members), -1),
                          stack[..., 2].reshape(len(members), -1)], dim=1)
        copies.append((h, w, members, _copy_to_host(flat.double())))
    device = frames[0][0].device
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    out = [[None] * 4 for _ in frames]
    for h, w, members, host in copies:
        for row, (pi, side) in zip(host.numpy(), members):
            out[pi][2 * side] = row[:2 * h * w].reshape(h, w, 2)
            out[pi][2 * side + 1] = row[2 * h * w:].reshape(h, w)
    return [tuple(o) for o in out]


def dense_flow_many(runner: ModelRunner, pairs, canvas_batch: int = 8,
                    seed_stride: int = 1) -> List[Tuple]:
    """Dense flow over many image pairs: every patch-pair canvas of every
    pair joins one device batch (chunked to ``canvas_batch``); the affine
    mapping, field resize and min-confidence merge run on the device
    (:func:`_frames_on_device`), and the call's merged fields come to the
    host in one copy per frame shape (:func:`_fetch_fields`). Returns one
    (corr_a, con_a, corr_b, con_b) tuple of float64 arrays per pair."""
    if seed_stride < 1 or MAX_SIZE % seed_stride:
        raise ValueError(f"seed_stride must divide MAX_SIZE={MAX_SIZE}, "
                         f"got {seed_stride}")
    jobs = []  # (pair_index, p_i, p_j)
    for pi, (img_a, img_b) in enumerate(pairs):
        for p_i in to_square_patches(img_a):
            for p_j in to_square_patches(img_b):
                jobs.append((pi, p_i, p_j))
    affines = _job_affines(jobs, runner.device)

    outs = []
    for start in range(0, len(jobs), canvas_batch):
        chunk = jobs[start:start + canvas_batch]
        canvas = _canvases_for_jobs(
            runner, [(p_i.patch, p_j.patch) for _, p_i, p_j in chunk])
        outs.append(dense_pass_device(runner, canvas, seed_stride))
    frames = _frames_on_device(torch.cat(outs, dim=0), jobs, affines,
                               len(pairs))
    return _fetch_fields(frames)


def dense_flow(runner: ModelRunner, img_a: np.ndarray, img_b: np.ndarray):
    """Exhaustive patch-pair dense passes, merged into full-frame flow.

    Returns (corr_a, con_a, corr_b, con_b): corr_* are (H, W, 2) flows in
    the other image's [-1, 1] coords; con_* are (H, W) cycle errors."""
    return dense_flow_many(runner, [(img_a, img_b)], canvas_batch=4)[0]


def warp_by_flow(img_other, corr, device=None) -> np.ndarray:
    """Resample the other image (H', W', C) through a [-1, 1] flow field
    corr (H, W, 2 or more; channels past the second, such as
    :func:`dense_pass`'s confidence, are not read) with :func:`grid_sample`.
    Returns (H, W, C) float32 numpy.

    Tensors are resampled on their device; numpy inputs on ``device``, the
    card unless the caller asks for the CPU."""
    if device is None:
        device = next((t.device for t in (img_other, corr)
                       if torch.is_tensor(t)), "cuda")
    dev = resolve_device(device)
    img, grid = (x if torch.is_tensor(x) else
                 torch.from_numpy(np.ascontiguousarray(x))
                 for x in (img_other, corr))
    return grid_sample(img.to(dev, torch.float32),
                       grid[..., :2].to(dev, torch.float32)).cpu().numpy()
