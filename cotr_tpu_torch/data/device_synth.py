"""MegaDepth supervision synthesized on the device, inside the train step
(counterpart of cotr_tpu/data/device_synth.py).

The host path (``data.dataset.compute_corrs``) reprojects every valid pixel
of a neighbour's depth for every sample. Here the host only packs a sample:

* host (``emit_device_sample``, numpy): the uint8 canvas, ``cand_factor *
  num_kp`` random depth > 0 candidate pixels of the neighbour with their
  depth, the query depth quantized to log-uint16 (the occlusion reference)
  and the camera matrices;
* device (``synth_supervision_batch``, torch, batched): unproject the
  candidates with the neighbour camera, project into the query camera with
  ``pcd_3d_to_pcd_2d``'s filters (z > 0, 0 <= x < w - 1, 0 <= y < h - 1),
  check occlusion against the dequantized query depth (|z_q - z_proj| <
  0.5), select ``num_kp`` at random among the valid candidates, flip,
  normalize to canvas coordinates and double both ways. Fixed (B, C)
  shapes, ``topk`` and ``gather``: nothing reads a value on the host.

Where the host path re-draws a sample with too few correspondences, fixed
shapes cannot: invalid picks carry weight 0 and the loss divides by the
weights' sum (``training.loss.cotr_loss(weights=...)``).

The selection scores: the JAX package draws them from a threefry key per
sample (the sample's ``skey``), which torch cannot reproduce. Here they come
from the ``torch.Generator`` given, or are passed in as ``scores``; the
parity tests pass both packages the same scores.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cotr_tpu_torch.utils.constants import MAX_SIZE


# --------------------------------------------------------- depth quantization

def quantize_depth(depth: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(h, w) float depth -> (log1p-uint16 map, scale): relative error about
    1.4e-4 at the largest depth, 2 bytes a pixel to upload."""
    d = np.maximum(depth.astype(np.float64), 0.0)
    scale = float(np.log1p(d.max())) or 1.0
    q = np.round(np.log1p(d) / scale * 65535.0).astype(np.uint16)
    return q, np.float32(scale)


def dequantize_depth(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The depth of a quantized map (any integer dtype holding 0..65535);
    ``scale`` broadcasts against ``q``."""
    return torch.expm1(q.to(torch.float32) / 65535.0 * scale)


# -------------------------------------------------------------- host emitter

def emit_device_sample(query_cap, nn_cap, num_kp: int,
                       rng: np.random.RandomState,
                       cand_factor: int = 6) -> Dict[str, np.ndarray]:
    """Pack one (query, neighbour) capture pair for synthesis on the device.
    The captures' images must be MAX_SIZE squares (the stage 1/2
    ``crop_center_and_resize`` layout). Draws from ``rng`` as the JAX
    package does."""
    q_img, n_img = query_cap.image, nn_cap.image
    if not q_img.shape[:2] == n_img.shape[:2] == (MAX_SIZE, MAX_SIZE):
        raise ValueError(f"device synthesis takes {MAX_SIZE}-square "
                         f"captures, got {q_img.shape} and {n_img.shape}")
    canvas = np.concatenate([q_img, n_img], axis=1)
    if canvas.dtype != np.uint8:
        canvas = np.clip(canvas, 0, 255).astype(np.uint8)

    depth_nn = nn_cap.depth_map
    ys, xs = np.where(depth_nn > 0)
    c = cand_factor * num_kp
    cand = np.zeros((c, 3), np.float32)  # z = 0 pads are invalid downstream
    if ys.shape[0]:
        sel = rng.choice(ys.shape[0], min(c, ys.shape[0]), replace=False)
        cand[:sel.shape[0], 0] = xs[sel]
        cand[:sel.shape[0], 1] = ys[sel]
        cand[:sel.shape[0], 2] = depth_nn[ys[sel], xs[sel]]

    qdepth, qscale = quantize_depth(query_cap.depth_map)
    proj_q = (query_cap.pinhole_cam.intrinsic_mat
              @ query_cap.cam_pose.world_to_camera[0:3, :])
    return {
        "image": canvas,
        "cand": cand,
        "qdepth": qdepth,
        "qscale": qscale,
        "kinv_nn": np.linalg.inv(
            nn_cap.pinhole_cam.intrinsic_mat).astype(np.float32),
        "c2w_nn": nn_cap.cam_pose.camera_to_world[0:3, :].astype(np.float32),
        "proj_q": proj_q.astype(np.float32),
        "flip": np.float32(rng.uniform() < 0.5),
        "skey": np.uint32(rng.randint(0, 2 ** 31 - 1)),
    }


# ------------------------------------------------------------- device side

def _affine(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3 or 4) matrices applied to (B, C, 3) points (the fourth
    column a translation)."""
    out = torch.einsum("bij,bcj->bci", m[:, :, :3], pts)
    return out + m[:, None, :, 3] if m.shape[2] == 4 else out


def project_candidates(batch: Dict[str, torch.Tensor]):
    """Every candidate of every sample, in the query camera: (uv (B, C, 2)
    pixel coordinates, z_proj (B, C) its depth there, zd (B, C) the
    dequantized query depth under it, valid (B, C) bool)."""
    cand = batch["cand"]
    xy, z = cand[..., :2], cand[..., 2]
    pix = torch.cat([xy, torch.ones_like(z)[..., None]], dim=-1)
    cam_pts = _affine(batch["kinv_nn"], pix) * z[..., None]
    world = _affine(batch["c2w_nn"], cam_pts)
    uvw = _affine(batch["proj_q"], world)
    z_proj = uvw[..., 2]
    uv = uvw[..., :2] / torch.where(z_proj == 0, torch.ones_like(z_proj),
                                    z_proj)[..., None]

    qdepth = batch["qdepth"]
    b, h, w = qdepth.shape
    u, v = uv[..., 0], uv[..., 1]
    # pcd_3d_to_pcd_2d's filter
    inside = (u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1)
    iu = torch.floor(u).clamp(0, w - 1).to(torch.int64)
    iv = torch.floor(v).clamp(0, h - 1).to(torch.int64)
    zq = torch.gather(qdepth.reshape(b, h * w), 1, iv * w + iu)
    zd = dequantize_depth(zq, batch["qscale"].to(torch.float32)[:, None])
    valid = (z > 0) & (z_proj > 0) & inside & ((zd - z_proj).abs() < 0.5)
    return uv, z_proj, zd, valid


def synth_corrs_batch(batch: Dict[str, torch.Tensor], num_kp: int,
                      scores: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, num_kp, 4) [x_q, y_q, x_nn, y_nn] pixel coordinates before the
    flip and (B, num_kp) validity weights: for each sample the num_kp
    candidates of lowest score, the valid ones first (an invalid one's
    score is raised by 1), in ascending order of score."""
    uv, _, _, valid = project_candidates(batch)
    score = scores + (1.0 - valid.to(scores.dtype))
    sel = torch.topk(score, num_kp, dim=1, largest=False, sorted=True).indices
    picked = torch.cat([uv, batch["cand"][..., :2]], dim=-1)
    corrs = torch.gather(picked, 1, sel[..., None].expand(-1, -1, 4))
    return corrs, torch.gather(valid, 1, sel).to(torch.float32)


def synth_supervision_batch(batch: Dict[str, torch.Tensor], num_kp: int,
                            bidirectional: bool = True,
                            scores: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None):
    """Batched supervision on the batch's device: (canvas uint8, flipped
    where the sample says, queries, targets, weights), queries and targets
    (B, Q, 2) in normalized canvas coordinates, Q = 2 * num_kp when
    ``bidirectional``.

    ``batch``: the stacked samples of :func:`emit_device_sample`, with
    ``qdepth`` widened to a signed integer type on upload (torch computes
    little in uint16). ``scores``: (B, C) in [0, 1), C the candidates a
    sample; drawn from ``generator`` (on the batch's device) when None."""
    cand = batch["cand"]
    if scores is None:
        scores = torch.rand(cand.shape[:2], generator=generator,
                            device=cand.device, dtype=cand.dtype)
    corrs, wgt = synth_corrs_batch(batch, num_kp, scores)
    return _finish(batch, corrs, wgt, bidirectional)


def _finish(batch, corrs, wgt, bidirectional):
    canvas = batch["image"]
    flip = batch["flip"] > 0.5  # (B,)
    s = MAX_SIZE - 1.0

    # the flip augmentation: each canvas half mirrored, x coordinates too
    flipped = torch.cat([canvas[:, :, :MAX_SIZE].flip(2),
                         canvas[:, :, MAX_SIZE:].flip(2)], dim=2)
    canvas = torch.where(flip[:, None, None, None], flipped, canvas)
    fx = flip[:, None].to(corrs.dtype)
    x_q = (1 - fx) * corrs[..., 0] + fx * (s - corrs[..., 0])
    x_n = (1 - fx) * corrs[..., 2] + fx * (s - corrs[..., 2])

    # canvas coordinates: the query in the left half, the neighbour right
    q_n = torch.stack([x_q / (2 * MAX_SIZE), corrs[..., 1] / MAX_SIZE], -1)
    n_n = torch.stack([(x_n + MAX_SIZE) / (2 * MAX_SIZE),
                       corrs[..., 3] / MAX_SIZE], -1)
    if bidirectional:
        queries = torch.cat([q_n, n_n], dim=1)
        targets = torch.cat([n_n, q_n], dim=1)
        weights = torch.cat([wgt, wgt], dim=1)
    else:
        queries, targets, weights = q_n, n_n, wgt
    return canvas, queries, targets, weights
