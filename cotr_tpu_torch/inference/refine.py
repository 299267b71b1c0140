"""Batched recursive-zoom refinement (counterpart of
cotr_tpu/inference/refine.py), a fixed-depth loop over device tensors in
place of the JAX ``lax.scan``.

All tasks advance through the zoom schedule in lockstep; each step

  1. computes every task's source and target patch boxes;
  2. crops and resizes them with PIL-exact triangle-filter matrix products;
  3. builds the (T, 256, 512, 3) canvas batch and runs ONE model forward;
  4. maps the predictions back into target-image pixels.

``converge_iters`` extra steps run at the final zoom with the exact
convergence rule: each task keeps the history of its final-zoom
predictions; on the first exact revisit the loop [first match .. previous]
is averaged and the task freezes, and tasks reaching the iteration cap
freeze on their last value. The returned history has one row per zoom
level, the last being the converged value.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from cotr_tpu_torch.ops.canvas import normalize_canvas
from cotr_tpu_torch.ops.sampling import crop_and_resize_matmul
from cotr_tpu_torch.utils.constants import MAX_SIZE


def patch_box(pos: torch.Tensor, scale, h, w
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Square crop of side 2*floor(short*clip(scale, 0, 1)/2) centered at
    ``pos`` (..., 2) float pixels, shifted to lie inside the (h, w) image.
    Returns float32 (x0, y0, size)."""
    short = torch.tensor(float(min(h, w)), dtype=torch.float32,
                         device=pos.device)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=pos.device)
    size = torch.floor(short * torch.clamp(scale, 0.0, 1.0) / 2.0) * 2.0
    half = torch.floor(size / 2.0)
    lu_x = torch.floor(pos[..., 0] - half)
    lu_y = torch.floor(pos[..., 1] - half)
    lu_x = torch.minimum(torch.clamp(lu_x, min=0.0), float(w) - size)
    lu_y = torch.minimum(torch.clamp(lu_y, min=0.0), float(h) - size)
    return lu_x, lu_y, size


def zoom_schedule(zoom_ins: Sequence[float], converge_iters: int
                  ) -> np.ndarray:
    """Per-step zoom values: each level once, the last level repeated
    ``converge_iters`` times in all."""
    zooms = list(zoom_ins) + [zoom_ins[-1]] * (converge_iters - 1)
    return np.asarray(zooms, dtype=np.float32)


@torch.inference_mode()
def refine_loop(forward, img_a: torch.Tensor, img_b: torch.Tensor,
                loc_from: torch.Tensor, loc_to0: torch.Tensor,
                s_from: float, s_to: float, zooms: np.ndarray,
                final_start: int, crop_dtype=torch.float32) -> torch.Tensor:
    """Refinement over ``zooms`` steps (``_refine_scan``).

    forward(canvas (T, 256, 512, 3), queries (T, 1, 2)) -> (T, 1, 2).
    img_a, img_b: (H, W, 3) float [0, 1] on the device. Returns the
    per-zoom-level history (final_start + 1, T, 2)."""
    dev = loc_from.device
    t = loc_from.shape[0]
    h_a, w_a = img_a.shape[:2]
    h_b, w_b = img_b.shape[:2]
    c_iters = len(zooms) - final_start
    s_from = torch.tensor(s_from, dtype=torch.float32, device=dev)
    s_to = torch.tensor(s_to, dtype=torch.float32, device=dev)

    loc_to = loc_to0
    frozen = torch.zeros(t, dtype=torch.bool, device=dev)
    hist = torch.full((c_iters, t, 2), float("inf"), device=dev)
    jidx = torch.arange(c_iters, device=dev)
    per_step = []
    for step_idx, zoom in enumerate(zooms):
        zoom = torch.tensor(zoom, dtype=torch.float32, device=dev)
        x0f, y0f, size_f0 = patch_box(loc_from, s_from * zoom, h_a, w_a)
        x0t, y0t, size_t0 = patch_box(loc_to, s_to * zoom, h_b, w_b)
        size_f = size_f0.expand_as(x0f)
        size_t = size_t0.expand_as(x0t)
        boxes_from = torch.stack([x0f, y0f, size_f, size_f], dim=-1)
        boxes_to = torch.stack([x0t, y0t, size_t, size_t], dim=-1)
        crops_a = crop_and_resize_matmul(img_a, boxes_from, MAX_SIZE,
                                         compute_dtype=crop_dtype)
        crops_b = crop_and_resize_matmul(img_b, boxes_to, MAX_SIZE,
                                         compute_dtype=crop_dtype)
        canvas = normalize_canvas(torch.cat([crops_a, crops_b], dim=2))
        del crops_a, crops_b

        # query: loc_from in the source patch's canvas coords
        qx = (loc_from[:, 0] - x0f) / (2.0 * size_f)
        qy = (loc_from[:, 1] - y0f) / size_f
        queries = torch.stack([qx, qy], dim=-1)[:, None, :]
        pred = forward(canvas, queries)[:, 0, :]
        del canvas

        # back into target-image pixels, with one rounding of a*b + c as in
        # the fused multiply-add XLA compiles these lines to (the product
        # of two float32 values is exact in float64)
        p, st = pred.double(), size_t.double()
        new_x = (p[:, 0] - 0.5) * 2.0 * st + x0t.double()
        new_y = p[:, 1] * st + y0t.double()
        new_loc = torch.stack([new_x, new_y], dim=-1).float()

        # final-zoom convergence: kf indexes the final-zoom iterations and
        # hist[j] holds the j-th final-zoom prediction
        at_final = step_idx >= final_start
        kf = step_idx - final_start
        valid_j = (jidx < kf)[:, None]  # (C, 1)
        # exact-equality revisit of an earlier final-zoom prediction
        eq = torch.all(hist == new_loc[None], dim=-1) & valid_j  # (C, T)
        has_loop = eq.any(dim=0)
        j_start = torch.argmax(eq.to(torch.int8), dim=0)  # first match
        loop_mask = (jidx[:, None] >= j_start[None, :]) & valid_j
        cnt = torch.clamp(loop_mask.sum(dim=0), min=1)
        loop_mean = (torch.where(loop_mask[..., None], hist,
                                 torch.zeros((), device=dev)).sum(dim=0)
                     / cnt[:, None].to(hist.dtype))
        converged_val = torch.where(has_loop[:, None], loop_mean, new_loc)
        freeze_now = (~frozen & at_final
                      & (has_loop | (kf == c_iters - 1)))
        out_loc = torch.where(
            frozen[:, None], loc_to,
            torch.where(freeze_now[:, None], converged_val, new_loc))
        write = (jidx[:, None] == kf) & (~frozen & at_final)[None, :]
        hist = torch.where(write[..., None], new_loc[None], hist)
        frozen = frozen | freeze_now
        loc_to = out_loc
        per_step.append(out_loc)
    # non-final levels emit one step each; the final level's entry is the
    # converged value
    return torch.stack(per_step[:final_start] + [loc_to], dim=0)


class BatchRefiner:
    """Runs the zoom refinement for a runner's model on its device."""

    def __init__(self, runner, crop_dtype=torch.float32):
        self.runner = runner
        self.crop_dtype = crop_dtype

    def prepare_image(self, img: np.ndarray) -> torch.Tensor:
        """uint8 or float HWC image -> [0, 1] float32 image on the device.
        uint8 moves as uint8 and converts on the device; a float image whose
        maximum exceeds 2 is taken as [0, 255]."""
        img = np.asarray(img)
        dev = torch.from_numpy(np.ascontiguousarray(img)).to(
            self.runner.device)
        if img.dtype == np.uint8:
            dev = dev.float() / 255.0
        else:
            dev = dev.float()
            if float(img.max()) > 2.0:
                dev = dev / 255.0
        return dev

    def refine(self, img_a: torch.Tensor, img_b: torch.Tensor,
               loc_from: np.ndarray, loc_to0: np.ndarray,
               s_from: float, s_to: float, zoom_ins: Sequence[float],
               converge_iters: int = 1) -> np.ndarray:
        """Run the full zoom schedule for T tasks; returns the per-zoom-level
        history (len(zoom_ins), T, 2) as numpy, the final row converged."""
        dev = self.runner.device
        history = refine_loop(
            self.runner.forward, img_a, img_b,
            torch.as_tensor(np.asarray(loc_from), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(np.asarray(loc_to0), dtype=torch.float32,
                            device=dev),
            s_from, s_to, zoom_schedule(zoom_ins, converge_iters),
            final_start=len(zoom_ins) - 1, crop_dtype=self.crop_dtype)
        return history.cpu().numpy()
