"""Sinusoidal positional encodings (counterpart of cotr_tpu/models/position.py).

* query embedding: NeRF-style sine expansion of normalized (x, y) query
  points with linear bases i = 1..depth (``lin_sine``) or 2**i
  (``exp_sine``);
* image positional map: pixel-center coordinates of the unpadded feature grid
  run through the same expansion, precomputed on the host.

Channel order is load-bearing for the weights: sines first, then cosines,
and within each the per-base blocks keep the coordinate order
[sin(1·pi·x), sin(1·pi·y), sin(2·pi·x), sin(2·pi·y), ...].
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def sine_bases(depth: int, sine_type: str) -> np.ndarray:
    if sine_type == "lin_sine":
        return np.arange(1, depth + 1, dtype=np.float64)
    if sine_type == "exp_sine":
        return 2.0 ** np.arange(depth, dtype=np.float64)
    raise ValueError(f"unknown sine_type: {sine_type}")


def nerf_positional_encoding(coords: torch.Tensor, depth: int,
                             sine_type: str = "lin_sine") -> torch.Tensor:
    """Expand (..., D) coordinates to (..., 2 * depth * D)."""
    bases = torch.as_tensor(sine_bases(depth, sine_type), dtype=coords.dtype,
                            device=coords.device)
    # angle[..., b, d] = base_b * pi * coord_d
    ang = coords[..., None, :] * (bases[:, None] * math.pi)
    flat = (*coords.shape[:-1], depth * coords.shape[-1])
    return torch.cat([torch.sin(ang).reshape(flat),
                      torch.cos(ang).reshape(flat)], dim=-1)


@functools.lru_cache(maxsize=8)
def image_position_embedding(h: int, w: int, hidden_dim: int = 256,
                             sine_type: str = "lin_sine") -> np.ndarray:
    """Positional map for an unpadded (h, w) feature grid -> (h, w,
    hidden_dim) float32: pixel centers y = (i + 0.5) / (h + 1e-6),
    x = (j + 0.5) / (w + 1e-6), sine-expanded with depth hidden_dim // 4."""
    eps = 1e-6
    ys = (np.arange(h, dtype=np.float64) + 0.5) / (h + eps)
    xs = (np.arange(w, dtype=np.float64) + 0.5) / (w + eps)
    grid_x, grid_y = np.meshgrid(xs, ys)
    coords = np.stack([grid_x, grid_y], axis=-1)  # (h, w, 2)
    depth = hidden_dim // 4
    bases = sine_bases(depth, sine_type)
    ang = coords[..., None, :] * (bases[:, None] * np.pi)  # (h, w, depth, 2)
    pos = np.concatenate([np.sin(ang).reshape(h, w, depth * 2),
                          np.cos(ang).reshape(h, w, depth * 2)], axis=-1)
    pos = pos.astype(np.float32)
    pos.setflags(write=False)  # shared by every caller through the cache
    return pos
