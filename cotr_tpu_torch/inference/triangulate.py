"""Sparse -> dense correspondence densification (the port's own copy of
cotr_tpu/inference/triangulate.py; numpy and scipy on the host, nothing on
the card).

Delaunay triangulation of the source points (scipy), then barycentric
interpolation of the target coordinates over every pixel of the source
image: vectorized point location and barycentric math, deterministic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def rasterize_barycentric(tri_pts: np.ndarray, tri_vals: np.ndarray,
                          simplices: np.ndarray, transform: np.ndarray,
                          out_hw: Tuple[int, int]) -> np.ndarray:
    """Interpolate per-vertex values over an (H, W) pixel grid.

    tri_pts: (N, 2) triangulation vertices in pixel units of the output grid;
    tri_vals: (N, C) per-vertex payload; simplices/transform: from
    scipy.spatial.Delaunay (point-location + barycentric affine maps).
    Pixels outside the hull get 0.
    """
    h, w = out_hw
    ys, xs = np.mgrid[0:h, 0:w]
    pix = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)

    # point location via the Delaunay structure the caller passes in
    simplex_of = _find_simplex(simplices, transform, pix)
    valid = simplex_of >= 0
    out = np.zeros((h * w, tri_vals.shape[1]))
    if valid.any():
        s = simplex_of[valid]
        t = transform[s]  # (M, 3, 2) affine to barycentric
        r = pix[valid] - t[:, 2]
        b = np.einsum("mij,mj->mi", t[:, :2], r)  # first two barycentric
        bary = np.concatenate([b, 1 - b.sum(axis=1, keepdims=True)], axis=1)
        vals = tri_vals[simplices[s]]  # (M, 3, C)
        out[valid] = np.einsum("mi,mic->mc", bary, vals)
    return out.reshape(h, w, -1)


def _find_simplex(simplices, transform, pix):
    """Wrapper so tests can exercise rasterization without a Delaunay object;
    real callers pass tri.simplices/tri.transform and we rebuild a locator
    from the barycentric transforms directly."""
    # barycentric point location: a point is inside simplex s iff all
    # coordinates >= 0; pick the first matching simplex. Vectorized over
    # chunks of simplices to bound memory.
    n_pix = pix.shape[0]
    found = np.full(n_pix, -1, np.int64)
    remaining = np.arange(n_pix)
    chunk = 512
    for s0 in range(0, len(simplices), chunk):
        if remaining.size == 0:
            break
        t = transform[s0:s0 + chunk]  # (S, 3, 2)
        r = pix[remaining][:, None, :] - t[None, :, 2]  # (R, S, 2)
        b = np.einsum("sij,rsj->rsi", t[:, :2], r)  # (R, S, 2)
        bary_ok = ((b >= -1e-9).all(axis=2) &
                   (b.sum(axis=2) <= 1 + 1e-9))  # (R, S)
        hit = bary_ok.any(axis=1)
        first = bary_ok[hit].argmax(axis=1) + s0
        found[remaining[hit]] = first
        remaining = remaining[~hit]
    return found


def triangulate_corr(corr: np.ndarray, from_shape, to_shape
                     ) -> Optional[np.ndarray]:
    """Densify sparse correspondences into a flow image.

    corr: (N, 4) [x_from, y_from, x_to, y_to] in pixels. Returns
    (from_h, from_w, 2) map of target pixel coordinates (0 outside the hull).
    """
    from scipy.spatial import Delaunay

    corr = np.asarray(corr, np.float64)
    from_shape = tuple(from_shape[:2])
    to_shape = tuple(to_shape[:2])
    norm = np.concatenate([np.asarray(from_shape)[::-1],
                           np.asarray(to_shape)[::-1]])
    c = corr / norm
    try:
        tri = Delaunay(c[:, :2])
    except Exception:
        return None

    # vertices in output pixel units; payload = normalized target coords
    pts_pix = c[:, :2] * np.asarray(from_shape)[::-1]
    vals = c[:, 2:]
    # use scipy's own C point-location for speed
    h, w = from_shape
    ys, xs = np.mgrid[0:h, 0:w]
    pix_norm = np.stack([(xs.ravel()) / w, (ys.ravel()) / h], axis=1)
    simplex_of = tri.find_simplex(pix_norm)
    valid = simplex_of >= 0
    out = np.zeros((h * w, 2))
    if valid.any():
        s = simplex_of[valid]
        t = tri.transform[s]
        r = pix_norm[valid] - t[:, 2]
        b = np.einsum("mij,mj->mi", t[:, :2], r)
        bary = np.concatenate([b, 1 - b.sum(axis=1, keepdims=True)], axis=1)
        out[valid] = np.einsum("mi,mic->mc", bary, vals[tri.simplices[s]])
    render = out.reshape(h, w, 2)
    return render * np.asarray(to_shape)[::-1]
