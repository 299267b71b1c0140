"""Generated inputs: procedural textures, their warps by known homographies,
keypoints and training batches, made from the seed on the device.

The arithmetic is that of ``chip_smoke.py``'s generators (multi-octave noise
with quantized contours; B(H x) = A(x) by inverse map, bilinear,
edge-clamped, rounded to uint8), done here in float64 with torch so that a
pool is made on the card in set-up. Every draw comes from a
``numpy.random.Generator`` seeded with (seed, stream, index), so one seed
gives one pool, whatever the device, and the sizes never depend on it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def call_order(seed: int, calls: int) -> np.ndarray:
    """The order in which a pool's ``calls`` go out, drawn from ``seed``."""
    return rng_for(seed, 6).permutation(int(calls))


def _upsample(cells: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear upsample of an (h0, w0, C) float64 array to (h, w, C),
    pixel centres aligned."""
    h0, w0 = cells.shape[:2]
    dev = cells.device
    ys = ((torch.arange(h, dtype=torch.float64, device=dev) + 0.5) * h0 / h
          - 0.5).clamp(0, h0 - 1)
    xs = ((torch.arange(w, dtype=torch.float64, device=dev) + 0.5) * w0 / w
          - 0.5).clamp(0, w0 - 1)
    y0 = ys.long().clamp(max=h0 - 2)
    x0 = xs.long().clamp(max=w0 - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    top = cells[y0][:, x0] * (1 - fx) + cells[y0][:, x0 + 1] * fx
    bot = cells[y0 + 1][:, x0] * (1 - fx) + cells[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def procedural_texture(rng: np.random.Generator, h: int, w: int,
                       device="cpu") -> torch.Tensor:
    """uint8 (h, w, 3) texture: five octaves of noise, contrast-stretched,
    quantized to six levels a channel, then a random colour mix."""
    acc = torch.zeros((h, w, 3), dtype=torch.float64, device=device)
    amp, total = 1.0, 0.0
    for cells in (4, 8, 16, 32, 64):
        grid = torch.from_numpy(rng.random((cells, cells, 3))).to(device)
        acc += amp * _upsample(grid, h, w)
        total += amp
        amp *= 0.6
    acc /= total
    lo = acc.amin(dim=(0, 1))
    hi = acc.amax(dim=(0, 1))
    acc = (acc - lo) / (hi - lo).clamp(min=1e-6)
    acc = torch.floor(acc * 6) / 5
    mix = torch.from_numpy(rng.uniform(-0.3, 0.3, (3, 3)) + np.eye(3)) \
        .to(device)
    return (torch.clamp(acc @ mix.T, 0, 1) * 255).to(torch.uint8)


def known_homography(h: int, w: int, angle_deg: float, scale: float,
                     shift: Sequence[float]) -> np.ndarray:
    """Rotation by ``angle_deg`` and scaling about the centre, then a
    shift: (3, 3) float64 mapping A pixels to B pixels."""
    cx, cy = w / 2, h / 2
    a = np.deg2rad(angle_deg)
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]]) * np.array([scale, scale, 1])[:, None]
    to_c = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]])
    back = np.array([[1, 0, cx + shift[0]], [0, 1, cy + shift[1]],
                     [0, 0, 1]])
    return back @ rot @ to_c


def apply_h(hmat: np.ndarray, xy: np.ndarray) -> np.ndarray:
    p = hmat @ np.concatenate([xy, np.ones((len(xy), 1))], axis=1).T
    return (p[:2] / p[2]).T


def warp_homography(img: torch.Tensor, hmat: np.ndarray) -> torch.Tensor:
    """Image B with B(H x) = A(x): every B pixel centre inverse-mapped,
    bilinear, edge-clamped, rounded to uint8."""
    h, w = img.shape[:2]
    dev = img.device
    inv = torch.from_numpy(np.linalg.inv(hmat)).to(dev)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                            torch.arange(w, dtype=torch.float64, device=dev),
                            indexing="ij")
    pts = torch.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5,
                       torch.ones(h * w, dtype=torch.float64, device=dev)])
    src = inv @ pts
    sx = (src[0] / src[2] - 0.5).clamp(0, w - 1.001)
    sy = (src[1] / src[2] - 0.5).clamp(0, h - 1.001)
    x0, y0 = sx.long(), sy.long()
    fx, fy = (sx - x0)[:, None], (sy - y0)[:, None]
    f = img.double()
    top = f[y0, x0] * (1 - fx) + f[y0, x0 + 1] * fx
    bot = f[y0 + 1, x0] * (1 - fx) + f[y0 + 1, x0 + 1] * fx
    out = (top * (1 - fy) + bot * fy).reshape(h, w, -1)
    return torch.round(out).to(torch.uint8)


class Pair:
    """One generated pair: uint8 images on the device and on the host, the
    homography, the keypoint queries in A and their true images in B."""

    def __init__(self, img_a, img_b, hmat, queries):
        self.dev_a, self.dev_b = img_a, img_b
        self.img_a = img_a.cpu().numpy()
        self.img_b = img_b.cpu().numpy()
        self.hmat = hmat
        self.queries = queries
        self.truth = apply_h(hmat, queries)


def make_pair(seed: int, index: int, hw: Sequence[int], traffic: dict,
              device) -> Pair:
    """Pair ``index`` of the pool of ``seed``: texture, homography (angle,
    scale and shift drawn within the traffic's ranges) and ``queries``
    keypoints inside ``margin`` px of A's border."""
    h, w = hw
    rng = rng_for(seed, 1, index)
    img_a = procedural_texture(rng, h, w, device)
    amax = float(traffic["angle_deg"])
    lo, hi = traffic["scale"]
    smax = float(traffic["shift_px"])
    hmat = known_homography(h, w, rng.uniform(-amax, amax),
                            rng.uniform(lo, hi), rng.uniform(-smax, smax, 2))
    n = int(traffic["queries"])
    m = float(traffic["margin"])
    queries = np.stack([rng.uniform(m, w - m, n), rng.uniform(m, h - m, n)],
                       1).astype(np.float32).astype(np.float64)
    return Pair(img_a, warp_homography(img_a, hmat), hmat, queries)


def make_train_batch(seed: int, index: int, traffic: dict, device) -> dict:
    """Batch ``index``: ``batch`` generated 256-square crops, a known
    homography each (angle, scale and shift within the traffic's ranges),
    ``num_kp`` correspondences that stay inside both frames, normalized to
    the canvas (x of the B side plus 256, then x over 512 and y over 256),
    both directions stacked: the synthetic recipe's crop layout. Every
    tensor is on ``device``."""
    size = 256
    n, kp = int(traffic["batch"]), int(traffic["num_kp"])
    rng = rng_for(seed, 2, index)
    amax = float(traffic["angle_deg"])
    lo, hi = traffic["scale"]
    smax = float(traffic["shift_px"])
    crops, h_mats, queries, targets = [], [], [], []
    while len(crops) < n:
        hmat = known_homography(size, size, rng.uniform(-amax, amax),
                                rng.uniform(lo, hi),
                                rng.uniform(-smax, smax, 2))
        pts_a = rng.uniform(8, size - 9, (6 * kp, 2))
        pts_b = apply_h(hmat, pts_a)
        ok = ((pts_b >= 0.0) & (pts_b <= size - 1.001)).all(axis=1)
        if ok.sum() < kp:
            continue
        corrs = np.concatenate([pts_a[ok][:kp], pts_b[ok][:kp]], 1)
        corrs[:, 2] += size
        corrs /= np.array([2 * size, size, 2 * size, size])
        crops.append(procedural_texture(rng, size, size, device))
        h_mats.append(hmat)
        queries.append(np.concatenate([corrs[:, :2], corrs[:, 2:]]))
        targets.append(np.concatenate([corrs[:, 2:], corrs[:, :2]]))

    def dev(a):
        return torch.from_numpy(np.stack(a).astype(np.float32)).to(device)

    return dict(crop=torch.stack(crops), h_mat=dev(h_mats),
                queries=dev(queries), targets=dev(targets))
