"""The crops, the seed canvases, the dense seed field and the training
canvas, written again in plain PyTorch from what they mean:

* a crop is PIL's BILINEAR resize of an integral box of the image to
  256 x 256: output pixel i centred at start + (i + 0.5) * size / 256, a
  triangle filter widened by size / 256 on a downscale, its support clipped
  to the box and renormalized;
* a seed canvas is each image cut into at most two max-squares (the first
  at the origin, the second against the far corner), each square resized
  to 256 with an antialiased center-aligned triangle filter, side by side,
  ImageNet-normalized; every square of A meets every square of B;
* the dense field of a canvas is the model's answer at every pixel of the
  (256, 512) grid (x = j / 512, y = i / 256; at a stride s, every s-th
  point at its block's centre), in the other image's [-1, 1]
  coordinates, with the cycle error: the field sampled through itself
  (bilinear, zero outside) against the query;
* a training canvas is a generated crop beside its warp by a known
  homography (inverse map of every pixel, bilinear, edge-clamped).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cotr_bench.reference.model import MAX_SIZE, normalize


def box_weights(start: float, size: int, out: int = MAX_SIZE,
                device=None) -> torch.Tensor:
    """(out, size) float64 weights over the box's own pixels."""
    scale = size / out
    filt = max(scale, 1.0)
    centers = start + (torch.arange(out, dtype=torch.float64,
                                    device=device) + 0.5) * scale
    pix = start + torch.arange(size, dtype=torch.float64, device=device) + 0.5
    w = torch.clamp(1.0 - (pix[None, :] - centers[:, None]).abs() / filt,
                    min=0.0)
    return w / w.sum(1, keepdim=True).clamp(min=1e-12)


def crop(image: torch.Tensor, box) -> torch.Tensor:
    """image (H, W, 3) float in [0, 1]; box (x0, y0, w, h) integral ->
    (256, 256, 3) float32."""
    x0, y0, bw, bh = (int(round(float(v))) for v in box)
    patch = image[y0:y0 + bh, x0:x0 + bw].double()
    if patch.shape[:2] != (bh, bw):
        raise ValueError(f"box {box} leaves the {tuple(image.shape)} image")
    wy = box_weights(y0, bh, device=image.device)
    wx = box_weights(x0, bw, device=image.device)
    out = torch.einsum("iy,yxc->ixc", wy, patch)
    return torch.einsum("jx,ixc->ijc", wx, out).float()


def square_patches(h: int, w: int) -> List[Tuple[int, int, int]]:
    """(x, y, size) of the max-squares covering an (h, w) image."""
    s = min(h, w)
    if h == w:
        return [(0, 0, s)]
    return [(0, 0, s), (w - s, h - s, s)]


def seed_canvases(img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
    """uint8 (H, W, 3) images on the device -> the normalized seed
    canvases of the pair, A's squares outer, B's inner."""
    def square(img, p):
        x, y, s = p
        sq = img[y:y + s, x:x + s].float().div(255.0).permute(2, 0, 1)
        sq = F.interpolate(sq[None], size=(MAX_SIZE, MAX_SIZE),
                           mode="bilinear", align_corners=False,
                           antialias=True)
        return sq[0].permute(1, 2, 0)

    out = []
    for pa in square_patches(*img_a.shape[:2]):
        for pb in square_patches(*img_b.shape[:2]):
            out.append(torch.cat([square(img_a, pa), square(img_b, pb)], 1))
    return normalize(torch.stack(out))


def grid_queries(device, stride: int = 1) -> torch.Tensor:
    """The (256/s, 512/s) grid of a canvas, each point at the centre of its
    s-block: x = (j + (s - 1) / 2s) / (512 / s), likewise y."""
    h, w = MAX_SIZE // stride, 2 * MAX_SIZE // stride
    off = (stride - 1) / (2 * stride)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64) + off,
                            torch.arange(w, dtype=torch.float64) + off,
                            indexing="ij")
    g = torch.stack([xs / w, ys / h], -1)
    return g.reshape(-1, 2).float().to(device)


def dense_field(model, canvas: torch.Tensor, stride: int = 1
                ) -> torch.Tensor:
    """(B, 256, 512, 3) normalized canvases -> (B, 256/s, 512/s, 3)
    fields: [x, y] in the other image's [-1, 1] coordinates and the cycle
    error, at every s-th pixel."""
    b = canvas.shape[0]
    h, w = MAX_SIZE // stride, 2 * MAX_SIZE // stride
    grid = grid_queries(canvas.device, stride)
    out = model(canvas, grid[None].expand(b, -1, -1))
    out_grid = out.reshape(b, h, w, 2) * 2 - 1
    in_grid = grid.reshape(1, h, w, 2) * 2 - 1
    cycle = F.grid_sample(out_grid.permute(0, 3, 1, 2), out_grid,
                          mode="bilinear", padding_mode="zeros",
                          align_corners=False).permute(0, 2, 3, 1)
    conf = torch.linalg.vector_norm(cycle - in_grid, dim=-1)
    x = torch.cat([out_grid[:, :, :w // 2, 0] * 2 - 1,
                   out_grid[:, :, w // 2:, 0] * 2 + 1], 2)
    return torch.stack([x, out_grid[..., 1], conf], -1)


def training_canvas(crops: torch.Tensor, h_mats: torch.Tensor
                    ) -> torch.Tensor:
    """uint8 (B, S, S, 3) crops and (B, 3, 3) homographies (source to
    destination pixels) -> normalized (B, S, 2S, 3): each crop beside its
    warp."""
    b, h, w, c = crops.shape
    a = crops.float() / 255.0
    inv = torch.from_numpy(np.linalg.inv(h_mats.double().cpu().numpy())) \
        .float().to(crops.device)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=crops.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=crops.device),
                            indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)

    def row(i):
        return (inv[:, i, 0:1] * xs + inv[:, i, 1:2] * ys) + inv[:, i, 2:3]

    depth = row(2)
    sx = (row(0) / depth).clamp(0.0, w - 1.0)
    sy = (row(1) / depth).clamp(0.0, h - 1.0)
    x0 = sx.floor().clamp(max=w - 2)
    y0 = sy.floor().clamp(max=h - 2)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = a.reshape(b, h * w, c)
    bi = torch.arange(b, device=crops.device)[:, None]

    def at(yy, xx):
        return flat[bi, yy * w + xx]

    top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx
    bot = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx
    warped = (top * (1 - fy) + bot * fy).reshape(b, h, w, c)
    return normalize(torch.cat([a, warped], 2))
