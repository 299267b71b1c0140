"""What the demos share (counterpart of demos/demo_utils.py): their common
flags, the engine they build, reading images and writing pictures.

Pictures are PNG files written with ``zlib`` and ``struct``, the
correspondence lines and points drawn in numpy: the card's machine has
neither matplotlib nor PIL. Images are read with
``geometry.capture.read_image``: a ``.npy`` uint8 (H, W, 3) array anywhere,
an image file where imageio is installed.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np

from cotr_tpu_torch.data.synthetic import SAMPLE_IMAGES_DIR
from cotr_tpu_torch.geometry.capture import read_image

#: the reference's sample data, where the JAX demos' default inputs live
SAMPLE_DIR = os.path.dirname(SAMPLE_IMAGES_DIR)

#: the committed flagship weights: the demos default to them when present
FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "checkpoints", "flagship.npz")

#: the demos' zoom schedule
ZOOM_INS = list(np.linspace(0.5, 0.0625, 4))


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--load_weights_path",
                    default=FLAGSHIP if os.path.exists(FLAGSHIP) else None,
                    help="torch .pth(.tar), .npz release or Trainer .pt to "
                         "load (default: the committed flagship weights "
                         "when present; pass 'none' for random init)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--max_corrs", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--faster_infer", default="no", choices=["yes", "no"])
    ap.add_argument("--safe_area", type=float, default=0.5,
                    help="grouped-engine membership window fraction "
                         "(0.5 = exact reference semantics; larger = more "
                         "grouping, slightly lower edge accuracy)")
    ap.add_argument("--out", default=None, help="output image path")


def build_engine(args, mode: str = "tile", device="cuda"):
    """``SparseEngine`` or, with ``--faster_infer yes``,
    ``FasterSparseEngine`` over the weights of ``--load_weights_path`` (any
    layout ``load_params`` reads) on ``device``; 'none' or no path draws
    fresh weights from a generator seeded with 0."""
    import torch

    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.inference.engine import (FasterSparseEngine,
                                                 SparseEngine)
    from cotr_tpu_torch.inference.runner import ModelRunner
    from cotr_tpu_torch.models.checkpoint_io import load_model
    from cotr_tpu_torch.models.cotr import build_model, init_weights

    cfg = COTRConfig(dtype=args.dtype)
    path = args.load_weights_path
    if path and path.lower() != "none":
        model = load_model(path, cfg, device=device)
        print(f"loaded weights from {path}")
    else:
        model = build_model(cfg)
        init_weights(model, torch.Generator().manual_seed(0))
        print("WARNING: no weights given; using random initialization")
    runner = ModelRunner(model, device=device)
    if args.faster_infer == "yes":
        return FasterSparseEngine(runner, batch_size=args.batch_size,
                                  mode=mode,
                                  safe_area=getattr(args, "safe_area", 0.5))
    return SparseEngine(runner, batch_size=args.batch_size, mode=mode)


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB; an absent file raises FileNotFoundError."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no image at {path}")
    return read_image(path)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, text=None) -> None:
    """An (H, W) grey or (H, W, 3) RGB uint8 array as an 8-bit PNG, every
    row unfiltered; ``text`` ({keyword: value}, Latin-1) adds one ``tEXt``
    chunk for each entry."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes uint8 (H, W) or (H, W, 3), got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                0, 0, 0)))
        for key, value in (text or {}).items():
            f.write(_png_chunk(b"tEXt", key.encode("latin-1") + b"\0"
                               + value.encode("latin-1")))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: channels of each 8-bit PNG colour type: grey, RGB, grey + alpha, RGBA
PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def read_png_chunks(path: str) -> list:
    """[(kind, data)] of the PNG file at ``path``, CRCs checked."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    chunks, pos = [], len(PNG_SIGNATURE)
    while pos < len(raw):
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        body = raw[pos + 4:pos + 8 + n]
        (crc,) = struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in a {body[:4]!r} chunk")
        chunks.append((body[:4], body[4:]))
        pos += 12 + n
    return chunks


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced grey, grey + alpha, RGB or RGBA PNG as
    uint8 (H, W) or (H, W, C), the channels PIL decodes for it. Rows may
    use any of the five filter types; they are undone along the image's
    anti-diagonals, each pixel after its left, upper and upper-left
    neighbours."""
    chunks = read_png_chunks(path)
    kind, header = chunks[0]
    if kind != b"IHDR":
        raise ValueError(f"{path}: the first chunk is {kind!r}, not IHDR")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", header)
    if depth != 8 or color not in PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}; read_png takes 8-bit grey, "
                         "grey + alpha, RGB or RGBA without interlace")
    bpp = PNG_CHANNELS[color]
    data = np.frombuffer(zlib.decompress(b"".join(
        d for k, d in chunks if k == b"IDAT")), np.uint8)
    data = data.reshape(h, 1 + w * bpp)
    ftype = data[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {ftype.max()}")
    filtered = data[:, 1:].reshape(h, w, bpp).astype(np.int32)
    # zero row above and zero column left: a, b and c of the first row and
    # column
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        xs = d - ys
        a = out[ys + 1, xs]
        b = out[ys, xs + 1]
        c = out[ys, xs]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.choose(ftype[ys][:, None], [np.zeros_like(a), a, b,
                                              (a + b) // 2, paeth])
        out[ys + 1, xs + 1] = (filtered[ys, xs] + pred) & 255
    img = out[1:, 1:].astype(np.uint8)
    return img[..., 0] if bpp == 1 else img


def to_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 grey, grey + alpha, RGB or RGBA -> (H, W, 3), as PIL's
    ``convert("RGB")`` does (alpha dropped, not composited)."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


LINE_RGB = np.array([0, 255, 0], np.uint8)
POINT_RGB = np.array([255, 0, 0], np.uint8)


def draw_correspondences(img_a: np.ndarray, img_b: np.ndarray,
                         corrs: np.ndarray, lines: bool = True
                         ) -> np.ndarray:
    """A and B side by side, each correspondence a line from its point in A
    to its point in B, blended at 0.7, and both endpoints as 3 x 3 points.
    Returns (max(h_a, h_b), w_a + w_b, 3) uint8."""
    h = max(img_a.shape[0], img_b.shape[0])
    w = img_a.shape[1] + img_b.shape[1]
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[:img_a.shape[0], :img_a.shape[1]] = img_a
    canvas[:img_b.shape[0], img_a.shape[1]:] = img_b
    if not (lines and len(corrs)):
        return canvas
    ends = np.asarray(corrs, np.float64).reshape(-1, 2, 2) \
        + np.array([[0.0, 0.0], [img_a.shape[1], 0.0]])
    steps = int(np.ceil(np.abs(ends[:, 1] - ends[:, 0]).max())) + 1
    t = np.linspace(0.0, 1.0, max(steps, 2))[None, :, None]
    pts = np.rint(ends[:, None, 0] + t * (ends[:, None, 1] - ends[:, None, 0])
                  ).reshape(-1, 2).astype(np.int64)
    ok = ((pts >= 0) & (pts < [w, h])).all(axis=1)
    ys, xs = pts[ok, 1], pts[ok, 0]
    blended = np.rint(0.3 * canvas[ys, xs] + 0.7 * LINE_RGB)
    canvas[ys, xs] = blended.astype(np.uint8)
    centres = np.rint(ends.reshape(-1, 2)).astype(np.int64)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            p = centres + [dx, dy]
            ok = ((p >= 0) & (p < [w, h])).all(axis=1)
            canvas[p[ok, 1], p[ok, 0]] = POINT_RGB
    return canvas


def save_corr_visualization(img_a, img_b, corrs, out_path, lines=True):
    """The pair side by side with its correspondences, as a PNG."""
    write_png(out_path, draw_correspondences(img_a, img_b, corrs, lines))
    print(f"wrote {out_path}")
