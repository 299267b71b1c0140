#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build the attention kernel (csrc/attention.cu, nvcc, sm_90a) into build/;
3. the kernel vs its plain version on the card at the main path's shapes,
   float32 and bfloat16, with times beside the plain version's, one
   ``F.scaled_dot_product_attention`` call's (a yardstick only; the port
   never calls it) and the card's bound;
4. the flagship model at full width (6+6 layers, float32) forward on the
   card vs the same port on the CPU (plain attention, same weights and
   inputs);
5. serving: three generated image pairs (image B a known homography of
   image A, one pair non-square) through ``SparseEngine(mode="tile")`` and
   ``cotr_corr_multiscale_with_cycle_consistency`` as in the README's quick
   start, with the kernel's launch count read around the phase;
6. one JSON line describing each kernel, then the device line last.

It imports nothing of JAX or the JAX package. Without a card, or without
the repository around it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "checkpoints", "flagship.npz")
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# kernel vs plain on the card. float32: both sides compute exact fp32
# products, only the summation order differs. bfloat16: probabilities and
# outputs round to bf16 (ulp 2**-8 near 1).
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# flagship forward, card vs CPU, float32 without TF32: conv and matmul
# algorithms sum in other orders through 53 ResNet convs and 12 transformer
# layers; outputs are canvas coordinates in [0, 1]
FORWARD_TOL = 1e-3

# (B, Lq) of each attention on the main path (S = 512 keys, 8 heads of 32)
SHAPES = [("encoder self-attention", 2, 512),
          ("dense decode chunk", 4, 8192),
          ("refinement decode", 256, 1),
          ("ragged query tile", 2, 600)]


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, lq, s, h, hd, dtype) -> tuple:
    """Least time for the attention's work on this card: each input read
    once and the output written once, against 4*B*H*Lq*S*hd operations
    (the two products) at the dtype's peak."""
    item = torch.finfo(getattr(torch, dtype)).bits // 8
    nbytes = item * (2 * b * lq * h * hd + 2 * b * s * h * hd)
    flops = 4.0 * b * h * lq * s * hd
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------ test images

def _upsample(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear upsample of an (h0, w0, C) array to (h, w, C), numpy only."""
    h0, w0 = img.shape[:2]
    ys = np.clip((np.arange(h) + 0.5) * h0 / h - 0.5, 0, h0 - 1)
    xs = np.clip((np.arange(w) + 0.5) * w0 / w - 0.5, 0, w0 - 1)
    y0 = np.minimum(ys.astype(int), h0 - 2)
    x0 = np.minimum(xs.astype(int), w0 - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x0 + 1] * fx
    bot = img[y0 + 1][:, x0] * (1 - fx) + img[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def procedural_texture(rng, h: int, w: int) -> np.ndarray:
    """Multi-octave noise with quantized contours (the idea of
    cotr_tpu/data/synthetic.py's procedural textures), uint8 RGB."""
    acc = np.zeros((h, w, 3))
    amp = total = 0.0
    amp = 1.0
    for cells in (4, 8, 16, 32, 64):
        acc += amp * _upsample(rng.rand(cells, cells, 3), h, w)
        total += amp
        amp *= 0.6
    acc /= total
    lo, hi = acc.min(axis=(0, 1)), acc.max(axis=(0, 1))
    acc = (acc - lo) / np.maximum(hi - lo, 1e-6)
    acc = np.floor(acc * 6) / 5
    mix = rng.uniform(-0.3, 0.3, (3, 3)) + np.eye(3)
    return (np.clip(acc @ mix.T, 0, 1) * 255).astype(np.uint8)


def warp_homography(img: np.ndarray, hmat: np.ndarray) -> np.ndarray:
    """Image B with B(H x) = A(x): inverse-map every B pixel, bilinear,
    edge-clamped."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5, np.ones(h * w)])
    src = np.linalg.inv(hmat) @ pts
    sx = np.clip(src[0] / src[2] - 0.5, 0, w - 1.001)
    sy = np.clip(src[1] / src[2] - 0.5, 0, h - 1.001)
    x0, y0 = sx.astype(int), sy.astype(int)
    fx, fy = (sx - x0)[:, None], (sy - y0)[:, None]
    f = img.astype(np.float64)
    top = f[y0, x0] * (1 - fx) + f[y0, x0 + 1] * fx
    bot = f[y0 + 1, x0] * (1 - fx) + f[y0 + 1, x0 + 1] * fx
    out = (top * (1 - fy) + bot * fy).reshape(h, w, -1)
    return np.round(out).astype(np.uint8)


def known_homography(h: int, w: int, angle_deg: float, scale: float,
                     shift) -> np.ndarray:
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


# ----------------------------------------------------------------- phases

def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(line)
    return line


def phase_build(attention) -> float:
    t0 = time.perf_counter()
    path = attention.build_library()
    attention._library()
    seconds = time.perf_counter() - t0
    log(f"[build] {os.path.relpath(path, ROOT)} in {seconds:.1f} s")
    return seconds


def phase_kernel(attention) -> list:
    rows = []
    h, hd, s = 8, 32, 512
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for label, b, lq in SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(b * 131 + lq)
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(td)
                       for shape in ((b, lq, h, hd), (b, s, h, hd),
                                     (b, s, h, hd)))
            got = attention.flash_cross_attention(q, k, v)
            torch.cuda.synchronize()
            want = attention.flash_cross_attention_plain(q, k, v)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= KERNEL_TOL[dtype]:
                raise AssertionError(
                    f"kernel vs plain at {label} {dtype}: max abs err {err} "
                    f"> {KERNEL_TOL[dtype]}")
            iters = 20 if b * lq >= 4096 else 100
            ms = time_ms(lambda: attention.flash_cross_attention(q, k, v),
                         iters)
            plain_ms = time_ms(
                lambda: attention.flash_cross_attention_plain(q, k, v), iters)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
            bound_ms, bound_by = attention_bound_ms(b, lq, s, h, hd, dtype)
            rows.append(dict(shape=label, b=b, lq=lq, s=s, h=h, hd=hd,
                             dtype=dtype, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
            log(f"[kernel] {label:24s} B={b:<4d} Lq={lq:<5d} {dtype:8s} "
                f"err {err:.2e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
                f"  sdpa {library_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by})")
    return rows


def phase_forward(load_model, cfg_cls) -> dict:
    rng = np.random.RandomState(0)
    imgs = [procedural_texture(rng, 256, 256) for _ in range(4)]
    mean = np.array([0.485, 0.456, 0.406])
    std = np.array([0.229, 0.224, 0.225])
    canvas = np.stack([np.concatenate([imgs[0], imgs[1]], axis=1),
                       np.concatenate([imgs[2], imgs[3]], axis=1)])
    canvas = ((canvas / 255.0 - mean) / std).astype(np.float32)
    queries = rng.uniform(0.02, 0.98, (2, 64, 2)).astype(np.float32)
    cfg = cfg_cls()
    outs = {}
    for device in ("cuda", "cpu"):
        model = load_model(FLAGSHIP, cfg, device=device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            c = torch.from_numpy(canvas).to(device)
            mem = model.encode(c)
            out = model.decode(mem, torch.from_numpy(queries).to(device))
        outs[device] = (out.cpu().numpy(), mem.cpu().numpy())
        log(f"[forward] {device}: {time.perf_counter() - t0:.2f} s")
        del model
    out_err = float(np.abs(outs["cuda"][0] - outs["cpu"][0]).max())
    mem_err = float(np.abs(outs["cuda"][1] - outs["cpu"][1]).max())
    log(f"[forward] flagship 6+6 float32, card vs CPU: out max abs err "
        f"{out_err:.2e} (tol {FORWARD_TOL}), memory max abs err "
        f"{mem_err:.2e}")
    if not np.isfinite(outs["cuda"][0]).all() or not out_err <= FORWARD_TOL:
        raise AssertionError(f"flagship forward disagrees: {out_err}")
    return dict(out_max_abs_err=out_err, memory_max_abs_err=mem_err)


def phase_serve(attention, engine_cls, runner_cls, load_model,
                cfg_cls) -> tuple:
    rng = np.random.RandomState(1)
    pairs = []
    for (h, w), angle, scale, shift in [((768, 1024), 4.0, 1.05, (20, -12)),
                                        ((512, 512), -3.0, 0.97, (-10, 8)),
                                        ((480, 640), 2.0, 1.0, (16, 10))]:
        img_a = procedural_texture(rng, h, w)
        hmat = known_homography(h, w, angle, scale, shift)
        pairs.append((img_a, warp_homography(img_a, hmat), hmat))
    runner = runner_cls(load_model(FLAGSHIP, cfg_cls(), device="cuda"),
                        device="cuda")
    engine = engine_cls(runner, mode="tile")
    zooms = list(np.linspace(0.5, 0.0625, 4))
    torch.cuda.synchronize()
    attention.launches = 0
    t0 = time.perf_counter()
    results = [engine.cotr_corr_multiscale_with_cycle_consistency(
        a, b, zoom_ins=zooms, max_corrs=100) for a, b, _ in pairs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = attention.launches
    summary = []
    for (img_a, img_b, hmat), corrs in zip(pairs, results):
        ha, wa = img_a.shape[:2]
        hb, wb = img_b.shape[:2]
        if corrs.shape[0] < 1 or corrs.shape[1] != 4:
            raise AssertionError(f"pair {ha}x{wa}: {corrs.shape}")
        if not np.isfinite(corrs).all():
            raise AssertionError(f"pair {ha}x{wa}: non-finite output")
        inside = ((corrs[:, 0] >= 0) & (corrs[:, 0] < wa)
                  & (corrs[:, 1] >= 0) & (corrs[:, 1] < ha)
                  & (corrs[:, 2] >= 0) & (corrs[:, 2] < wb)
                  & (corrs[:, 3] >= 0) & (corrs[:, 3] < hb))
        if not inside.all():
            raise AssertionError(f"pair {ha}x{wa}: correspondences out of "
                                 f"frame")
        err = np.linalg.norm(apply_h(hmat, corrs[:, :2]) - corrs[:, 2:],
                             axis=1)
        summary.append(dict(shape=[ha, wa], n=int(corrs.shape[0]),
                            median_px=float(np.median(err)),
                            within_5px=float(np.mean(err <= 5.0))))
        log(f"[serve] pair {ha}x{wa}: {corrs.shape[0]} correspondences, "
            f"median error vs the known homography "
            f"{np.median(err):.2f} px, {np.mean(err <= 5.0):.0%} within 5 px")
    log(f"[serve] 3 pairs in {wall:.2f} s wall, attention kernel launches "
        f"{launches}")
    if launches < 1:
        raise AssertionError("the serving path launched no attention kernel")
    return wall, launches, summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.inference.engine import SparseEngine
    from cotr_tpu_torch.inference.runner import ModelRunner
    from cotr_tpu_torch.models.checkpoint_io import load_model
    from cotr_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = phase_card()
    build_s = phase_build(attention)
    rows = phase_kernel(attention)
    forward = phase_forward(load_model, COTRConfig)
    wall, launches, serve = phase_serve(attention, SparseEngine, ModelRunner,
                                        load_model, COTRConfig)

    main_row = next(r for r in rows if r["shape"] == "dense decode chunk"
                    and r["dtype"] == "float32")
    kernels = [dict(
        name="flash_cross_attention", route="cuda",
        source="cotr_tpu_torch/csrc/attention.cu",
        replaces="cotr_tpu/ops/pallas_attention.py:70",
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows
                        if r["dtype"] == "float32"),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
        timed_at="B=4 Lq=8192 S=512 H=8 hd=32 float32",
        shapes=rows)]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, build_s=build_s, forward=forward,
                       serve_wall_s=wall, serve=serve, kernels=kernels), f,
                  indent=1)
    log(f"[serve] wall {wall:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
