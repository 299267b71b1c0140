#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths, its demos and
its checkpoint and accuracy tools once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build, all at once, into build/: the attention kernels
   (csrc/attention.cu, nvcc, sm_90a), the squad formation
   (csrc/squads.cpp) and the MegaDepth data path's loops (csrc/depth.cpp),
   the last two with the host C++ compiler; the native squad formation
   must equal the numpy scan exactly on 10,000 generated tasks;
3. the kernels (the tile kernel and the row kernel behind one wrapper) vs
   their plain version on the card at the main paths' shapes,
   float32 and bfloat16, with times beside the plain version's, one
   ``F.scaled_dot_product_attention`` call's (a yardstick only; the port
   never calls it) and the card's bound;
4. the squad engine's two windowed crops vs the full-image crop on the
   card;
5. the flagship model at full width (6+6 layers, float32) forward on the
   card vs the same port on the CPU (plain attention, same weights and
   inputs);
6. serving, scan engine: three generated image pairs (image B a known
   homography of image A, one pair non-square) through
   ``SparseEngine(mode="tile")`` and
   ``cotr_corr_multiscale_with_cycle_consistency`` as in the README's quick
   start;
7. serving, squad engine: 2,000 queries on one pair through
   ``FasterSparseEngine(mode="tile")``, beside the scan engine on the same
   queries, which the squad engine must reproduce when every task is a
   squad of its own;
8. serving, many pairs: 8 pairs of 32 queries through
   ``cotr_corr_multiscale_multipair``, beside 8 serial calls, then the
   cycle-consistent multi-pair call on two of them;
9. training, card against CPU: one ``cotr_loss`` forward and backward at
   full width (dropout 0, batch 2, 100 queries) on both devices;
10. training: 30 steps of ``Trainer.train`` at full width with
    ``TrainConfig()`` (batch 24, 200 queries a sample, dropout 0.1) on one
    generated batch in the ``crop`` + ``h_mat`` layout, from the flagship's
    backbone and fresh weights elsewhere; the steady steps run under
    ``torch.cuda.set_sync_debug_mode("error")`` and launch no attention
    kernel (the einsum path). Then a step on a batch that holds a NaN (it
    must change nothing but the step count), five steps with
    ``lr_backbone=1e-5`` (layer2/3 convolutions move, the stem, layer1 and
    FrozenBN do not) and a few in bfloat16, each with its time a step and
    its peak memory;
11. the evaluation step on that batch, through the kernels, beside the
    einsum path;
12. a checkpoint that a fresh Trainer resumes to the same next step, and
    the trained weights written as ``.npz`` and served by ``SparseEngine``;
13. the synthetic recipe's loader alone (``[synthetic-loader]``): batches
    of 24 from the train twin's dataset (8 generated ``.npy`` textures, 64
    procedural ones, ``tex_aug``, the crop layout) through
    ``PrefetchLoader`` with 8 workers, samples a second and one worker's
    time a sample; a few batches in the ``image`` layout;
14. the train twin (``cotr_tpu_torch.tools.train_synthetic``) from that
    loader (``[synthetic-train]``): 60 steps at batch 24 with its defaults
    (bfloat16, lr_backbone 1e-4, dropout 0) from the flagship, a
    validation every 30 through the kernels, checkpoints, the held-out
    error before and after; then ``--resume`` to step 70;
15. the eval twin (``cotr_tpu_torch.tools.eval_synthetic_pair``) on a
    generated 512 x 512 image (``[synthetic-eval]``): three warp seeds, a
    12 x 12 grid, ``FasterSparseEngine`` with ``max_load`` 256, zoom depth
    4, the painted overlay; in bfloat16 and float32;
16. the MegaDepth path on a generated COLMAP scene (48 views of
    768 x 1024: a tilted plane and two rectangles in front of it, ``.npy``
    images and COLMAP ``.bin`` depths, repeated as 4 scenes for the
    training split; ``tools/generated_scene.py``):
    ``[megadepth-data]``, the native ``synth_corrs``, ``count_valid_depth``
    and ``parse_images_txt`` against the numpy paths, samples a second of
    ``CotrDataset`` (host layout and ``device_synth``) and
    ``CotrZoomDataset`` on one thread and through ``PrefetchLoader`` with
    the twin's workers, the bytes of a batch in each layout;
17. ``[device-synth]``: one candidate batch of 24 synthesized on the card
    and on the CPU from the same scores; then train steps on it under
    ``set_sync_debug_mode("error")``, launching no attention kernel;
18. ``[megadepth-train]``: the train twin (``tools/train_cotr.py``) from
    the flagship, 20 float32 steps in the host layout with a validation
    every 10, then 20 with ``--device_synth yes``;
19. ``[megadepth-eval]``: the eval twin (``tools/eval_megadepth.py``),
    bfloat16, 4 pairs of the validation split, a 32 x 32 grid, zoom depth
    3, ``FasterSparseEngine``; then one pair at 16 x 16 through
    ``SparseEngine`` (``--faster_infer no``);
20. ``[convert]``, after the checkpoint phase: the flagship written in the
    reference's ``.pth.tar`` layout through the convert twin
    (``cotr_tpu_torch.tools.convert_checkpoint --verify``), one forward
    served from the ``.npz`` it wrote (equal to the flagship's), and the
    publish twin from the training phase's ``Trainer`` checkpoint;
21. ``[demos]``, after the MegaDepth phases: each demo twin's ``main``
    (``cotr_tpu_torch.demos``) at full width in float32 on generated
    ``.npy`` inputs: single pair with ``--densify`` (a 768 x 1024 pair, B a
    known homography of A), face (68 fixed queries, a 480 x 640 pair),
    homography (the annotated corners on a 4032 x 3024 image), wbs (100
    annotated rows, ``areas=[1, 1]``: no dense seed pass), guided matching
    and reconstruction (two views of the generated scene, their cameras,
    ``--faster_infer yes``), each with its launches by shape;
22. ``[eval-suite]``: the eval-suite twin (bfloat16, 4 generated images
    and 4 procedural textures, 5 seeds, a 15 x 15 grid) and the
    diagnose-tail twin at its defaults; the flagship file must be
    byte-identical at the end;
23. one JSON line describing each kernel, then the device line last.

The kernel's launch counts are set to 0 just before each path and read just
after it.

It imports nothing of JAX or the JAX package. Without a card, or without
the repository around it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "checkpoints", "flagship.npz")
ZOOMS = list(np.linspace(0.5, 0.0625, 4))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# the card's published peaks (H100 SXM data sheet, dense, at 700 W). The
# float32 peak is the TF32 tensor-core rate, not the 67 TFLOP/s of the fp32
# pipes: a float32 product split into TF32 pieces runs on the tensor cores,
# so the fp32 pipes' rate is no lower limit on its time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}

# kernel vs plain on the card. float32: the row kernel computes exact fp32
# products in another order of summation; the tile kernel splits each
# operand into two TF32 pieces and sums three tensor-core products, which
# drops a 2**-22 tail of every product, and takes exp2 from the
# special-function unit (2 ulp). bfloat16: probabilities and outputs round
# to bf16 (ulp 2**-8 near 1).
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# flagship forward, card vs CPU, float32 without TF32: conv and matmul
# algorithms sum in other orders through 53 ResNet convs and 12 transformer
# layers; outputs are canvas coordinates in [0, 1]
FORWARD_TOL = 1e-3

# (B, Lq) of each attention on the main path (S = 512 keys, 8 heads of 32)
SHAPES = [("encoder self-attention", 2, 512),
          ("refinement encoder", 256, 512),
          ("dense decode chunk", 4, 8192),
          ("refinement decode", 256, 1),
          ("ragged query tile", 2, 600),
          ("squad encoder", 128, 512),
          ("squad decode, member bucket", 128, 64),
          ("squad decode, max_load + 1", 128, 257),
          ("squad decode, small group", 8, 64),
          ("squad encoder, small group", 8, 512),
          ("dense seed of one square pair: encoder", 1, 512),
          ("dense seed of one square pair: decode chunk", 1, 8192),
          ("evaluation encoder", 24, 512),
          ("evaluation decode", 24, 200)]

# the windowed crops vs the full-image crop, float32 on a [0, 1] image: the
# same sum with its zero terms left out, in another order
CROP_TOL = 1e-6
# two runs of the same refinement under another dispatch composition (the
# squad engine with every task a squad of its own vs the scan engine; one
# multi-pair call vs serial calls): the cuDNN batch changes, and
# patch_box's floor turns that into whole-pixel box shifts for a few
SAME_WITHIN_1PX = 0.95
SAME_MEDIAN_PX = 0.1

# one loss forward and backward at full width, card vs CPU, float32 without
# TF32: the same sums in other orders, through 53 convolutions and 12 layers,
# twice. float32 rounding alone moves single tensors' gradients by a
# hundredth of their size there (a ReLU that flips, sums that cancel), so the
# sharp gate is on the whole gradient: the L2 norm of the difference over the
# L2 norm of the CPU's gradient. Each tensor is held to the looser share of
# its own norm; a tensor whose gradient is rounding noise (a key projection's
# bias: a softmax does not see a constant added to all its logits) to that
# share of 1e-4 of the whole gradient's norm
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 2e-3
TRAIN_TENSOR_RTOL = 3e-2
TRAIN_TENSOR_FLOOR = 1e-4
# the targets of that comparison are displaced by this much (8 px of the
# canvas's width): at the flagship's own targets its gradient is a sum of
# terms that nearly cancel, which float32 resolves ten times worse
TRAIN_PARITY_SHIFT = 0.03
TRAIN_STEPS = 30
# the first steps pay for cuDNN's choice of algorithms and the allocator
TRAIN_WARMUP_STEPS = 3
# the evaluation step through the kernels vs the einsum path, float32
EVAL_RTOL = 1e-4
# the synthetic recipe (tools/train_synthetic.py's twin): batches of 24 from
# its dataset, 8 generated textures plus 64 procedural ones
SYNTH_BATCH = 24
SYNTH_TEXTURES = 8
SYNTH_LOADER_BATCHES = 20
SYNTH_IMAGE_BATCHES = 5
SYNTH_STEPS = 60
SYNTH_VALID_ITER = 30
SYNTH_RESUME_STEPS = 70
# the MegaDepth path: a generated scene of 48 views, 24 of them the
# validation split (one batch of 24), repeated as 4 scenes for the training
# split (192 queries: 8 batches a pass, where one scene would restart the
# loader every other step); the twin's settings (batch 24, 100
# correspondences both ways)
MD_VIEWS = 48
MD_VAL_VIEWS = 24
MD_SCENES = 4
MD_HW = (768, 1024)
MD_ONE_THREAD_SAMPLES = 24
MD_LOADER_BATCHES = 4
MD_STEPS = 20
MD_VALID_ITER = 10
# the steps whose median is reported: after the first 5 (cuDNN's choices,
# the allocator, the loader's first batch)
MD_STEADY_FROM = 5
# device synthesis, card vs CPU, float32: the same products in other
# orders; a candidate within this of a decision's edge (|z_d - z_proj|
# near 0.5, a coordinate near a frame bound) may fall either way
SYNTH_PX_TOL = 1e-3
SYNTH_EDGE = 1e-4
MD_SYNTH_STEPS = 8
MD_EVAL_PAIRS = 4
# the demos' generated inputs: chip_smoke's first serving pair, the
# non-square one, and a portrait photograph of 12 megapixels, whose size
# holds the homography demo's annotated corners
DEMO_HW = (768, 1024)
FACE_HW = (480, 640)
PAINT_HW = (4032, 3024)
# the eval-suite twin's seeds, as it takes them
SUITE_SEEDS = "0,1,2,3,4"
# a resumed step vs the unbroken one: the same kernels on the same values,
# but for cuDNN's and cuBLAS's freedom in the order of a sum; one step moves
# a weight by about the rate, 1e-4
RESUME_ATOL = 1e-6


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

def _nvidia_smi(fields: str, fmt: str = "csv,noheader") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_card() -> str:
    line = _nvidia_smi("name,power.limit")
    log(line)
    return line


def exp_rate_per_s() -> float:
    """exp evaluations a second the card can do at most: 16 a clock on each
    SM's special-function units, at the highest SM clock nvidia-smi
    reports."""
    mhz = float(_nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[card] {sms} SMs, clocks.max.sm {mhz:.0f} MHz")
    return sms * 16 * mhz * 1e6


def phase_build(attention, native, grouped) -> dict:
    """The three sources at once, each by its own compiler; then the native
    squad formation against the numpy scan."""
    def timed(build, *args):
        t0 = time.perf_counter()
        return build(*args), time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(timed, attention.build_library)]
        jobs += [pool.submit(timed, native.build_library, name)
                 for name in native.SOURCES]
        built = [job.result() for job in jobs]
    attention._library()
    for name in native.SOURCES:
        native._library(name)
    seconds = time.perf_counter() - t0
    for path, secs in built:
        log(f"[build] {os.path.relpath(path, ROOT)} in {secs:.1f} s")

    # a 100 x 100 grid of tasks on a 768 x 1024 pair, targets a few pixels
    # off, at the third zoom level's scale
    t = 10_000
    rng = np.random.RandomState(3)
    gx, gy = np.meshgrid(np.linspace(8, 1016, 100), np.linspace(8, 760, 100))
    loc_from = np.stack([gx.ravel(), gy.ravel()], axis=1) \
        + rng.uniform(-2, 2, (t, 2))
    loc_to = loc_from + rng.normal(0, 3, (t, 2))
    active = np.ones(t, bool)
    out, secs = {}, {}
    for impl in ("native", "numpy"):
        t1 = time.perf_counter()
        out[impl] = grouped.form_squads(
            loc_from, loc_to, active, 0.208, 0.208, (768, 1024), (768, 1024),
            256, np.random.RandomState(4), impl=impl)
        secs[impl] = time.perf_counter() - t1
    if not (np.array_equal(out["native"][0], out["numpy"][0])
            and np.array_equal(out["native"][1], out["numpy"][1])):
        raise AssertionError("native form_squads differs from the numpy scan")
    n_squads = len(out["native"][1])
    log(f"[build] form_squads, {t} tasks -> {n_squads} squads: native "
        f"{secs['native'] * 1e3:.2f} ms, numpy {secs['numpy'] * 1e3:.2f} ms, "
        f"equal")
    return dict(build_s=seconds, form_squads_tasks=t,
                form_squads_squads=n_squads,
                form_squads_native_ms=secs["native"] * 1e3,
                form_squads_numpy_ms=secs["numpy"] * 1e3)


def phase_crops(sampling) -> list:
    """Both windowed crops against ``crop_and_resize_matmul`` on the card:
    a 768 x 1024 image, patches of 384 (the first zoom level) and 48 (the
    last), 128 boxes, out size 256."""
    rng = np.random.RandomState(5)
    h, w, g = 768, 1024, 128
    img = torch.from_numpy(rng.rand(h, w, 3).astype(np.float32)).cuda()
    stack = torch.stack([img, img.flip(0), img.flip(1)])
    rows = []
    for patch in (384, 48):
        boxes = np.stack([rng.randint(0, w - patch + 1, g),
                          rng.randint(0, h - patch + 1, g),
                          np.full(g, patch), np.full(g, patch)],
                         axis=1).astype(np.float32)
        boxes[0, :2] = 0
        boxes[1, :2] = (w - patch, h - patch)
        idx = rng.randint(0, 3, g).astype(np.int32)
        boxes_dev = torch.from_numpy(boxes).cuda()
        full = sampling.crop_and_resize_matmul(img, boxes_dev, 256)
        windowed = sampling.crop_and_resize_windowed(img, boxes, 256, patch)
        # the indexed crop with a window wider than the boxes, as the
        # multi-pair engine calls it
        window = min(-(-patch // 64) * 64 + 64, h)
        indexed = sampling.crop_and_resize_window_indexed(
            stack, boxes, idx, 256, window)
        want = torch.stack([sampling.crop_and_resize_matmul(
            stack[i], boxes_dev[k:k + 1], 256)[0]
            for k, i in enumerate(idx.tolist())])
        errs = dict(windowed=(windowed - full).abs().max().item(),
                    indexed=(indexed - want).abs().max().item())
        for name, err in errs.items():
            if not err <= CROP_TOL:
                raise AssertionError(f"{name} crop at patch {patch}: max abs "
                                     f"err {err} > {CROP_TOL}")
        ms = dict(
            full=time_ms(lambda: sampling.crop_and_resize_matmul(
                img, boxes_dev, 256), 10),
            windowed=time_ms(lambda: sampling.crop_and_resize_windowed(
                img, boxes, 256, patch), 10),
            indexed=time_ms(lambda: sampling.crop_and_resize_window_indexed(
                stack, boxes, idx, 256, window), 10))
        rows.append(dict(patch=patch, boxes=g, window=window,
                         max_abs_err=errs, ms=ms))
        log(f"[crops] patch {patch:3d}, {g} boxes of a {h}x{w} image: "
            f"windowed err {errs['windowed']:.2e}, indexed (window {window}) "
            f"err {errs['indexed']:.2e} (tol {CROP_TOL}); full-image "
            f"{ms['full']:.3f} ms, windowed {ms['windowed']:.3f} ms, "
            f"indexed {ms['indexed']:.3f} ms")
    return rows


def check_shape(attention, label, b, lq, dtype, exp_rate, s=512) -> dict:
    """The kernel at (B, Lq, S) in ``dtype`` against its plain version
    (raises past ``KERNEL_TOL``), and its times beside the plain version's,
    SDPA's and the bound."""
    h, hd = 8, 32
    td = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(b * 131 + lq)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(td)
               for shape in ((b, lq, h, hd), (b, s, h, hd), (b, s, h, hd)))
    got = attention.flash_cross_attention(q, k, v)
    torch.cuda.synchronize()
    want = attention.flash_cross_attention_plain(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= KERNEL_TOL[dtype]:
        raise AssertionError(
            f"kernel vs plain at {label} B={b} Lq={lq} {dtype}: max abs err "
            f"{err} > {KERNEL_TOL[dtype]}")
    iters = 20 if b * lq >= 4096 else 100
    ms = time_ms(lambda: attention.flash_cross_attention(q, k, v), iters)
    plain_ms = time_ms(
        lambda: attention.flash_cross_attention_plain(q, k, v), iters)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
    bound_ms, bound_by = attention_bound_ms(b, lq, s, h, hd, dtype)
    variant = attention.choose_kernel(lq, s, td)
    # the tile kernel at each height it is built for (at Lq = 1 too, where
    # the wrapper picks the row kernel), to show what the wrapper should pick
    by_rows = {n: time_ms(lambda: attention.flash_cross_attention(
        q, k, v, tile_rows=n), iters) for n in (64, 128)}
    row = dict(shape=label, b=b, lq=lq, s=s, h=h, hd=hd, dtype=dtype,
               variant=variant, ms_by_tile_rows=by_rows,
               # not the bound: one exp a logit is a second floor, which
               # the softmax sets
               exp_floor_ms=b * h * lq * s / exp_rate * 1e3,
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"[kernel] {label:24s} B={b:<4d} Lq={lq:<5d} {dtype:8s} "
        f"{variant:4s} err {err:.2e}  kernel {ms:.4f} ms  "
        f"plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  "
        f"bound {bound_ms:.4f} ms ({bound_by})  "
        f"exp floor {row['exp_floor_ms']:.4f} ms"
        + "".join(f"  tile of {n} rows {t:.4f} ms"
                  for n, t in by_rows.items()))
    return row


def phase_kernel(attention) -> list:
    exp_rate = exp_rate_per_s()
    return [check_shape(attention, label, b, lq, dtype, exp_rate)
            for dtype in ("float32", "bfloat16") for label, b, lq in SHAPES]


def phase_path_shapes(attention, shape_counts, rows) -> list:
    """Every (B, Lq, S, dtype) that a counted path launched and
    ``phase_kernel`` did not check, held against the plain version the same
    way. These launches come after the paths' counts were read."""
    checked = {(r["b"], r["lq"], r["s"], r["dtype"]) for r in rows}
    exp_rate = exp_rate_per_s()
    return [check_shape(attention, "launched on a path", r["b"], r["lq"],
                        r["dtype"], exp_rate, s=r["s"])
            for r in shape_counts
            if (r["b"], r["lq"], r["s"], r["dtype"]) not in checked]


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


@contextlib.contextmanager
def counted(attention, record: dict):
    """Set the kernel's counts to 0, run the body, and fill ``record`` with
    the wall time (the card drained at both ends), the launches and the
    launches by shape."""
    torch.cuda.synchronize()
    attention.launches = 0
    attention.shape_counts.clear()
    t0 = time.perf_counter()
    yield record
    torch.cuda.synchronize()
    record["wall_s"] = time.perf_counter() - t0
    record["launches"] = attention.launches
    record["shape_counts"] = [
        dict(b=b, lq=lq, s=s, dtype=dtype, launches=n)
        for (b, lq, s, dtype), n in sorted(attention.shape_counts.items())]


def log_counts(tag: str, record: dict) -> None:
    for row in record["shape_counts"]:
        log(f"[{tag}] launches at B={row['b']:<4d} Lq={row['lq']:<5d} "
            f"S={row['s']:<4d} {row['dtype']}: {row['launches']}")
    if record["launches"] < 1:
        raise AssertionError(f"[{tag}] launched no attention kernel")


def kernel_variants(attention, record: dict) -> dict:
    """A counted run's launches by kernel: {"tile": n, "row": m}."""
    variants = {}
    for row in record["shape_counts"]:
        kind = attention.choose_kernel(row["lq"], row["s"],
                                       getattr(torch, row["dtype"]))
        variants[kind] = variants.get(kind, 0) + row["launches"]
    return variants


def in_frame(corrs: np.ndarray, img_a, img_b) -> np.ndarray:
    ha, wa = img_a.shape[:2]
    hb, wb = img_b.shape[:2]
    return ((corrs[:, 0] >= 0) & (corrs[:, 0] < wa)
            & (corrs[:, 1] >= 0) & (corrs[:, 1] < ha)
            & (corrs[:, 2] >= 0) & (corrs[:, 2] < wb)
            & (corrs[:, 3] >= 0) & (corrs[:, 3] < hb))


def make_pair(rng, hw, angle, scale, shift) -> tuple:
    h, w = hw
    img_a = procedural_texture(rng, h, w)
    hmat = known_homography(h, w, angle, scale, shift)
    return img_a, warp_homography(img_a, hmat), hmat


def phase_serve(attention, engine_cls, runner) -> tuple:
    rng = np.random.RandomState(1)
    pairs = [make_pair(rng, hw, angle, scale, shift)
             for hw, angle, scale, shift in [
                 ((768, 1024), 4.0, 1.05, (20, -12)),
                 ((512, 512), -3.0, 0.97, (-10, 8)),
                 ((480, 640), 2.0, 1.0, (16, 10))]]
    engine = engine_cls(runner, mode="tile")
    with counted(attention, {}) as record:
        results = [engine.cotr_corr_multiscale_with_cycle_consistency(
            a, b, zoom_ins=ZOOMS, max_corrs=100) for a, b, _ in pairs]
    wall, launches = record["wall_s"], record["launches"]
    summary = []
    for (img_a, img_b, hmat), corrs in zip(pairs, results):
        ha, wa = img_a.shape[:2]
        hb, wb = img_b.shape[:2]
        if corrs.shape[0] < 1 or corrs.shape[1] != 4:
            raise AssertionError(f"pair {ha}x{wa}: {corrs.shape}")
        if not np.isfinite(corrs).all():
            raise AssertionError(f"pair {ha}x{wa}: non-finite output")
        if not in_frame(corrs, img_a, img_b).all():
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
    log_counts("serve", record)
    record["pairs"] = summary
    return record, pairs[0]


def grid_queries(h: int, w: int, nx: int = 50, ny: int = 40) -> np.ndarray:
    """An nx x ny grid of query points over the middle 80% of an image."""
    gx, gy = np.meshgrid(np.linspace(0.1 * w, 0.9 * w, nx),
                         np.linspace(0.1 * h, 0.9 * h, ny))
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


class SquadLog:
    """Counts the squads of every squad formation while it is installed
    over ``grouped.form_squads`` (the engine looks the function up at each
    call), so a run can tell real canvases from padded ones."""

    def __init__(self, grouped):
        self.grouped = grouped
        self.squads = []

    def __enter__(self):
        self.original = self.grouped.form_squads

        def logged(*args, **kwargs):
            squad_of, pilots = self.original(*args, **kwargs)
            self.squads.append(len(pilots))
            return squad_of, pilots

        self.grouped.form_squads = logged
        return self

    def __exit__(self, *exc):
        self.grouped.form_squads = self.original


def _has_shape(record: dict, b: int, lq: int) -> bool:
    return any(r["b"] == b and r["lq"] == lq and r["s"] == 512
               for r in record["shape_counts"])


def phase_grouped(attention, grouped, faster_cls, scan_cls, runner,
                  pair) -> dict:
    """2,000 queries of one 768 x 1024 pair through the squad engine with
    its defaults, and through the scan engine for comparison.

    Two things are held apart. The squad machinery (squad tables, windowed
    crops, padded dispatches, the way back to pixels) must reproduce the
    scan engine when every task is a squad of its own (``max_load=0``).
    With the default grouping a member reuses its pilot's crops, which
    costs accuracy by design; that cost is measured and printed, and the
    gate on it is only that refinement still improves on the seeds."""
    img_a, img_b, hmat = pair
    h, w = img_a.shape[:2]
    queries = grid_queries(h, w)
    n = len(queries)
    kw = dict(zoom_ins=ZOOMS, queries_a=queries, force=True, max_corrs=n)
    truth = apply_h(hmat, queries)

    # one small call each first, so neither timed call pays for the first
    # use of its shapes (cuDNN's choice of algorithms, the allocator)
    warm = dict(kw, queries_a=queries[::8], max_corrs=n // 8)
    faster_cls(runner, mode="tile").cotr_corr_multiscale(img_a, img_b, **warm)
    scan_cls(runner, mode="tile").cotr_corr_multiscale(img_a, img_b, **warm)

    engine = faster_cls(runner, mode="tile")
    engine.collect_diagnostics = True
    with SquadLog(grouped) as squads, counted(attention, {}) as record:
        got = engine.cotr_corr_multiscale(img_a, img_b, **kw)
    scan = scan_cls(runner, mode="tile")
    scan.collect_diagnostics = True
    with counted(attention, {}) as scan_record:
        want = scan.cotr_corr_multiscale(img_a, img_b, **kw)
    with counted(attention, {}) as solo_record:
        solo = faster_cls(runner, mode="tile", max_load=0
                          ).cotr_corr_multiscale(img_a, img_b, **kw)

    def by_level(eng):
        return [float(np.median(np.linalg.norm(level - truth, axis=1)))
                for level in eng.last_diag["history"]]

    for name, corrs in (("squad", got), ("scan", want),
                        ("squads of one", solo)):
        if corrs.shape != (n, 4) or not np.isfinite(corrs).all():
            raise AssertionError(f"{name} engine: shape {corrs.shape} or "
                                 f"non-finite output")
        if not in_frame(corrs, img_a, img_b).all():
            raise AssertionError(f"{name} engine: correspondences out of "
                                 f"frame")
    err = np.linalg.norm(got[:, 2:] - truth, axis=1)
    scan_err = np.linalg.norm(want[:, 2:] - truth, axis=1)
    solo_diff = np.linalg.norm(solo[:, 2:] - want[:, 2:], axis=1)
    stepper = engine._stepper
    levels = len(ZOOMS)
    real = int(sum(squads.squads))
    padded_share = 1.0 - real / stepper.canvas_count
    record.update(
        queries=n, median_px=float(np.median(err)),
        within_5px=float(np.mean(err <= 5.0)),
        squads_per_level=squads.squads,
        dispatch_count=stepper.dispatch_count,
        canvas_count=stepper.canvas_count, squads=real,
        padded_canvas_share=padded_share,
        scan=dict(wall_s=scan_record["wall_s"],
                  launches=scan_record["launches"],
                  median_px=float(np.median(scan_err)),
                  within_5px=float(np.mean(scan_err <= 5.0)),
                  canvases=n * levels),
        median_px_by_level=by_level(engine),
        scan_median_px_by_level=by_level(scan),
        squads_of_one=dict(
            wall_s=solo_record["wall_s"],
            within_1px_of_scan=float(np.mean(solo_diff <= 1.0)),
            median_px_from_scan=float(np.median(solo_diff))))
    log(f"[grouped] {n} queries, {h}x{w}: squad engine {record['wall_s']:.2f}"
        f" s wall, median error vs the known homography "
        f"{record['median_px']:.2f} px, {record['within_5px']:.0%} within "
        f"5 px; scan engine {scan_record['wall_s']:.2f} s wall, median "
        f"{record['scan']['median_px']:.2f} px, "
        f"{record['scan']['within_5px']:.0%} within 5 px")
    log(f"[grouped] median error by level, seeds first: squad engine "
        f"{np.round(record['median_px_by_level'], 2).tolist()}, scan engine "
        f"{np.round(record['scan_median_px_by_level'], 2).tolist()}")
    log(f"[grouped] squads of one (max_load=0) vs the scan engine: "
        f"{np.mean(solo_diff <= 1.0):.1%} within 1 px, median distance "
        f"{np.median(solo_diff):.5f} px, {solo_record['wall_s']:.2f} s wall")
    log(f"[grouped] squads per level {squads.squads}; dispatch_count "
        f"{stepper.dispatch_count}, canvas_count {stepper.canvas_count} "
        f"(scan: {n * levels} canvases), of which padding "
        f"{stepper.canvas_count - real} ({padded_share:.1%})")
    log_counts("grouped", record)
    if not (np.mean(solo_diff <= 1.0) >= SAME_WITHIN_1PX
            and np.median(solo_diff) <= SAME_MEDIAN_PX):
        raise AssertionError("the squad engine with every task a squad of "
                             "its own disagrees with the scan engine")
    if not record["median_px"] < record["median_px_by_level"][0]:
        raise AssertionError("the squad engine's refinement did not improve "
                             "on its seeds")
    if not stepper.canvas_count < n * levels:
        raise AssertionError("no grouping: as many canvases as tasks x "
                             "levels")
    if not (_has_shape(record, 128, 512)
            and (_has_shape(record, 128, 257) or _has_shape(record, 128, 64))):
        raise AssertionError("the squad shapes are missing from the "
                             "kernel's launches")
    return record


def phase_multipair(attention, grouped, faster_cls, runner) -> dict:
    """8 pairs of 480 x 640 with 32 queries each: one multi-pair call
    against 8 serial calls on engines seeded like the pairs; then the
    cycle-consistent multi-pair call on the first two."""
    rng = np.random.RandomState(6)
    n_pairs, n_q = 8, 32
    pairs, queries = [], []
    for i in range(n_pairs):
        pairs.append(make_pair(
            rng, (480, 640), angle=rng.uniform(-4, 4),
            scale=rng.uniform(0.97, 1.04), shift=rng.uniform(-12, 12, 2)))
        queries.append(np.stack([rng.uniform(0.15 * 640, 0.85 * 640, n_q),
                                 rng.uniform(0.15 * 480, 0.85 * 480, n_q)],
                                axis=1))
    images = [(a, b) for a, b, _ in pairs]
    kw = dict(zoom_ins=ZOOMS, force=True, max_corrs=n_q)

    def make(seed=0):
        return faster_cls(runner, mode="tile", seed_stride=4, seed=seed)

    # first use of the shapes, outside both timings
    make().cotr_corr_multiscale_multipair(
        images[:2], queries_list=queries[:2], pair_seeds=[0, 1], **kw)
    make().cotr_corr_multiscale(*images[0], queries_a=queries[0], **kw)

    engine = make()
    with SquadLog(grouped) as squads, counted(attention, {}) as record:
        multi = engine.cotr_corr_multiscale_multipair(
            images, queries_list=queries, pair_seeds=list(range(n_pairs)),
            **kw)
    serial_canvases = 0
    with SquadLog(grouped) as serial_squads, \
            counted(attention, {}) as serial_record:
        serial = []
        for i, ((a, b), q) in enumerate(zip(images, queries)):
            eng = make(seed=i)
            serial.append(eng.cotr_corr_multiscale(a, b, queries_a=q, **kw))
            serial_canvases += eng._stepper.canvas_count

    per_pair = []
    for i, (got, want, (a, b, hmat)) in enumerate(zip(multi, serial, pairs)):
        if got.shape != (n_q, 4) or not np.isfinite(got).all():
            raise AssertionError(f"multi-pair, pair {i}: shape {got.shape} "
                                 f"or non-finite output")
        if not in_frame(got, a, b).all():
            raise AssertionError(f"multi-pair, pair {i}: out of frame")
        diff = np.linalg.norm(got[:, 2:] - want[:, 2:], axis=1)
        err = np.linalg.norm(apply_h(hmat, got[:, :2]) - got[:, 2:], axis=1)
        per_pair.append(dict(within_1px_of_serial=float(np.mean(diff <= 1.0)),
                             median_px_from_serial=float(np.median(diff)),
                             median_px=float(np.median(err))))
        log(f"[multipair] pair {i}: {np.mean(diff <= 1.0):.0%} within 1 px "
            f"of the serial call, median distance {np.median(diff):.4f} px; "
            f"median error vs the known homography {np.median(err):.2f} px")
    stepper = engine._stepper
    real = int(sum(squads.squads))
    record.update(
        pairs=n_pairs, queries_per_pair=n_q, per_pair=per_pair,
        dispatch_count=stepper.dispatch_count,
        canvas_count=stepper.canvas_count, squads=real,
        padded_canvas_share=1.0 - real / stepper.canvas_count,
        serial=dict(wall_s=serial_record["wall_s"],
                    launches=serial_record["launches"],
                    canvas_count=serial_canvases,
                    squads=int(sum(serial_squads.squads)),
                    padded_canvas_share=1.0 - sum(serial_squads.squads)
                    / serial_canvases))
    log(f"[multipair] {n_pairs} pairs x {n_q} queries: one call "
        f"{record['wall_s']:.2f} s wall, {stepper.dispatch_count} dispatches,"
        f" {stepper.canvas_count} canvases ({real} squads, "
        f"{record['padded_canvas_share']:.1%} padding); {n_pairs} serial "
        f"calls {serial_record['wall_s']:.2f} s wall, {serial_canvases} "
        f"canvases ({record['serial']['padded_canvas_share']:.1%} padding)")
    log_counts("multipair", record)
    for i, row in enumerate(per_pair):
        if not (row["within_1px_of_serial"] >= SAME_WITHIN_1PX
                and row["median_px_from_serial"] <= SAME_MEDIAN_PX):
            raise AssertionError(f"multi-pair, pair {i} disagrees with its "
                                 f"serial call: {row}")

    with counted(attention, {}) as cycle_record:
        cycle = make().cotr_corr_multiscale_with_cycle_consistency_multipair(
            images[:2], zoom_ins=ZOOMS, max_corrs=n_q,
            queries_list=queries[:2], pair_seeds=[0, 1])
    for i, (corrs, (a, b, hmat)) in enumerate(zip(cycle, pairs)):
        if corrs.shape[0] < 1 or corrs.shape[1] != 4 \
                or not np.isfinite(corrs).all():
            raise AssertionError(f"cycle multi-pair, pair {i}: "
                                 f"{corrs.shape} or non-finite output")
        if not in_frame(corrs, a, b).all():
            raise AssertionError(f"cycle multi-pair, pair {i}: out of frame")
        err = np.linalg.norm(apply_h(hmat, corrs[:, :2]) - corrs[:, 2:],
                             axis=1)
        log(f"[multipair] cycle-consistent, pair {i}: {corrs.shape[0]} "
            f"correspondences, median error {np.median(err):.2f} px")
    log(f"[multipair] cycle-consistent call on 2 pairs: "
        f"{cycle_record['wall_s']:.2f} s wall, {cycle_record['launches']} "
        f"launches")
    record["cycle"] = dict(wall_s=cycle_record["wall_s"],
                           launches=cycle_record["launches"],
                           shape_counts=cycle_record["shape_counts"],
                           correspondences=[int(c.shape[0]) for c in cycle])
    return record


# ---------------------------------------------------------------- training

def make_train_batch(rng, n: int, num_kp: int) -> dict:
    """``n`` samples in the ``crop`` + ``h_mat`` layout: 256-square generated
    crops, a known homography each, ``num_kp`` correspondences that stay in
    both frames, normalized to the canvas (x of the B side plus 256, then x
    over 512 and y over 256), both directions stacked. numpy arrays."""
    size = 256
    crops, h_mats, queries, targets = [], [], [], []
    while len(crops) < n:
        hmat = known_homography(size, size, rng.uniform(-12, 12),
                                rng.uniform(0.9, 1.12),
                                rng.uniform(-14, 14, 2))
        pts_a = rng.uniform(8, size - 9, (6 * num_kp, 2))
        pts_b = apply_h(hmat, pts_a)
        ok = ((pts_b >= 0.0) & (pts_b <= size - 1.001)).all(axis=1)
        if ok.sum() < num_kp:
            continue
        corrs = np.concatenate([pts_a[ok][:num_kp], pts_b[ok][:num_kp]], 1)
        corrs[:, 2] += size
        corrs /= np.array([2 * size, size, 2 * size, size])
        crops.append(procedural_texture(rng, size, size))
        h_mats.append(hmat)
        queries.append(np.concatenate([corrs[:, :2], corrs[:, 2:]]))
        targets.append(np.concatenate([corrs[:, 2:], corrs[:, :2]]))
    return dict(crop=np.stack(crops),
                h_mat=np.stack(h_mats).astype(np.float32),
                queries=np.stack(queries).astype(np.float32),
                targets=np.stack(targets).astype(np.float32))


def on_card(batch: dict) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def phase_train_parity(load_model, cfg, loss_mod, train_step_mod,
                       train_cfg) -> dict:
    """One ``cotr_loss`` forward and backward at full width with the
    flagship's weights, dropout 0, batch 2, 100 queries a sample, the
    targets displaced: the card against the CPU."""
    batch = make_train_batch(np.random.RandomState(8), 2, 50)
    batch["targets"] = batch["targets"] + np.float32(TRAIN_PARITY_SHIFT)
    cfg = dataclasses.replace(cfg, dropout=0.0)
    out = {}
    for device in ("cuda", "cpu"):
        model = load_model(FLAGSHIP, cfg, device=device).train()
        t0 = time.perf_counter()
        views = train_step_mod.batch_views(
            {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
            train_cfg)
        loss, metrics = loss_mod.cotr_loss(model, *views[:3])
        loss.backward()
        out[device] = dict(
            loss=float(loss.detach()),
            cycle_loss=float(metrics["cycle_loss"].detach()),
            grads={k: p.grad.cpu().numpy()
                   for k, p in model.named_parameters()})
        log(f"[train-parity] {device}: loss {out[device]['loss']:.6f} "
            f"(cycle term {out[device]['cycle_loss']:.6f}) in "
            f"{time.perf_counter() - t0:.2f} s")
        del model
    loss_err = abs(out["cuda"]["loss"] - out["cpu"]["loss"]) \
        / abs(out["cpu"]["loss"])
    want, got = out["cpu"]["grads"], out["cuda"]["grads"]

    def norm(arrays) -> float:
        return float(np.sqrt(sum(np.square(a, dtype=np.float64).sum()
                                 for a in arrays)))

    whole = norm(want.values())
    grad_err = norm(got[k] - g for k, g in want.items()) / whole
    worst, worst_key = 0.0, ""
    for key, g in want.items():
        err = norm([got[key] - g]) / max(norm([g]),
                                         TRAIN_TENSOR_FLOOR * whole)
        if err > worst:
            worst, worst_key = err, key
    log(f"[train-parity] full width, batch 2, 100 queries, card vs CPU: loss "
        f"rel err {loss_err:.2e} (tol {TRAIN_LOSS_RTOL}); {len(want)} "
        f"gradients, relative L2 error of the whole {grad_err:.2e} (tol "
        f"{TRAIN_GRAD_RTOL}), worst tensor {worst:.2e} of its norm at "
        f"{worst_key} (tol {TRAIN_TENSOR_RTOL})")
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_RTOL
            and worst <= TRAIN_TENSOR_RTOL):
        raise AssertionError("[train-parity] the card disagrees with the CPU")
    if not out["cpu"]["cycle_loss"] > 0.0:
        raise AssertionError("[train-parity] the cycle term is zero: the "
                             "second forward's gradient was not checked")
    return dict(loss=out["cuda"]["loss"], cycle_loss=out["cuda"]["cycle_loss"],
                loss_rel_err=loss_err, grad_rel_l2_err=grad_err,
                worst_tensor_err=worst, worst_tensor=worst_key,
                gradients=len(want))


class StepLog:
    """Installed over a Trainer's train step: keeps every step's loss (on
    the card, read after the run), records a CUDA event before each step,
    and turns the sync debug mode to "error" once the warm-up steps are
    over."""

    def __init__(self, step_fn):
        self.step_fn = step_fn
        self.losses, self.events = [], []

    def __call__(self, state, batch, generator):
        if len(self.events) == TRAIN_WARMUP_STEPS:
            torch.cuda.set_sync_debug_mode("error")
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)
        state, metrics = self.step_fn(state, batch, generator)
        self.losses.append(metrics["loss"])
        return state, metrics

    def finish(self) -> tuple:
        """(losses, median ms of a steady step: from one step's start to the
        next one's, the host's share included)."""
        torch.cuda.set_sync_debug_mode("default")
        last = torch.cuda.Event(enable_timing=True)
        last.record()
        torch.cuda.synchronize()
        marks = self.events + [last]
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return ([float(x) for x in self.losses],
                statistics.median(ms[TRAIN_WARMUP_STEPS:]))


def make_trainer(mods, cfg, train_cfg, batch, out_dir, seed=0):
    """A Trainer at step 0 on the card: the flagship's backbone, everything
    else drawn afresh from ``seed``; its loaders yield ``batch`` (already on
    the card) once an epoch."""
    trainer = mods.Trainer(mods.build_model(cfg), cfg, train_cfg,
                           lambda: [batch], lambda: [batch], out_dir=out_dir,
                           use_tensorboard=False, device="cuda")
    trainer.initialize(seed=seed)
    state = mods.params_from_flax(mods.load_flagship(FLAGSHIP))
    prefix = "backbone."
    trainer.state.model.backbone.load_state_dict(
        {k[len(prefix):]: v for k, v in state.items()
         if k.startswith(prefix)}, strict=True)
    return trainer


def run_steps(attention, trainer, steps: int, tag: str) -> dict:
    """``steps`` more steps through ``Trainer.train`` with the counts set to
    0 before; the steady ones under the sync debug mode."""
    trainer.cfg = dataclasses.replace(
        trainer.cfg, max_iter=trainer.state.step + steps)
    spy = StepLog(trainer._train_step)
    trainer._train_step = spy
    torch.cuda.reset_peak_memory_stats()
    try:
        with counted(attention, {}) as record:
            try:
                trainer.train()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        trainer._train_step = spy.step_fn
    losses, ms = spy.finish()
    record.update(steps=steps, losses=losses, ms_per_step=ms,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[{tag}] {steps} steps: {ms:.1f} ms a step (median of the steady "
        f"ones), peak memory {record['peak_memory_gb']:.2f} GB, loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}, attention kernel launches "
        f"{record['launches']}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"[{tag}] a loss is not finite: {losses}")
    if record["launches"] != 0:
        raise AssertionError(f"[{tag}] training launched the forward-only "
                             f"attention kernel {record['launches']} times")
    return record


def snapshot(trainer) -> dict:
    opt = trainer.state.optimizer
    return dict(model={k: v.clone() for k, v in
                       trainer.state.model.state_dict().items()},
                mu={k: v.clone() for k, v in opt.mu.items()},
                nu={k: v.clone() for k, v in opt.nu.items()})


def phase_train(attention, mods, batch, out_dir) -> tuple:
    cfg = mods.COTRConfig()
    train_cfg = mods.TrainConfig(valid_iter=10 ** 9)
    trainer = make_trainer(mods, cfg, train_cfg, batch, out_dir)
    main_run = run_steps(attention, trainer, TRAIN_STEPS, "train")
    first = float(np.mean(main_run["losses"][:5]))
    last = float(np.mean(main_run["losses"][-5:]))
    log(f"[train] full width, batch {batch['crop'].shape[0]}, "
        f"{batch['queries'].shape[1]} queries a sample, dropout "
        f"{cfg.dropout}, rate {train_cfg.learning_rate}: mean loss of the "
        f"first five steps {first:.5f}, of the last five {last:.5f}; steady "
        f"steps clean under set_sync_debug_mode('error')")
    if not last < first:
        raise AssertionError("[train] the loss did not fall")

    # a batch with a NaN planted: nothing may change but the step count
    before = snapshot(trainer)
    step_before = trainer.state.step
    bad = dict(batch, targets=batch["targets"].clone())
    bad["targets"][0, 0, 0] = float("nan")
    trainer.state, metrics = trainer._train_step(trainer.state, bad, None)
    after = snapshot(trainer)
    unchanged = all(torch.equal(v, after[kind][k])
                    for kind in before for k, v in before[kind].items())
    opt = trainer.state.optimizer
    log(f"[train] a step on a batch with a NaN: loss "
        f"{float(metrics['loss'])}, parameters and moments unchanged: "
        f"{unchanged}, step {step_before} -> {trainer.state.step}, Adam "
        f"count {int(opt.count)}, notfinite_count "
        f"{int(opt.notfinite_count)}")
    if not (unchanged and trainer.state.step == step_before + 1
            and int(opt.count) == TRAIN_STEPS
            and int(opt.notfinite_count) == 1
            and not np.isfinite(float(metrics["loss"]))):
        raise AssertionError("[train] the non-finite step was not skipped")

    # the freeze policy on the weights, with the backbone's rate above 0
    tuned = make_trainer(mods, cfg, dataclasses.replace(
        train_cfg, lr_backbone=1e-5), batch, out_dir)
    start = {k: v.clone() for k, v in
             tuned.state.model.backbone.state_dict().items()}
    backbone_run = run_steps(attention, tuned, 5, "train, lr_backbone 1e-5")
    buffers = {k for k, _ in tuned.state.model.backbone.named_buffers()}
    wrong = []
    for k, v in tuned.state.model.backbone.state_dict().items():
        trainable = k not in buffers and k.startswith(("body.layer2",
                                                       "body.layer3"))
        if torch.equal(v, start[k]) == trainable:
            wrong.append(k)
    log(f"[train, lr_backbone 1e-5] {len(start)} backbone tensors: layer2 "
        f"and layer3 convolutions moved, the stem, layer1 and every FrozenBN "
        f"buffer did not; against the policy: {len(wrong)} {wrong[:4]}")
    if wrong:
        raise AssertionError("[train] the freeze policy does not hold")
    del tuned, start

    bf16 = make_trainer(mods, dataclasses.replace(cfg, dtype="bfloat16"),
                        train_cfg, batch, out_dir)
    bf16_run = run_steps(attention, bf16, 8, "train, bfloat16")
    del bf16
    torch.cuda.empty_cache()
    return trainer, dict(main=main_run, first5_mean=first, last5_mean=last,
                         lr_backbone=backbone_run, bfloat16=bf16_run)


def phase_eval_step(attention, mods, trainer, batch) -> dict:
    """The evaluation step through the kernels, beside the einsum path on
    the same weights and batch."""
    from cotr_tpu_torch.models import transformer

    eval_step = mods.make_eval_step(trainer.cfg)
    model = trainer.state.model
    eval_step(model, batch)  # first use of the shapes
    with counted(attention, {}) as record:
        out = eval_step(model, batch)
    b, q = batch["queries"].shape[:2]
    by_shape = {(r["b"], r["lq"], r["s"]): r["launches"]
                for r in record["shape_counts"]}
    kernel_fn = transformer.flash_cross_attention
    transformer.flash_cross_attention = attention.einsum_attention
    try:
        with counted(attention, {}) as einsum_record:
            want = eval_step(model, batch)
    finally:
        transformer.flash_cross_attention = kernel_fn
    val, val_einsum = float(out["val_loss"]), float(want["val_loss"])
    rel = abs(val - val_einsum) / abs(val_einsum)
    pred_err = float((out["pred"] - want["pred"]).abs().max())
    record.update(val_loss=val, val_loss_einsum=val_einsum, rel_err=rel,
                  pred_max_abs_err=pred_err)
    log(f"[eval-step] val_loss {val:.6f} through the kernels, {val_einsum:.6f}"
        f" through the einsum path (rel err {rel:.2e}, tol {EVAL_RTOL}), "
        f"predictions max abs err {pred_err:.2e}; {record['launches']} "
        f"launches in {record['wall_s'] * 1e3:.1f} ms")
    log_counts("eval-step", record)
    if by_shape != {(b, 512, 512): 6, (b, q, 512): 6}:
        raise AssertionError(f"[eval-step] launches by shape {by_shape}, "
                             f"expected 6 at ({b}, 512) and 6 at ({b}, {q})")
    if einsum_record["launches"] != 0:
        raise AssertionError("[eval-step] the comparison run was to take the "
                             "einsum path")
    if not (np.isfinite(val) and rel <= EVAL_RTOL):
        raise AssertionError("[eval-step] the kernels' val_loss disagrees "
                             "with the einsum path's")
    return record


def phase_checkpoint(attention, mods, trainer, batch, out_dir) -> dict:
    """A checkpoint that a fresh Trainer resumes to the same next step; then
    the trained weights as ``.npz`` through ``load_model`` into serving."""
    trainer.save_checkpoint()
    saved_step = trainer.state.step
    trainer.cfg = dataclasses.replace(trainer.cfg, max_iter=saved_step + 1)
    trainer.train()
    fresh = make_trainer(mods, trainer.model_cfg, trainer.cfg, batch, out_dir,
                         seed=5)
    fresh.train(resume=True)
    want = trainer.state.model.state_dict()
    got = fresh.state.model.state_dict()
    diff = max(float((got[k] - v).abs().max()) for k, v in want.items())
    same_counters = (int(fresh.state.optimizer.count)
                     == int(trainer.state.optimizer.count)
                     and int(fresh.state.optimizer.total_notfinite)
                     == int(trainer.state.optimizer.total_notfinite) == 1)
    log(f"[checkpoint] saved at step {saved_step}; a fresh Trainer resumed "
        f"and took step {fresh.state.step}: parameters within {diff:.2e} of "
        f"the unbroken run's (tol {RESUME_ATOL}), counters equal: "
        f"{same_counters}")
    if not (fresh.state.step == trainer.state.step == saved_step + 1
            and diff <= RESUME_ATOL and same_counters):
        raise AssertionError("[checkpoint] the resumed step differs from the "
                             "unbroken one")
    del fresh

    path = os.path.join(out_dir, "trained.npz")
    mods.save_params_npz(trainer.state.model, path)
    runner = mods.ModelRunner(mods.load_model(path, mods.COTRConfig(),
                                              device="cuda"), device="cuda")
    img_a, img_b, _ = make_pair(np.random.RandomState(9), (480, 640), 3.0,
                                1.02, (8, -6))
    queries = grid_queries(480, 640, nx=8, ny=4)
    with counted(attention, {}) as record:
        corrs = mods.SparseEngine(runner, mode="tile").cotr_corr_multiscale(
            img_a, img_b, zoom_ins=ZOOMS, queries_a=queries, force=True,
            max_corrs=len(queries))
    log(f"[checkpoint] {os.path.getsize(path) / 1e6:.1f} MB .npz of the "
        f"trained weights -> load_model -> SparseEngine: {corrs.shape[0]} "
        f"correspondences for {len(queries)} queries in "
        f"{record['wall_s']:.2f} s, {record['launches']} kernel launches")
    if corrs.shape != (len(queries), 4) or not np.isfinite(corrs).all():
        raise AssertionError(f"[checkpoint] serving the trained weights: "
                             f"{corrs.shape} or non-finite output")
    record.update(resume_max_abs_diff=diff, saved_step=saved_step,
                  correspondences=int(corrs.shape[0]))
    return record


# ------------------------------------------------- the synthetic recipe

def write_textures(directory: str, n: int, rng) -> str:
    """``n`` generated textures as ``.npy`` files (uint8, 512 x 512 and
    512 x 640 in turn, the sizes of photographs the recipe crops); returns
    their glob."""
    for i in range(n):
        tex = procedural_texture(rng, 512, 640 if i % 2 else 512)
        np.save(os.path.join(directory, f"texture_{i}.npy"), tex)
    return os.path.join(directory, "texture_*.npy")


def synthetic_argv(texture_glob: str, out_dir: str, steps: int,
                   *extra) -> list:
    """The train twin's command line of the synthetic phases: its defaults
    (bfloat16, lr_backbone 1e-4, dropout 0, device_warp, 8 workers, batch
    24) from the flagship, with the texture pool of the recipe."""
    return ["--steps", str(steps), "--valid_iter", str(SYNTH_VALID_ITER),
            "--init_weights", FLAGSHIP, "--proc_textures", "64", "--tex_aug",
            "--textures", texture_glob, "--out", out_dir, *extra]


def phase_synthetic_loader(mods, train_ds) -> dict:
    """The loader alone: ``SYNTH_LOADER_BATCHES`` batches of the train
    twin's dataset through ``PrefetchLoader`` with its 8 workers, one
    worker's time a sample, and a few batches in the ``image`` layout (the
    B side warped on the host, a uint8 canvas)."""
    batch = SYNTH_BATCH
    timer = mods.PhaseTimer()
    for i in range(batch):  # before any pool runs
        with timer.phase("one sample, one thread (crop layout)"):
            train_ds[i]
    t0 = time.perf_counter()
    loader = iter(mods.PrefetchLoader(train_ds, batch, num_workers=8,
                                      seed=1))
    for _ in range(SYNTH_LOADER_BATCHES):
        with timer.phase("batch (crop layout)"):
            out = next(loader)
    wall = time.perf_counter() - t0
    loader.close()
    if out["crop"].shape != (batch, 256, 256, 3) or \
            out["queries"].shape != (batch, 2 * train_ds.num_kp, 2):
        raise AssertionError(f"[synthetic-loader] batch shapes "
                             f"{ {k: v.shape for k, v in out.items()} }")
    image_ds = copy.copy(train_ds)
    image_ds.device_warp = False
    t1 = time.perf_counter()
    loader = iter(mods.PrefetchLoader(image_ds, batch, num_workers=8,
                                      seed=1))
    for _ in range(SYNTH_IMAGE_BATCHES):
        with timer.phase("batch (image layout)"):
            img_out = next(loader)
    image_wall = time.perf_counter() - t1
    loader.close()
    if img_out["image"].shape != (batch, 256, 512, 3) or \
            img_out["image"].dtype != np.uint8:
        raise AssertionError(f"[synthetic-loader] image layout "
                             f"{img_out['image'].shape} "
                             f"{img_out['image'].dtype}")
    per_sample = timer.totals["one sample, one thread (crop layout)"] / batch
    record = dict(
        cpu_count=os.cpu_count(), workers=8, batch=batch,
        textures=len(train_ds.images),
        batches=SYNTH_LOADER_BATCHES,
        samples_per_s=SYNTH_LOADER_BATCHES * batch / wall, wall_s=wall,
        ms_per_sample_one_thread=per_sample * 1e3,
        image_layout=dict(batches=SYNTH_IMAGE_BATCHES,
                          samples_per_s=SYNTH_IMAGE_BATCHES * batch
                          / image_wall, wall_s=image_wall),
        timer=timer.report())
    log(f"[synthetic-loader] os.cpu_count() {os.cpu_count()}, 8 worker "
        f"threads, {len(train_ds.images)} textures: {SYNTH_LOADER_BATCHES} "
        f"batches of {batch} in {wall:.2f} s, "
        f"{record['samples_per_s']:.1f} samples/s (crop layout); one "
        f"sample on one thread {per_sample * 1e3:.2f} ms; image layout "
        f"{SYNTH_IMAGE_BATCHES} batches, "
        f"{record['image_layout']['samples_per_s']:.1f} samples/s")
    for line in timer.report().splitlines():
        log(f"[synthetic-loader] {line}")
    return record


class TimedLoader:
    """A loader factory whose waits (the time the training loop spends in
    ``next``) are kept batch by batch: ``waits`` in order, and apart from
    them the wait for each pass's first batch (the loader's start-up), so
    that start-up and the steady supply can be told apart."""

    def __init__(self, factory):
        self.factory = factory
        self.waits = []
        self.first_wait_s = 0.0

    @property
    def wait_s(self) -> float:
        return sum(self.waits)

    @property
    def batches(self) -> int:
        return len(self.waits)

    def __call__(self):
        it = iter(self.factory())
        first = True
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                wait = time.perf_counter() - t0
                if first:
                    self.first_wait_s += wait
                    first = False
                self.waits.append(wait)
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()


class TrainSpy:
    """Installed over a Trainer: a CUDA event before each train step (its
    loss kept on the card), the kernel launches inside the steps, and the
    wall time, launches by shape and batches of every validation, and the
    wall time of every checkpoint write."""

    def __init__(self, attention, trainer):
        self.attention = attention
        self.trainer = trainer
        self.step_fn = trainer._train_step
        self.validate_fn = trainer.validate
        self.save_fn = trainer.save_checkpoint
        self.losses, self.events = [], []
        self.first_step = None
        self.step_launches = 0
        self.validations, self.checkpoint_s = [], []
        trainer._train_step = self.step
        trainer.validate = self.validate
        trainer.save_checkpoint = self.save

    def step(self, state, batch, generator):
        if self.first_step is None:
            self.first_step = state.step
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)
        before = self.attention.launches
        state, metrics = self.step_fn(state, batch, generator)
        self.step_launches += self.attention.launches - before
        self.losses.append(metrics["loss"])
        return state, metrics

    def validate(self):
        torch.cuda.synchronize()
        before = dict(self.attention.shape_counts)
        t0 = time.perf_counter()
        val = self.validate_fn()
        torch.cuda.synchronize()
        by_shape = {k: n - before.get(k, 0)
                    for k, n in self.attention.shape_counts.items()
                    if n - before.get(k, 0)}
        self.validations.append(dict(
            wall_s=time.perf_counter() - t0, val_loss=val,
            shape_counts=[dict(b=b, lq=lq, s=s, dtype=dt, launches=n)
                          for (b, lq, s, dt), n in sorted(by_shape.items())]))
        return val

    def save(self, tag: str = "checkpoint"):
        t0 = time.perf_counter()
        self.save_fn(tag)
        self.checkpoint_s.append(time.perf_counter() - t0)

    def finish(self) -> tuple:
        """(losses, ms of every step from its start to the next one's)."""
        last = torch.cuda.Event(enable_timing=True)
        last.record()
        torch.cuda.synchronize()
        marks = self.events + [last]
        return ([float(x) for x in self.losses],
                [a.elapsed_time(b) for a, b in zip(marks, marks[1:])])


def run_train_twin(attention, train_twin, args, train_ds, val_ds,
                   tag: str) -> dict:
    """The train twin's ``train_and_report`` on a trainer built by its own
    functions, with the spies installed and the counts set to 0 before."""
    trainer = train_twin.build_trainer(args, train_ds, val_ds,
                                       device="cuda")
    loader = TimedLoader(trainer.train_loader)
    trainer.train_loader = loader
    spy = TrainSpy(attention, trainer)
    sample = train_twin.heldout_sample(val_ds, args.batch_size)
    torch.cuda.reset_peak_memory_stats()
    with counted(attention, {}) as record:
        result = train_twin.train_and_report(args, trainer, sample)
    losses, ms = spy.finish()
    steady = ms[TRAIN_WARMUP_STEPS:]
    record.update(
        first_step=spy.first_step, last_step=result["step"],
        steps=len(losses), losses=losses,
        ms_per_step=statistics.median(steady) if steady else float("nan"),
        ms_per_step_mean=float(np.mean(steady)) if steady else float("nan"),
        loader_wait_s=loader.wait_s, loader_batches=loader.batches,
        loader_wait_share=loader.wait_s / record["wall_s"],
        loader_first_batch_s=loader.first_wait_s,
        step_launches=spy.step_launches, validations=spy.validations,
        checkpoint_write_s=spy.checkpoint_s,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        heldout_before_px=list(result["before_px"]),
        heldout_after_px=list(result["after_px"]))
    first, last = losses[:10], losses[-10:]
    log(f"[{tag}] steps {spy.first_step} -> {result['step']} in "
        f"{record['wall_s']:.1f} s wall: {record['ms_per_step']:.1f} ms a "
        f"step (median of the steady ones, loader wait and upload "
        f"included; mean {record['ms_per_step_mean']:.1f}), loop waiting "
        f"on the loader {loader.wait_s:.2f} s "
        f"({record['loader_wait_share']:.1%} of the wall; "
        f"{loader.first_wait_s:.2f} s of it for the first batch), peak memory "
        f"{record['peak_memory_gb']:.2f} GB, kernel launches in the steps "
        f"{spy.step_launches}")
    log(f"[{tag}] loss, first {len(first)} steps "
        f"{np.round(first, 5).tolist()}; last {len(last)} "
        f"{np.round(last, 5).tolist()}")
    for i, v in enumerate(spy.validations):
        log(f"[{tag}] validation {i}: {v['wall_s'] * 1e3:.1f} ms wall, "
            f"val_loss {v['val_loss']:.6f}, launches "
            + ", ".join(f"({r['b']}, {r['lq']}) {r['dtype']} {r['launches']}"
                        for r in v["shape_counts"]))
    log(f"[{tag}] checkpoint writes "
        f"{[round(t * 1e3, 1) for t in spy.checkpoint_s]} ms; held-out "
        f"error before {np.round(result['before_px'], 2).tolist()} px, "
        f"after {np.round(result['after_px'], 2).tolist()} px (mean, "
        f"median)")
    if not np.isfinite(losses).all():
        raise AssertionError(f"[{tag}] a loss is not finite")
    if spy.step_launches != 0:
        raise AssertionError(f"[{tag}] the train steps launched the "
                             f"forward-only kernel {spy.step_launches} times")
    n_val = len(val_ds) // args.batch_size
    want = {(args.batch_size, 512): args.enc_layers * n_val,
            (args.batch_size, 2 * args.num_kp): args.dec_layers * n_val}
    for v in spy.validations:
        got = {(r["b"], r["lq"]): r["launches"] for r in v["shape_counts"]}
        if got != want:
            raise AssertionError(f"[{tag}] a validation launched {got}, "
                                 f"expected {want}")
    return record


def phase_synthetic_train(attention, train_twin, texture_glob, out_dir,
                          datasets) -> dict:
    """The train twin from its loader: ``SYNTH_STEPS`` steps with a
    validation every ``SYNTH_VALID_ITER``, then ``--resume`` to
    ``SYNTH_RESUME_STEPS`` from the rolling checkpoint."""
    args = train_twin.parse_args(synthetic_argv(texture_glob, out_dir,
                                                SYNTH_STEPS))
    train_ds, val_ds = datasets
    main_run = run_train_twin(attention, train_twin, args, train_ds, val_ds,
                              "synthetic-train")
    if not (main_run["first_step"] == 0
            and main_run["last_step"] == SYNTH_STEPS
            and len(main_run["validations"]) == SYNTH_STEPS
            // SYNTH_VALID_ITER):
        raise AssertionError(f"[synthetic-train] steps "
                             f"{main_run['first_step']} -> "
                             f"{main_run['last_step']}, "
                             f"{len(main_run['validations'])} validations")
    resume_args = train_twin.parse_args(synthetic_argv(
        texture_glob, out_dir, SYNTH_RESUME_STEPS, "--resume"))
    resumed = run_train_twin(attention, train_twin, resume_args, train_ds,
                             val_ds, "synthetic-train, --resume")
    if not (resumed["first_step"] == SYNTH_STEPS
            and resumed["last_step"] == SYNTH_RESUME_STEPS):
        raise AssertionError(f"[synthetic-train] the resumed run took steps "
                             f"{resumed['first_step']} -> "
                             f"{resumed['last_step']}, expected "
                             f"{SYNTH_STEPS} -> {SYNTH_RESUME_STEPS}")
    steps_only = dict(launches=main_run["step_launches"]
                      + resumed["step_launches"], shape_counts=[])
    validation = dict(launches=sum(r["launches"] for v in
                                   main_run["validations"]
                                   for r in v["shape_counts"]),
                      shape_counts=merged_shape_counts(
                          main_run["validations"]))
    return dict(main=main_run, resumed=resumed, steps_only=steps_only,
                validation=validation)


def phase_synthetic_eval(attention, eval_twin, zoom_ladder) -> dict:
    """The eval twin on a generated 512 x 512 image: seeds 0, 1, 2, a 12 x 12
    grid, ``max_load`` 256, zoom depth 4, the flagship through
    ``load_params``; in bfloat16 (the tool's default) and float32."""
    rng = np.random.RandomState(13)
    img_a = eval_twin.center_crop(procedural_texture(rng, 560, 600), 512)
    rep = procedural_texture(rng, 300, 400)
    zooms = zoom_ladder(4)
    seeds = [0, 1, 2]
    out = {}
    for dtype in ("bfloat16", "float32"):
        engine = eval_twin.build_engine(FLAGSHIP, dtype, max_load=256,
                                        device="cuda")
        with counted(attention, {}) as record:
            stats = eval_twin.evaluate(engine, img_a, seeds, 0.15, 12, zooms,
                                       1, "generated 512x512")
            overlay, corner_err = eval_twin.paint_overlay(
                engine, img_a, rep, seeds[0], 0.15, zooms)
        expected = sum(len(eval_twin.query_grid(
            512, 12, eval_twin.homography_for_seed(512, seed, 0.15))[0])
            for seed in seeds)
        variants = kernel_variants(attention, record)
        record.update(stats=stats, corner_epe_px=corner_err.tolist(),
                      launches_by_kernel=variants, queries_expected=expected)
        log(f"[synthetic-eval] {dtype}: {json.dumps(stats)}")
        log(f"[synthetic-eval] {dtype}: painted overlay corner errors "
            f"{np.round(corner_err, 2).tolist()} px; "
            f"{record['wall_s']:.2f} s wall for 3 seeds and the overlay; "
            f"launches by kernel {variants}")
        log_counts("synthetic-eval", record)
        if not (stats["queries"] == expected
                and all(np.isfinite(v) for k, v in stats.items()
                        if k.startswith(("epe", "pck")))
                and np.isfinite(corner_err).all()
                and overlay.shape == (512, 512, 3)):
            raise AssertionError(f"[synthetic-eval] {dtype}: "
                                 f"{stats['queries']} answers for {expected} "
                                 f"queries, or a non-finite one")
        if variants.get("tile", 0) < 1:
            raise AssertionError("[synthetic-eval] the tile kernel was not "
                                 "launched")
        out[dtype] = record
        del engine
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- the MegaDepth path

def megadepth_argv(config: str, out_dir: str, *extra) -> list:
    """The train twin's command line of ``[megadepth-train]``: its defaults
    (float32, batch 24, 100 correspondences both ways, dropout 0.1, half the
    host's cores as loader workers) from the flagship."""
    return ["--dataset_config", config, "--confirm", "no",
            "--load_weights_path", FLAGSHIP, "--max_iter", str(MD_STEPS),
            "--valid_iter", str(MD_VALID_ITER), "--out_dir", out_dir, *extra]


def phase_megadepth_data(md, config: str) -> tuple:
    """The native functions against their numpy paths on the scene; samples
    a second of the three datasets on one thread and through the twin's
    loader; the bytes of one batch in each layout. Returns (record, the
    last candidate-layout batch)."""
    data_cfg = md.train_twin.data_config(
        md.train_twin.build_parser().parse_args(["--dataset_config", config]))
    sdd = data_cfg.scenes_name_list[0]
    scene = md.Reader.read_sfm_scene_given_valid_list_path(
        sdd["scene_dir"], sdd["image_dir"], sdd["depth_dir"],
        data_cfg.valid_list_json, "no_crop")
    a, b = scene[0], scene[3]
    ms = {}
    t0 = time.perf_counter()
    native_rows = md.compute_corrs(a, b, impl="native")
    ms["synth_corrs_native"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    numpy_rows = md.compute_corrs(a, b, impl="numpy")
    ms["synth_corrs_numpy"] = (time.perf_counter() - t0) * 1e3
    corrs_equal = np.array_equal(native_rows, numpy_rows.astype(np.float32))
    counts_equal = all(md.native.count_valid_depth(cap.depth_map)
                       == np.count_nonzero(cap.depth_map > 0)
                       for cap in scene.captures)
    images_txt = os.path.join(sdd["scene_dir"], "images.txt")
    t0 = time.perf_counter()
    ids, _, qt, names = md.native.parse_images_txt(images_txt)
    ms["parse_images_txt_native"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    metas = md.read_images_meta(images_txt, sdd["image_dir"])
    ms["parse_images_txt_python"] = (time.perf_counter() - t0) * 1e3
    parse_equal = (list(ids) == list(metas) and all(
        np.array_equal(m.t.translation_vector, row[4:].astype(np.float32))
        and m.image_path == os.path.join(sdd["image_dir"], name)
        for m, row, name in zip(metas.values(), qt, names)))
    log(f"[megadepth-data] {len(scene)} views of "
        f"{a.image.shape[0]}x{a.image.shape[1]}: "
        f"synth_corrs of a full-frame pair, {len(native_rows)} rows: native "
        f"{ms['synth_corrs_native']:.1f} ms, numpy "
        f"{ms['synth_corrs_numpy']:.1f} ms, equal (numpy rounded to "
        f"float32): {corrs_equal}; count_valid_depth equal on every view: "
        f"{counts_equal}; parse_images_txt native "
        f"{ms['parse_images_txt_native']:.2f} ms, Python "
        f"{ms['parse_images_txt_python']:.2f} ms, equal: {parse_equal}")
    if not (corrs_equal and counts_equal and parse_equal
            and len(native_rows) > 1000):
        raise AssertionError("[megadepth-data] a native function differs "
                             "from its numpy path")

    workers = max((os.cpu_count() or 2) // 2, 2)
    datasets = {
        "host": md.CotrDataset(data_cfg, "train", seed=0),
        "device_synth": md.CotrDataset(data_cfg, "train", seed=0,
                                       device_synth=True),
        "zoom": md.CotrZoomDataset(dataclasses.replace(
            data_cfg, crop_cam="no_crop"), "train", seed=0)}
    layouts, last = {}, {}
    for name, ds in datasets.items():
        t0 = time.perf_counter()
        for i in range(MD_ONE_THREAD_SAMPLES):
            ds[i % len(ds)]
        one = (time.perf_counter() - t0) / MD_ONE_THREAD_SAMPLES
        loader = md.PrefetchLoader(ds, SYNTH_BATCH, num_workers=workers,
                                   seed=0)
        waits = []
        t0 = time.perf_counter()
        while len(waits) < MD_LOADER_BATCHES:  # epochs of len(ds) // 24
            it = iter(loader)
            while len(waits) < MD_LOADER_BATCHES:
                t1 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    break
                waits.append(time.perf_counter() - t1)
                last[name] = batch
            it.close()
        wall = time.perf_counter() - t0
        layouts[name] = dict(
            ms_per_sample_one_thread=one * 1e3,
            samples_per_s_loader=MD_LOADER_BATCHES * SYNTH_BATCH / wall,
            loader_workers=workers, loader_waits_s=waits,
            batch_bytes=int(sum(v.nbytes for v in last[name].values())),
            batch_shapes={k: [list(v.shape), str(v.dtype)]
                          for k, v in last[name].items()})
        log(f"[megadepth-data] {name}: one thread {one * 1e3:.1f} ms a "
            f"sample ({1.0 / one:.1f} samples/s); PrefetchLoader, {workers} "
            f"workers, {len(ds)} queries an epoch: {MD_LOADER_BATCHES} "
            f"batches of {SYNTH_BATCH} in {wall:.2f} s, "
            f"{layouts[name]['samples_per_s_loader']:.1f} samples/s (waits "
            f"{np.round(waits, 3).tolist()} s); one batch "
            f"{layouts[name]['batch_bytes'] / 1e6:.2f} MB")
    record = dict(views=len(scene), synth_corrs_rows=len(native_rows),
                  ms=ms, layouts=layouts)
    return record, last["device_synth"]


def phase_device_synth(attention, md, mods, cand_batch: dict,
                       out_dir: str) -> dict:
    """One candidate batch of 24 synthesized on the card and on the CPU
    from the same scores; then train steps on it from the flagship's
    backbone, the steady ones under the sync debug mode."""
    num_kp = mods.TrainConfig().num_kp
    card = {k: md.upload(v, "cuda") for k, v in cand_batch.items()}
    host = {k: md.upload(v, "cpu") for k, v in cand_batch.items()}
    scores = torch.rand(host["cand"].shape[:2],
                        generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = md.synth_supervision_batch(card, num_kp, scores=scores.cuda())
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = md.synth_supervision_batch(host, num_kp, scores=scores)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    uv, z_proj, zd, valid = (t.cpu() for t in md.project_candidates(card))
    uv_h, z_proj_h, zd_h, valid_h = md.project_candidates(host)
    h, w = host["qdepth"].shape[1:]
    edge = (((zd_h - z_proj_h).abs() - 0.5).abs() < SYNTH_EDGE)
    for coord, hi in ((uv_h[..., 0], w - 1), (uv_h[..., 1], h - 1)):
        edge |= (coord.abs() < SYNTH_EDGE) | ((coord - hi).abs() < SYNTH_EDGE)
    flipped = valid != valid_h
    unexplained = int((flipped & ~edge).sum())
    same = ~flipped.any(dim=1)  # samples whose picks must then agree
    canvas_equal = torch.equal(got[0].cpu(), want[0])
    px = torch.tensor([2.0 * 256, 256.0])
    err = max(float(((got[i].cpu() - want[i])[same] * px).abs().max())
              for i in (1, 2))
    weights_equal = torch.equal(got[3].cpu()[same], want[3][same])
    record = dict(candidates=int(valid_h.numel()),
                  valid=int(valid_h.sum()), edge=int(edge.sum()),
                  flipped=int(flipped.sum()), unexplained=unexplained,
                  samples_compared=int(same.sum()), max_px_err=err,
                  weights_equal=weights_equal, canvas_equal=canvas_equal,
                  card_ms=card_ms, cpu_ms=cpu_ms,
                  weight_mean=float(want[3].mean()))
    log(f"[device-synth] batch {valid_h.shape[0]}, {valid_h.shape[1]} "
        f"candidates a sample, {record['valid']} of {record['candidates']} "
        f"valid: card vs CPU, same scores: {record['flipped']} validity "
        f"flips, {record['edge']} candidates within {SYNTH_EDGE} of an edge, "
        f"{unexplained} flips away from one; on the "
        f"{record['samples_compared']} samples without a flip: corrs max "
        f"err {err:.2e} px (tol {SYNTH_PX_TOL}), weights equal "
        f"{weights_equal}; canvas equal {canvas_equal}; mean weight "
        f"{record['weight_mean']:.3f}; one call {card_ms:.2f} ms on the card "
        f"(first), {cpu_ms:.2f} ms on the CPU")
    if not (unexplained == 0 and err <= SYNTH_PX_TOL and weights_equal
            and canvas_equal and record["samples_compared"] > 0):
        raise AssertionError("[device-synth] the card disagrees with the CPU")

    trainer = make_trainer(mods, mods.COTRConfig(),
                           mods.TrainConfig(valid_iter=10 ** 9), card,
                           out_dir)
    run = run_steps(attention, trainer, MD_SYNTH_STEPS,
                    "device-synth, train steps on the candidate batch")
    record["train"] = run
    del trainer
    torch.cuda.empty_cache()
    return record


class TimedUpload:
    """Installed over a Trainer's ``_batch``: the time of each upload. A
    copy from pageable memory waits for the work queued before it on the
    card and holds the host until it is done, so the card is drained first
    and the clock then reads the copy alone."""

    def __init__(self, trainer):
        self.fn = trainer._batch
        self.seconds = []
        trainer._batch = self

    def __call__(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(batch)
        self.seconds.append(time.perf_counter() - t0)
        return out


def run_cotr_twin(attention, md, argv: list, tag: str) -> dict:
    """The train twin's trainer, built by its own functions from ``argv``,
    trained with the spies installed and the counts set to 0 before."""
    args = md.train_twin.build_parser().parse_args(argv)
    run_dir = md.train_twin.run_dir_of(args)
    train_ds, val_ds = md.train_twin.build_datasets(args)
    trainer = md.train_twin.build_trainer(args, train_ds, val_ds, run_dir,
                                          device="cuda")
    loader = TimedLoader(trainer.train_loader)
    trainer.train_loader = loader
    upload = TimedUpload(trainer)
    spy = TrainSpy(attention, trainer)
    torch.cuda.reset_peak_memory_stats()
    with counted(attention, {}) as record:
        trainer.train()
    losses, ms = spy.finish()
    steady = ms[MD_STEADY_FROM:]
    n_steps = len(losses)
    record.update(
        steps=n_steps, losses=losses,
        ms_per_step=statistics.median(steady),
        loader_wait_s=loader.wait_s, loader_first_batch_s=loader.first_wait_s,
        loader_wait_share=loader.wait_s / record["wall_s"],
        loader_waits_s=loader.waits,
        upload_ms=statistics.median(upload.seconds[:n_steps]) * 1e3,
        step_launches=spy.step_launches, validations=spy.validations,
        checkpoint_write_s=spy.checkpoint_s,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        train_queries=len(train_ds), val_queries=len(val_ds))
    log(f"[{tag}] {n_steps} steps in {record['wall_s']:.1f} s wall: "
        f"{record['ms_per_step']:.1f} ms a step (median after the first "
        f"{MD_STEADY_FROM}; loader wait and upload included), loop waiting "
        f"on the loader {loader.wait_s:.2f} s ({record['loader_wait_share']:.1%}"
        f" of the wall; {loader.first_wait_s:.2f} s of it for each pass's "
        f"first batch, a pass being {len(train_ds) // args.batch_size} "
        f"batches), upload {record['upload_ms']:.2f} ms a step (host), peak "
        f"memory {record['peak_memory_gb']:.2f} GB, kernel launches in the "
        f"steps {spy.step_launches}")
    log(f"[{tag}] losses {np.round(losses, 5).tolist()}")
    for i, v in enumerate(spy.validations):
        log(f"[{tag}] validation {i}: {v['wall_s'] * 1e3:.1f} ms wall, "
            f"val_loss {v['val_loss']:.6f}, launches "
            + ", ".join(f"({r['b']}, {r['lq']}) {r['dtype']} {r['launches']}"
                        for r in v["shape_counts"]))
    if n_steps != MD_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"[{tag}] {n_steps} steps, or a loss is not "
                             f"finite")
    if spy.step_launches != 0:
        raise AssertionError(f"[{tag}] the train steps launched the "
                             f"forward-only kernel {spy.step_launches} times")
    n_val = len(val_ds) // args.batch_size
    want = {(args.batch_size, 512): args.enc_layers * n_val,
            (args.batch_size, 2 * args.num_kp): args.dec_layers * n_val}
    if len(spy.validations) != MD_STEPS // MD_VALID_ITER or n_val < 1:
        raise AssertionError(f"[{tag}] {len(spy.validations)} validations "
                             f"of {n_val} batches")
    for v in spy.validations:
        got = {(r["b"], r["lq"]): r["launches"] for r in v["shape_counts"]}
        if got != want or not np.isfinite(v["val_loss"]):
            raise AssertionError(f"[{tag}] a validation launched {got}, "
                                 f"expected {want}, val_loss "
                                 f"{v['val_loss']}")
    del trainer
    torch.cuda.empty_cache()
    return record


def phase_megadepth_train(attention, md, config: str, out_dir: str) -> dict:
    """The train twin from the flagship: the host layout, then
    ``--device_synth yes`` in a fresh out_dir."""
    host = run_cotr_twin(attention, md, megadepth_argv(
        config, os.path.join(out_dir, "md_host")), "megadepth-train, host")
    cand = run_cotr_twin(attention, md, megadepth_argv(
        config, os.path.join(out_dir, "md_cand"), "--device_synth", "yes"),
        "megadepth-train, device_synth")
    return dict(host=host, device_synth=cand,
                steps_only=dict(launches=host["step_launches"]
                                + cand["step_launches"], shape_counts=[]),
                validation=dict(
                    launches=sum(r["launches"] for run in (host, cand)
                                 for v in run["validations"]
                                 for r in v["shape_counts"]),
                    shape_counts=merged_shape_counts(
                        host["validations"] + cand["validations"])))


def phase_megadepth_eval(attention, md, config: str, out_dir: str) -> dict:
    """The eval twin's sweep, bfloat16, from the flagship: 4 pairs at a
    32 x 32 grid through ``FasterSparseEngine``, then 1 pair at 16 x 16
    through ``SparseEngine``."""
    runs = {}
    for name, extra, kernel in (
            ("faster", ["--pairs", str(MD_EVAL_PAIRS), "--grid", "32",
                        "--pair_batch", str(MD_EVAL_PAIRS)], "tile"),
            ("sparse", ["--pairs", "1", "--grid", "16",
                        "--faster_infer", "no"], "row")):
        args = md.eval_twin.parse_args(
            ["--dataset_config", config, "--load_weights_path", FLAGSHIP,
             "--dtype", "bfloat16", "--zoom_depth", "3",
             "--out", os.path.join(out_dir, f"eval_{name}.json"), *extra])
        ds = md.MegadepthDataset(md.eval_twin.data_config(config), "val")
        engine = md.eval_twin.build_engine(args, device="cuda")
        with counted(attention, {}) as record:
            result, all_epe = md.eval_twin.evaluate(
                engine, ds, args.pairs, args.grid,
                md.zoom_ladder(args.zoom_depth), args.pair_batch)
        variants = kernel_variants(attention, record)
        record.update(result=result, launches_by_kernel=variants,
                      per_pair_epe=[dict(valid=len(e),
                                         mean=float(np.mean(e)),
                                         median=float(np.median(e)))
                                    for e in all_epe])
        log(f"[megadepth-eval] {name}: {json.dumps(result)}; "
            f"{record['wall_s']:.2f} s wall; launches by kernel {variants}")
        log_counts("megadepth-eval", record)
        if not (len(all_epe) == args.pairs
                and all(len(e) >= 10 and np.isfinite(e).all()
                        for e in all_epe)):
            raise AssertionError(f"[megadepth-eval] {name}: "
                                 f"{len(all_epe)} pairs evaluated of "
                                 f"{args.pairs}, or a non-finite EPE")
        if variants.get(kernel, 0) < 1:
            raise AssertionError(f"[megadepth-eval] {name}: the {kernel} "
                                 f"kernel was not launched")
        runs[name] = record
        del engine
        torch.cuda.empty_cache()
    return runs


# ------------------------------------ the demos and the checkpoint tools

def file_digest(path: str) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def phase_convert(attention, mods, trainer_ckpt: str, out_dir: str) -> dict:
    """The flagship written in the reference's ``.pth.tar`` layout, through
    the convert twin with ``--verify``; one forward served from the
    ``.npz`` it wrote, against the flagship's; then the publish twin from
    the training phase's ``Trainer`` checkpoint into ``out_dir``."""
    from cotr_tpu_torch.models.torch_convert import port_to_torch_state_dict
    from cotr_tpu_torch.tools import convert_checkpoint, publish_flagship

    cfg = mods.COTRConfig()
    pth = os.path.join(out_dir, "flagship.pth.tar")
    torch.save({"model_state_dict": port_to_torch_state_dict(
        mods.params_from_flax(mods.load_flagship(FLAGSHIP)), cfg)}, pth)
    npz = os.path.join(out_dir, "converted.npz")
    canvas, queries = convert_checkpoint.verify_inputs()
    served = {}
    with counted(attention, {}) as record:
        converted = convert_checkpoint.main(
            ["--torch", pth, "--out", npz, "--verify"], device="cuda")
        for name, path in (("flagship", FLAGSHIP), ("converted", npz)):
            runner = mods.ModelRunner(mods.load_model(path, cfg,
                                                      device="cuda"),
                                      device="cuda")
            served[name] = runner.forward(canvas, queries).cpu().numpy()
    exact = np.array_equal(served["flagship"], served["converted"])
    log(f"[convert] {converted['parameters']:,} parameters, .pth.tar -> "
        f"float32 .npz ({os.path.getsize(npz) / 1e6:.1f} MB); --verify max "
        f"deviation {converted['max_abs_dev']:.1e}; the .npz served on the "
        f"card equals the flagship's forward: {exact}; "
        f"{record['wall_s']:.2f} s wall")
    log_counts("convert", record)
    if not (exact and converted["max_abs_dev"] == 0.0
            and np.isfinite(served["converted"]).all()):
        raise AssertionError("[convert] the round trip is not exact")

    published = os.path.join(out_dir, "published", "flagship.npz")
    t0 = time.perf_counter()
    meta = publish_flagship.main(["--ckpt", trainer_ckpt, "--out", published,
                                  "--note", "chip_smoke training phase"])
    publish_s = time.perf_counter() - t0
    trained = mods.load_params(trainer_ckpt)
    back = mods.load_params(published)
    worst = max(float(((back[k] - v.float()).abs()
                       / v.float().abs().clamp(min=1e-30)).max())
                for k, v in trained.items() if v.is_floating_point())
    log(f"[convert] publish_flagship from the training phase's Trainer "
        f"checkpoint: {meta['size_mb']} MB bf16 .npz in {publish_s:.2f} s, "
        f"training config embedded: {'training' in meta}; weights within "
        f"{worst:.2e} of the trained ones (bf16 rounding 2**-8)")
    if not ("training" in meta and set(back) == set(trained)
            and worst <= 2.0 ** -8):
        raise AssertionError("[convert] the published weights are not the "
                             "trained ones rounded to bf16")
    record.update(parameters=converted["parameters"], served_exact=exact,
                  publish_s=publish_s, publish_size_mb=meta["size_mb"],
                  publish_max_rel_err=worst)
    return record


class DenseLog:
    """Counts the engine's dense seed passes while installed over
    ``engine.dense_flow_many`` (looked up at each call)."""

    def __init__(self, engine_mod):
        self.engine_mod = engine_mod
        self.calls = 0

    def __enter__(self):
        self.original = self.engine_mod.dense_flow_many

        def logged(*args, **kwargs):
            self.calls += 1
            return self.original(*args, **kwargs)

        self.engine_mod.dense_flow_many = logged
        return self

    def __exit__(self, *exc):
        self.engine_mod.dense_flow_many = self.original


def big_texture(rng, h: int, w: int) -> np.ndarray:
    """A photograph-sized texture: a quarter-size one upsampled 4 times."""
    return np.round(_upsample(procedural_texture(rng, h // 4, w // 4),
                              h, w)).astype(np.uint8)


def lift_depth(cap, xy: np.ndarray) -> tuple:
    """World points of the pixels ``xy`` of a capture by its depth at the
    nearest pixel: (points (N, 3), valid (N,))."""
    h, w = cap.depth_map.shape
    px = np.clip(np.rint(xy).astype(int), 0, [w - 1, h - 1])
    z = cap.depth_map[px[:, 1], px[:, 0]].astype(np.float64)
    ray = np.concatenate([xy, np.ones((len(xy), 1))], 1) @ np.linalg.inv(
        cap.pinhole_cam.intrinsic_mat).T
    cam = ray * z[:, None]
    c2w = cap.cam_pose.camera_to_world
    return cam @ c2w[:3, :3].T + c2w[:3, 3], z > 0


def phase_demos(attention, md, config: str, out_dir: str) -> dict:
    """Each demo twin's ``main`` on the card with the flagship at full width
    and its default dtype (float32), on generated inputs written as
    ``.npy``: its wall time, correspondences, launches by shape, the dense
    seed passes it ran and, where there is a ground truth, its error."""
    from cotr_tpu_torch.demos import (demo_face, demo_guided_matching,
                                      demo_homography, demo_reconstruction,
                                      demo_single_pair, demo_wbs)
    from cotr_tpu_torch.inference import engine as engine_mod

    rng = np.random.RandomState(21)
    runs = {}

    def save(name, array):
        path = os.path.join(out_dir, name)
        np.save(path, array, allow_pickle=array.dtype == object)
        return path

    def run(tag, demo, argv, sparse_engine):
        with DenseLog(engine_mod) as dense, \
                contextlib.chdir(out_dir), \
                counted(attention, {}) as record:
            result = demo.main(argv, device="cuda")
        variants = kernel_variants(attention, record)
        record.update(dense_passes=dense.calls, launches_by_kernel=variants)
        log(f"[demos] {tag}: {record['wall_s']:.2f} s wall, "
            f"{dense.calls} dense seed passes, launches by kernel "
            f"{variants}")
        log_counts("demos", record)
        if variants.get("tile", 0) < 1 or (
                sparse_engine and variants.get("row", 0) < 1):
            raise AssertionError(f"[demos] {tag}: launches by kernel "
                                 f"{variants}")
        runs[tag] = record
        return result, record

    def check(tag, corrs):
        if not (len(corrs) >= 1 and np.isfinite(corrs).all()):
            raise AssertionError(f"[demos] {tag}: {corrs.shape} or a "
                                 f"non-finite correspondence")

    # single pair with --densify: chip_smoke's 768 x 1024 pair, B a known
    # homography of A
    img_a, img_b, hmat = make_pair(rng, DEMO_HW, 4.0, 1.05, (20, -12))
    argv = ["--img_a", save("pair_a.npy", img_a),
            "--img_b", save("pair_b.npy", img_b), "--densify"]
    result, record = run("single pair --densify", demo_single_pair, argv,
                         True)
    corrs = result["corrs"]
    check("single pair", corrs)
    err = np.linalg.norm(apply_h(hmat, corrs[:, :2]) - corrs[:, 2:], axis=1)
    valid = result["dense"].any(axis=-1)
    ys, xs = np.nonzero(valid)
    flow_err = np.linalg.norm(apply_h(hmat, np.stack([xs, ys], 1).astype(
        np.float64)) - result["dense"][ys, xs], axis=1)
    warp_mad = float(np.abs(result["warped"][valid]
                            - img_a[valid].astype(np.float32)).mean())
    record.update(correspondences=len(corrs),
                  median_px=float(np.median(err)),
                  dense_valid_share=float(valid.mean()),
                  dense_median_px=float(np.median(flow_err)),
                  warp_mean_abs_diff=warp_mad)
    log(f"[demos] single pair: {len(corrs)} correspondences, median error "
        f"vs the homography {np.median(err):.2f} px; densified flow over "
        f"{valid.mean():.1%} of A, median error {np.median(flow_err):.2f} "
        f"px; B warped back onto A: mean |A - B(flow)| {warp_mad:.2f} grey "
        f"levels")
    if not (np.isfinite(result["warped"]).all() and valid.any()):
        raise AssertionError("[demos] single pair: the densified warp")

    # face: 68 fixed queries on an oval inside a non-square pair
    img_a, img_b, hmat = make_pair(rng, FACE_HW, 2.0, 1.0, (16, 10))
    t = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    fh, fw = FACE_HW
    landmarks = np.stack([fw / 2 + 0.23 * fw * np.cos(t) * (
        1 + 0.1 * np.cos(3 * t)), fh / 2 + 0.35 * fh * np.sin(t)], 1)[None]
    argv = ["--img_a", save("face_a.npy", img_a),
            "--img_b", save("face_b.npy", img_b),
            "--landmarks", save("landmarks.npy", landmarks)]
    result, record = run("face", demo_face, argv, True)
    corrs = result["corrs"]
    check("face", corrs)
    err = np.linalg.norm(apply_h(hmat, corrs[:, :2]) - corrs[:, 2:], axis=1)
    record.update(correspondences=len(corrs), queries=68,
                  median_px=float(np.median(err)))
    log(f"[demos] face: {len(corrs)} of 68 transfers kept by force=False, "
        f"median error vs the homography {np.median(err):.2f} px")

    # homography: the reference's four corners, so A has a portrait
    # photograph's size; B a known homography of it
    h, w = PAINT_HW
    img_a = big_texture(rng, h, w)
    hmat = known_homography(h, w, 3.0, 1.02, (30, -20))
    img_b = warp_homography(img_a, hmat)
    argv = ["--img_a", save("paint_a.npy", img_a),
            "--img_b", save("paint_b.npy", img_b),
            "--rep_img", save("rep.npy", procedural_texture(rng, 600, 400)),
            "--out", "overlay.png"]
    result, record = run("homography", demo_homography, argv, True)
    corrs = result["corrs"]
    check("homography", corrs)
    err = np.linalg.norm(apply_h(hmat, demo_homography.ANNOTATED_CORNERS
                                 .astype(np.float64)) - corrs[:, 2:], axis=1)
    record.update(correspondences=len(corrs), corner_px=err.tolist())
    log(f"[demos] homography on {h}x{w}: corner errors "
        f"{np.round(err, 2).tolist()} px")
    if not (len(corrs) == 4 and np.isfinite(result["warped"]).all()):
        raise AssertionError("[demos] homography: the overlay")

    # wbs: 100 annotated rows, known relative scale: no dense seed pass
    img_a, img_b, hmat = make_pair(rng, DEMO_HW, -3.0, 1.0, (-18, 9))
    pts = grid_queries(*DEMO_HW, nx=10, ny=10)
    path = os.path.join(out_dir, "wbs_pts.txt")
    np.savetxt(path, np.concatenate([pts, apply_h(hmat, pts)], 1))
    argv = ["--img_a", save("wbs_a.npy", img_a),
            "--img_b", save("wbs_b.npy", img_b), "--pts", path]
    result, record = run("wbs", demo_wbs, argv, True)
    check("wbs", result["corrs"])
    record.update(correspondences=len(result["corrs"]),
                  median_px=float(np.median(result["err"])))
    log(f"[demos] wbs: {len(result['corrs'])} correspondences, median error "
        f"vs the annotation {np.median(result['err']):.2f} px")
    if record["dense_passes"] != 0:
        raise AssertionError("[demos] wbs ran the dense seed pass")

    # guided matching and reconstruction: two overlapping views of the
    # generated scene and their cameras
    data_cfg = md.eval_twin.data_config(config)
    sdd = data_cfg.scenes_name_list[0]
    scene = md.Reader.read_sfm_scene(sdd["scene_dir"], sdd["image_dir"],
                                     sdd["depth_dir"], "no_crop")
    a, b = scene[0], scene[3]
    gt = md.compute_corrs(a, b, impl="native")
    cam_a = save("camera_a.npy", np.array(
        {"intrinsic": a.pinhole_cam.intrinsic_mat,
         "c2w": a.cam_pose.camera_to_world}, dtype=object))
    cam_b = save("camera_b.npy", np.array(
        {"intrinsic": b.pinhole_cam.intrinsic_mat,
         "W2C": b.cam_pose.world_to_camera[:3]}, dtype=object))
    sel = rng.choice(len(gt), 1000, replace=False)
    hb, wb = b.image.shape[:2]
    kpts_a = gt[sel, :2]
    kpts_b = np.concatenate([gt[sel[:800], 2:], np.stack(
        [rng.uniform(0, wb - 1, 300), rng.uniform(0, hb - 1, 300)], 1)])
    pair = ["--img_a", a.img_path, "--img_b", b.img_path]
    argv = [*pair, "--kpts_a", save("kpts_a.npy", kpts_a),
            "--kpts_b", save("kpts_b.npy", kpts_b), "--faster_infer", "yes"]
    result, record = run("guided matching", demo_guided_matching, argv,
                         False)
    matches = result["matches"]
    check("guided matching", matches)
    target = {tuple(k): t for k, t in zip(kpts_a, gt[sel, 2:])}
    err = np.linalg.norm(np.array([target[tuple(m[:2])] for m in matches])
                         - matches[:, 2:], axis=1)
    record.update(keypoints=[len(kpts_a), len(kpts_b)],
                  mutual=len(result["mutual"]), inliers=len(matches),
                  inlier_median_px=float(np.median(err)),
                  inliers_within_3px=float(np.mean(err <= 3.0)))
    log(f"[demos] guided matching: {len(kpts_a)} / {len(kpts_b)} keypoints, "
        f"{len(result['mutual'])} mutual matches, {len(matches)} RANSAC "
        f"inliers, their median error vs compute_corrs "
        f"{np.median(err):.2f} px, {np.mean(err <= 3.0):.0%} within 3 px")

    argv = [*pair, "--camera_a", cam_a, "--camera_b", cam_b,
            "--out_pcd", "reconstruction.npy", "--faster_infer", "yes"]
    result, record = run("reconstruction", demo_reconstruction, argv, False)
    check("reconstruction", result["corrs"])
    lifted, ok = lift_depth(a, result["corrs"][:, :2])
    dist = np.linalg.norm(result["points"] - lifted, axis=1)[ok]
    depth = a.depth_map[a.depth_map > 0]
    record.update(correspondences=len(result["corrs"]),
                  median_dist=float(np.median(dist)),
                  median_depth=float(np.median(depth)))
    log(f"[demos] reconstruction: {len(result['corrs'])} correspondences, "
        f"triangulated points' median distance to A's depth lifted to 3-D "
        f"{np.median(dist):.4f} (scene depth median "
        f"{np.median(depth):.2f})")
    if not (np.isfinite(result["points"]).all() and ok.any()):
        raise AssertionError("[demos] reconstruction: the point cloud")
    return runs


def phase_eval_suite(attention, out_dir: str) -> dict:
    """The eval-suite twin at its defaults (bfloat16, 5 seeds, a 15 x 15
    grid) on 4 generated images in place of the absent real ones plus 4
    procedural textures; then the diagnose-tail twin at its defaults on the
    same images."""
    from cotr_tpu_torch.tools import diagnose_tail, eval_suite
    from cotr_tpu_torch.tools import eval_synthetic_pair as eval_twin

    rng = np.random.RandomState(22)
    paths = []
    for i, hw in enumerate([(600, 800), (480, 640), (720, 540),
                            (400, 560)]):
        paths.append(os.path.join(out_dir, f"eval_{i}.npy"))
        np.save(paths[-1], procedural_texture(rng, *hw))
    out = {}
    for tag, tool, extra in (
            ("eval-suite", eval_suite, ["--proc", "4", "--seeds",
                                        SUITE_SEEDS]),
            ("diagnose-tail", diagnose_tail, [])):
        argv = ["--ckpt", FLAGSHIP, "--textures", *paths,
                "--out", os.path.join(out_dir, tag), *extra]
        with counted(attention, {}) as record:
            stats = tool.main(argv, device="cuda")
        variants = kernel_variants(attention, record)
        record.update(result=stats, launches_by_kernel=variants)
        log(f"[eval-suite] {tag}: {json.dumps(stats.get('pooled'))}; "
            f"{record['wall_s']:.2f} s wall; launches by kernel {variants}")
        log_counts("eval-suite", record)
        if variants.get("tile", 0) < 1:
            raise AssertionError(f"[eval-suite] {tag}: the tile kernel was "
                                 f"not launched")
        out[tag] = record
    suite = out["eval-suite"]["result"]
    tail = out["diagnose-tail"]["result"]
    log(f"[eval-suite] {len(suite['textures'])} textures x "
        f"{len(suite['seeds'])} seeds, {suite['queries_total']} queries: "
        f"median {suite['pooled']['epe_median_px']} px (95% CI "
        f"{suite['epe_median_px_ci95']}), PCK@5px "
        f"{suite['pooled']['pck@5px']} (CI {suite['pck@5px_ci95']}); "
        f"diagnose-tail over {tail['queries']} queries: tail shares "
        f"{tail['tail_class_shares']}")
    seeds = [int(x) for x in SUITE_SEEDS.split(",")]
    expected = len(paths + ["proc"] * 4) * sum(len(eval_twin.query_grid(
        512, 15, eval_twin.homography_for_seed(512, seed, 0.15))[0])
        for seed in seeds)
    if not (suite["queries_total"] == expected
            and all(np.isfinite(v) for v in suite["pooled"].values())
            and np.isfinite(tail["pooled"]["median"])):
        raise AssertionError(f"[eval-suite] {suite['queries_total']} answers "
                             f"for {expected} queries, or a non-finite one")
    return out


def merged_shape_counts(records) -> list:
    total = {}
    for record in records:
        for row in record["shape_counts"]:
            key = (row["b"], row["lq"], row["s"], row["dtype"])
            total[key] = total.get(key, 0) + row["launches"]
    return [dict(b=b, lq=lq, s=s, dtype=dtype, launches=n)
            for (b, lq, s, dtype), n in sorted(total.items())]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cotr_tpu_torch import native
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.inference import grouped
    from cotr_tpu_torch.inference.engine import (FasterSparseEngine,
                                                 SparseEngine)
    from cotr_tpu_torch.inference.runner import ModelRunner
    from cotr_tpu_torch.config import TrainConfig
    from cotr_tpu_torch.models import checkpoint_io
    from cotr_tpu_torch.models.checkpoint_io import load_model
    from cotr_tpu_torch.models.cotr import build_model
    from cotr_tpu_torch.ops import attention, sampling
    from cotr_tpu_torch.training import loss as loss_mod
    from cotr_tpu_torch.training import train_step as train_step_mod
    from cotr_tpu_torch.training.trainer import Trainer
    from cotr_tpu_torch.data.loader import PrefetchLoader
    from cotr_tpu_torch.tools import eval_synthetic_pair as eval_twin
    from cotr_tpu_torch.tools import train_synthetic as train_twin
    from cotr_tpu_torch.utils.constants import zoom_ladder
    from cotr_tpu_torch.utils.profiling import PhaseTimer

    # the entry points the training phases call
    mods = types.SimpleNamespace(
        COTRConfig=COTRConfig, TrainConfig=TrainConfig, Trainer=Trainer,
        build_model=build_model, load_model=load_model,
        ModelRunner=ModelRunner, SparseEngine=SparseEngine,
        params_from_flax=checkpoint_io.params_from_flax,
        load_params=checkpoint_io.load_params,
        load_flagship=checkpoint_io.load_flagship,
        save_params_npz=checkpoint_io.save_params_npz,
        make_eval_step=train_step_mod.make_eval_step,
        PrefetchLoader=PrefetchLoader, PhaseTimer=PhaseTimer)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    flagship_digest = file_digest(FLAGSHIP)
    card = phase_card()
    build = phase_build(attention, native, grouped)
    rows = phase_kernel(attention)
    crops = phase_crops(sampling)
    forward = phase_forward(load_model, COTRConfig)
    runner = ModelRunner(load_model(FLAGSHIP, COTRConfig(), device="cuda"),
                         device="cuda")
    serve, big_pair = phase_serve(attention, SparseEngine, runner)
    squad = phase_grouped(attention, grouped, FasterSparseEngine,
                          SparseEngine, runner, big_pair)
    multipair = phase_multipair(attention, grouped, FasterSparseEngine,
                                runner)
    del runner
    torch.cuda.empty_cache()
    train_parity = phase_train_parity(load_model, COTRConfig(), loss_mod,
                                      train_step_mod, TrainConfig())
    batch = on_card(make_train_batch(np.random.RandomState(7), 24,
                                     TrainConfig().num_kp))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, "build")) as out_dir:
        trainer, train = phase_train(attention, mods, batch, out_dir)
        eval_step = phase_eval_step(attention, mods, trainer, batch)
        checkpoint = phase_checkpoint(attention, mods, trainer, batch,
                                      out_dir)
        convert = phase_convert(attention, mods, os.path.join(
            out_dir, "checkpoints", "checkpoint.pt"), out_dir)
        del trainer, batch
        torch.cuda.empty_cache()

        texture_dir = os.path.join(out_dir, "textures")
        os.makedirs(texture_dir)
        texture_glob = write_textures(texture_dir, SYNTH_TEXTURES,
                                      np.random.RandomState(12))
        synth_out = os.path.join(out_dir, "synthetic_run")
        t0 = time.perf_counter()
        datasets = train_twin.build_datasets(train_twin.parse_args(
            synthetic_argv(texture_glob, synth_out, SYNTH_STEPS)))
        dataset_s = time.perf_counter() - t0
        log(f"[synthetic-loader] the twin's datasets (train and validation, "
            f"{SYNTH_TEXTURES} .npy textures and 64 procedural ones each) "
            f"built in {dataset_s:.2f} s")
        synth_loader = phase_synthetic_loader(mods, datasets[0])
        synth_loader["datasets_s"] = dataset_s
        synth_train = phase_synthetic_train(attention, train_twin,
                                            texture_glob, synth_out,
                                            datasets)
        del datasets
    synth_eval = phase_synthetic_eval(attention, eval_twin, zoom_ladder)

    from cotr_tpu_torch.data import dataset as md_dataset
    from cotr_tpu_torch.data import device_synth
    from cotr_tpu_torch.data.colmap import (ColmapWithDepthAsciiReader,
                                            read_images_meta)
    from cotr_tpu_torch.data.megadepth import MegadepthDataset
    from cotr_tpu_torch.tools import eval_megadepth, train_cotr
    from cotr_tpu_torch.tools.generated_scene import make_scene
    from cotr_tpu_torch.training.trainer import upload

    # the MegaDepth path's entry points
    md = types.SimpleNamespace(
        native=native, Reader=ColmapWithDepthAsciiReader,
        read_images_meta=read_images_meta,
        compute_corrs=md_dataset.compute_corrs,
        CotrDataset=md_dataset.CotrDataset,
        CotrZoomDataset=md_dataset.CotrZoomDataset,
        MegadepthDataset=MegadepthDataset, PrefetchLoader=PrefetchLoader,
        upload=upload,
        synth_supervision_batch=device_synth.synth_supervision_batch,
        project_candidates=device_synth.project_candidates,
        train_twin=train_cotr, eval_twin=eval_megadepth,
        zoom_ladder=zoom_ladder)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, "build")) as md_dir:
        t0 = time.perf_counter()
        config = make_scene(os.path.join(md_dir, "scene"), views=MD_VIEWS,
                            height=MD_HW[0], width=MD_HW[1],
                            val_views=MD_VAL_VIEWS, scenes=MD_SCENES)
        scene_s = time.perf_counter() - t0
        log(f"[megadepth-data] generated scene: {MD_VIEWS} views of "
            f"{MD_HW[0]}x{MD_HW[1]} ({MD_VAL_VIEWS} in the validation split), "
            f"repeated as {MD_SCENES} scenes for the training split, written "
            f"in {scene_s:.1f} s")
        md_data, cand_batch = phase_megadepth_data(md, config)
        md_data["scene_s"] = scene_s
        md_synth = phase_device_synth(attention, md, mods, cand_batch,
                                      md_dir)
        md_train = phase_megadepth_train(attention, md, config, md_dir)
        md_eval = phase_megadepth_eval(attention, md, config, md_dir)
        demo_dir = os.path.join(md_dir, "demos")
        os.makedirs(demo_dir)
        demos = phase_demos(attention, md, config, demo_dir)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, "build")) as suite_dir:
        suite = phase_eval_suite(attention, suite_dir)
    if file_digest(FLAGSHIP) != flagship_digest:
        raise AssertionError("checkpoints/flagship.npz changed during the "
                             "run")
    # each path's own run; the comparison runs beside them (scan engine on
    # the squad phase's queries, the serial calls, the einsum evaluation)
    # are left out, and so is serving the trained weights, which repeats
    # the scan engine's shapes
    paths = {"scan engine, 3 pairs": serve,
             "squad engine, 2,000 queries": squad,
             "multi-pair, 8 pairs x 32 queries": multipair,
             "cycle-consistent multi-pair, 2 pairs": multipair["cycle"],
             "training, 30 steps (the einsum path)": train["main"],
             "evaluation step": eval_step,
             "synthetic training from the loader, 60 + 10 steps (the "
             "einsum path)": synth_train["steps_only"],
             "synthetic validation, 2 x 4 batches of 24":
                 synth_train["validation"],
             "eval twin, bfloat16, 3 seeds + overlay": synth_eval["bfloat16"],
             "eval twin, float32, 3 seeds + overlay": synth_eval["float32"],
             "train steps on a candidate batch (the einsum path)":
                 md_synth["train"],
             "MegaDepth train twin, 20 + 20 steps (the einsum path)":
                 md_train["steps_only"],
             "MegaDepth validation, 2 + 2 batches of 24":
                 md_train["validation"],
             "MegaDepth eval twin, FasterSparseEngine, 4 pairs":
                 md_eval["faster"],
             "MegaDepth eval twin, SparseEngine, 1 pair": md_eval["sparse"],
             "convert twin --verify and the served .npz": convert,
             **{f"demo twin, {tag}": run for tag, run in demos.items()},
             "eval-suite twin, 8 textures x 5 seeds": suite["eval-suite"],
             "diagnose-tail twin, 6 textures x 3 seeds":
                 suite["diagnose-tail"]}
    launches = sum(p["launches"] for p in paths.values())
    shape_counts = merged_shape_counts(paths.values())
    rows += phase_path_shapes(attention, shape_counts, rows)

    main_row = next(r for r in rows if r["shape"] == "dense decode chunk"
                    and r["dtype"] == "float32")
    kernels = [dict(
        name="flash_cross_attention", route="cuda",
        source="cotr_tpu_torch/csrc/attention.cu",
        replaces="cotr_tpu/ops/pallas_attention.py:70",
        launches=launches, shape_counts=shape_counts,
        launches_by_path={k: p["launches"] for k, p in paths.items()},
        max_abs_err=max(r["max_abs_err"] for r in rows
                        if r["dtype"] == "float32"),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
        timed_at="B=4 Lq=8192 S=512 H=8 hd=32 float32",
        shapes=rows)]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, build=build, crops=crops, forward=forward,
                       serve_wall_s=serve["wall_s"], serve=serve,
                       squad=squad, multipair=multipair,
                       train_parity=train_parity, train=train,
                       eval_step=eval_step, checkpoint=checkpoint,
                       synthetic_loader=synth_loader,
                       synthetic_train=synth_train,
                       synthetic_eval=synth_eval, megadepth_data=md_data,
                       device_synth=md_synth, megadepth_train=md_train,
                       megadepth_eval=md_eval, convert=convert,
                       demos=demos, eval_suite=suite, kernels=kernels),
                  f, indent=1)
    log(f"[serve] wall {serve['wall_s']:.3f} s; [grouped] wall "
        f"{squad['wall_s']:.3f} s; [multipair] wall "
        f"{multipair['wall_s']:.3f} s; [train] "
        f"{train['main']['ms_per_step']:.1f} ms a step float32, "
        f"{train['lr_backbone']['ms_per_step']:.1f} ms with lr_backbone "
        f"1e-5, {train['bfloat16']['ms_per_step']:.1f} ms bfloat16; "
        f"[synthetic-train] {synth_train['main']['ms_per_step']:.1f} ms a "
        f"step from the loader, bfloat16; [megadepth-train] "
        f"{md_train['host']['ms_per_step']:.1f} ms a step (host layout), "
        f"{md_train['device_synth']['ms_per_step']:.1f} ms (device_synth), "
        f"float32; [megadepth-eval] median EPE "
        f"{md_eval['faster']['result']['epe_median']:.2f} px; [demos] "
        + ", ".join(f"{tag} {run['wall_s']:.2f} s" for tag, run in
                    demos.items())
        + f"; [eval-suite] {suite['eval-suite']['wall_s']:.2f} s, "
        f"[diagnose-tail] {suite['diagnose-tail']['wall_s']:.2f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
