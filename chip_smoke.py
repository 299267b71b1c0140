#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths, its demos and
its checkpoint and accuracy tools once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build, all at once, into build/: the attention kernels
   (csrc/attention.cu, nvcc, sm_90a), the optimizer's Adam
   (csrc/adam.cu, nvcc, sm_90a), the squad formation
   (csrc/squads.cpp) and the MegaDepth data path's loops (csrc/depth.cpp),
   the last two with the host C++ compiler; the native squad formation
   must equal the numpy scan exactly on 10,000 generated tasks;
3. the kernels (the tile kernels, bfloat16 and float32 on wgmma, and the
   row kernel, behind one wrapper) vs their plain version on the card at
   the main paths' shapes, float32 and bfloat16, with times beside the
   plain version's, one ``F.scaled_dot_product_attention`` call's (a
   yardstick only; the port never calls it), the card's bound and the
   floor of one exponential a logit; also the kernel's device time from a
   CUDA-graph replay, without the host's cost of a call, and in bfloat16
   SDPA's;
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
    its peak memory. ``[adam]``: the 30 steps launch the optimizer's Adam
    kernels (csrc/adam.cu) twice a step; after them, copies of the
    trainer's weights, gradients and optimizer state take 3 steps through
    the kernels (``Optimizer.step``) and through their plain version
    (``Optimizer.step_plain``), which must agree to the bit on weights,
    moments and counters; then each kernel's device time from a CUDA-graph
    replay beside its bytes bound;
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
23. ``[parallel-serve]``, after the multi-pair phase: the engines on a
    local mesh that lists the card twice (``parallel.mesh``), against the
    same engines without it: ``FasterSparseEngine`` on the 2,000 queries,
    the multi-pair call on 8 pairs x 32 queries, ``SparseEngine``'s
    cycle-consistent call (100 kept); then the ``bench_sharded`` twin at
    N = 2. One card listed twice proves the split and the equal answers,
    not a speed;
24. ``[parallel-train]``, after the checkpoint phases: a one-rank NCCL
    process group (a ``FileStore`` in the output directory); two unsharded
    runs of 5 ``TrainConfig()`` steps at batch 24 compared as they are,
    then, with ``torch.backends.cudnn.deterministic``, 5 steps through the
    data-parallel step from the same state and batch as 5 unsharded steps,
    and the same with ZeRO-1; ms a step for each;
25. the last tools, each run whole at its full width with a gate fixed
    before the first reading: ``[triage-dense]`` (the triage_dense twin:
    dense_flow at 1024 x 1024 in bfloat16, 31 trials, finite, the median
    split call's phases summing to its wall within 20% and that wall the
    trials' median within 20%), ``[triage-multipair]`` (64 pairs of 32
    queries at seed strides 1 and 4, one trial after the warm call: the
    cost centres' calls those the job needs, the wrapped dispatch calls
    equal to the engine's dispatch_count), ``[triage-guided]`` (2,048
    keypoints each way on the serving phase's 768 x 1024 pair, 3 rounds
    after the warm one: finite answers, a probe above 0 ms, both
    correlations defined), after the parallel serving phase;
    ``[goldens]`` (the golden twin's demos in subprocesses, held by
    ``compare_to_golden`` to [demos]' pictures), ``[side-by-side]`` and
    ``[nn-dist]`` (the kNN overlap matrix of [megadepth-data]'s scene on the
    card against the numpy path on 48 cells, computed beside [goldens];
    resumed and repeated), after [demos]; ``[bench-loader]`` (500 captures
    of 240 x 320 in both layouts) and ``[generated-training]`` (the
    orchestrator's three stages and its held-out eval in subprocesses,
    stage 1 killed and resumed), after [eval-suite];
26. ``[dense-pass]``, last of the paths, so that the profiler it starts
    runs after every timed phase: ``inference.dense_pass`` on one
    generated pair (the 480 x 640 serving pair, B a known homography of
    A), both stretched to 256 x 256, inside ``utils.profiling.trace``: its
    two fields finite and (256, 256, 3), the tile kernel launched once an
    encoder layer at (1, 512) and once a decoder layer and decode chunk at
    (1, 8192), the fields equal to ``dense_flow``'s on the same pair, the
    trace naming the attention kernel, and ``warp_by_flow(B, corr_a)``
    closer to A than B is; then ``ops.crop_and_resize`` on the card
    against the CPU (64 boxes of a 768 x 1024 image, out 256);
27. one JSON line describing each kernel (the tile kernel and the row
    kernel, in float32 and in bfloat16, each with its own launches on the
    paths; the two Adam kernels, each with its launches in the 30 training
    steps), then the device line last.

The kernels' launch counts are set to 0 just before each path and read just
after it.

It imports nothing of JAX or the JAX package. Without a card, or without
the repository around it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import ctypes
import dataclasses
import functools
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

# [dense-pass]: dense_pass against dense_flow on the card (the same kernels
# at the same shapes on the same canvas: only the host's float64 affine and
# the identity resize of a square patch lie between them); crop_and_resize,
# card against CPU (the same float32 gather and blend)
DENSE_PASS_TOL = 1e-5
CROP_AND_RESIZE_TOL = 1e-5
CROP_AND_RESIZE_BOXES = 64

# (B, Lq) of each attention on the main path (S = 512 keys, 8 heads of 32)
SHAPES = [("encoder self-attention", 2, 512),
          ("refinement encoder", 256, 512),
          ("dense decode chunk", 4, 8192),
          ("dense decode, batch of 8 chunks", 8, 8192),
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
# [adam]: steps of the Adam kernels and their plain version on copies of
# the trained state, and graph-replayed launches a kernel timing
ADAM_STEPS = 3
ADAM_TIMED_LAUNCHES = 20
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
# the parallel phases: a local mesh that lists the one card twice for the
# engines; the data-parallel step in a one-rank process group, held to the
# unsharded step on the loss (relative) and on the weights (RESUME_ATOL)
PARALLEL_MESH = ["cuda:0", "cuda:0"]
PARALLEL_TRAIN_STEPS = 5
PARALLEL_LOSS_RTOL = 1e-5
# the last tools, each run whole at its full width. [triage-dense]: the
# phases of the median split call sum to that call's wall within this
# share, and that wall is the plain trials' median within it too
TRIAGE_SPLIT_SHARE = 0.2
# 31, not the tool's default 7: one call's wall spreads from 0.07 to 0.15 s
# on the card's shared host (the first few calls the slowest), and the
# median of 7 moved the split call to 0.78 and 1.26 of the trials' median
# in two runs, the wrong way as often as the right one
TRIAGE_DENSE_TRIALS = 31
# cut for the script's time: 1 trial of the multi-pair triage after its
# warm call (its default is 3), 3 rounds of the guided one (8), the fewest
# that give its correlations
TRIAGE_MULTIPAIR_TRIALS = 1
TRIAGE_GUIDED_ROUNDS = 3
# [triage-guided]: keypoints of each image, drawn inside this margin (px)
GUIDED_KEYPOINTS = 2048
GUIDED_MARGIN = 8
# [bench-loader]: the JAX tool's scene and loader at its defaults, and the
# keys of a batch in each layout
LOADER_ARGV = ["--captures", "500", "--height", "240", "--width", "320",
               "--batch_size", "24", "--batches", "20", "--workers", "4"]
LOADER_REPORT_KEYS = {"metric", "captures", "image_hw", "batch_size",
                      "use_ram", "batches_timed", "batches_per_s",
                      "samples_per_s", "keys", "device_synth"}
LOADER_BATCH_KEYS = {
    False: ["corrs", "image", "queries", "targets"],
    True: ["c2w_nn", "cand", "flip", "image", "kinv_nn", "proj_q", "qdepth",
           "qscale", "skey"]}
# [generated-training]: the orchestrator at full width, cut in iterations
# only: stage 1 for 4 with a validation every 2 (killed after 2), stages 2
# and 3 for 2 each
GENTRAIN_ITERS = {"--stage1_iters": 4, "--stage2_iters": 2,
                  "--stage3_iters": 2, "--valid_iter": 2}
# the stages' validation batches (bfloat16), launched in their subprocesses
GENTRAIN_SHAPES = [(24, 512), (24, 200), (16, 512), (16, 200)]
# [nn-dist]: the card's matrix against the numpy path on sampled cells:
# equal on all but NN_INEXACT, all within NN_TOL (about 80 pixels of a
# 768 x 1024 union); the first invocation of the split run fills NN_SPLIT
NN_SAMPLED = 48
NN_INEXACT = 1
NN_TOL = 1e-4
NN_SPLIT = 1000
# the numpy path's processes: half the host's cores, beside [goldens]
NN_PROCESSES = 4
# [goldens]: each demo's arguments after "--" (the inputs [demos] wrote in
# its directory) and the picture [demos] wrote from them
GOLDEN_INPUTS = {
    "demo_single_pair": (["--img_a", "pair_a.npy", "--img_b", "pair_b.npy"],
                         "sparse_output.png"),
    "demo_wbs": (["--img_a", "wbs_a.npy", "--img_b", "wbs_b.npy", "--pts",
                  "wbs_pts.txt"], "wbs_output.png")}


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


def graph_ms(fn, launches: int) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured in a
    CUDA graph, the graph replayed between CUDA events, the time over the
    calls. The host's cost of a call (a wrapper, the launch) is not in it,
    as it is in ``time_ms``'s back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    replays = 5
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    torch.cuda.empty_cache()
    return ms


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
    """The four sources at once, each by its own compiler; then the native
    squad formation against the numpy scan."""
    def timed(build, *args):
        t0 = time.perf_counter()
        return build(*args), time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(timed, native.build_cuda_library, name)
                for name in native.CUDA_SOURCES]
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
    SDPA's, the bound and the exp floor; the kernel's graph-replay device
    time too, and in bfloat16 SDPA's."""
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
    graph = dict(graph_ms=graph_ms(
        lambda: attention.flash_cross_attention(q, k, v), 10))
    # SDPA's in bfloat16 only: its float32 path keeps its logits, 2 GB a
    # call at (256, 512), and a graph holds every call's
    if dtype == "bfloat16":
        graph["graph_library_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
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
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               **graph)
    log(f"[kernel] {label:24s} B={b:<4d} Lq={lq:<5d} {dtype:8s} "
        f"{variant:4s} err {err:.2e}  kernel {ms:.4f} ms  "
        f"plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  "
        f"bound {bound_ms:.4f} ms ({bound_by})  "
        f"exp floor {row['exp_floor_ms']:.4f} ms"
        + "".join(f"  tile of {n} rows {t:.4f} ms"
                  for n, t in by_rows.items())
        + f"  graph replay: kernel {graph['graph_ms']:.4f} ms"
        + (f", sdpa {graph['graph_library_ms']:.4f} ms"
           if "graph_library_ms" in graph else ""))
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


def phase_dense_pass(attention, dense, runner, sampling, trace) -> dict:
    """``dense_pass`` on the serving pair of 480 x 640 stretched to 256^2,
    traced, against ``dense_flow``; ``warp_by_flow`` through its field;
    ``crop_and_resize`` on the card against the CPU."""
    t_phase = time.perf_counter()
    img_a, img_b, hmat = make_pair(np.random.RandomState(1), (480, 640),
                                   2.0, 1.0, (16, 10))
    n = 256
    a_sq, b_sq = (sampling.resize_pil_host(im, (n, n)) for im in (img_a,
                                                                  img_b))
    # the homography between the stretched images: B(H x) = A(x) in
    # continuous pixel coordinates, each axis scaled on its own
    scale = np.diag([n / 640, n / 480, 1.0])
    h_sq = scale @ hmat @ np.linalg.inv(scale)
    enc = runner.model.cfg.enc_layers
    dec = runner.model.cfg.dec_layers
    chunks = -(-n * 2 * n // runner.decode_chunk)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as td:
        with counted(attention, {}) as record:
            with trace(td):
                corr_a, corr_b = dense.dense_pass(runner, a_sq, b_sq)
        files = [f for f in os.listdir(td) if f.endswith(".pt.trace.json")]
        if len(files) != 1:
            raise AssertionError(f"[dense-pass] trace files {files}")
        with open(os.path.join(td, files[0])) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events
                      if e.get("cat") == "kernel"
                      and "attention_kernel" in e.get("name", "")})
    log(f"[dense-pass] dense_pass on {n}x{n}: {record['wall_s']:.3f} s "
        f"traced; the trace names {kernels}")
    log_counts("dense-pass", record)
    for name, corr in (("corr_a", corr_a), ("corr_b", corr_b)):
        if corr.shape != (n, n, 3) or not np.isfinite(corr).all():
            raise AssertionError(f"[dense-pass] {name}: {corr.shape}, "
                                 f"finite {np.isfinite(corr).all()}")
    want = [dict(b=1, lq=512, s=512, dtype="float32", launches=enc),
            dict(b=1, lq=runner.decode_chunk, s=512, dtype="float32",
                 launches=dec * chunks)]
    if record["shape_counts"] != want:
        raise AssertionError(f"[dense-pass] launches {record['shape_counts']}"
                             f", expected {want}")
    if not any("attention_kernel_tile" in k for k in kernels):
        raise AssertionError("[dense-pass] the trace names no tile kernel")

    flow_a, con_a, flow_b, con_b = dense.dense_flow(runner, a_sq, b_sq)
    torch.cuda.synchronize()
    flow_err = max(float(np.abs(c[..., :2] - fl).max()) for c, fl in
                   ((corr_a, flow_a), (corr_b, flow_b)))
    con_err = max(float(np.abs(c[..., 2] - cn).max()) for c, cn in
                  ((corr_a, con_a), (corr_b, con_b)))
    log(f"[dense-pass] against dense_flow: flow max abs err {flow_err:.2e}, "
        f"confidence {con_err:.2e} (tol {DENSE_PASS_TOL})")
    if not max(flow_err, con_err) <= DENSE_PASS_TOL:
        raise AssertionError("[dense-pass] dense_pass disagrees with "
                             "dense_flow")
    t0 = time.perf_counter()
    dense.dense_pass(runner, a_sq, b_sq)  # returns numpy: the card is done
    untraced_s = time.perf_counter() - t0
    log(f"[dense-pass] dense_pass again without the profiler: "
        f"{untraced_s:.3f} s")

    # a query at pixel (j, i) sits at x = j / n of its half: the pixel's
    # corner, which the homography maps into B
    ys, xs = np.mgrid[0:n, 0:n]
    grid = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)
    pred = (corr_a[..., :2].reshape(-1, 2).astype(np.float64) + 1) / 2 * n
    err = np.linalg.norm(pred - apply_h(h_sq, grid), axis=1)
    conf = corr_a[..., 2].ravel() < 0.02
    median_conf = float(np.median(err[conf])) if conf.any() else float("nan")
    centres = apply_h(h_sq, grid + 0.5)
    inside = ((centres >= 0) & (centres < n)).all(axis=1).reshape(n, n)
    warped = dense.warp_by_flow(torch.from_numpy(b_sq).cuda(),
                                torch.from_numpy(corr_a).cuda())
    a_f = a_sq.astype(np.float32)
    warped_diff = float(np.abs(warped - a_f)[inside].mean())
    plain_diff = float(np.abs(b_sq.astype(np.float32) - a_f)[inside].mean())
    log(f"[dense-pass] flow error vs the homography: median "
        f"{np.median(err):.2f} px over every pixel, {median_conf:.2f} px "
        f"over the {conf.mean():.0%} with confidence < 0.02; "
        f"warp_by_flow(B, corr_a) vs A: mean abs diff {warped_diff:.2f} over "
        f"{inside.mean():.0%} of the pixels, unwarped B {plain_diff:.2f}")
    if not warped_diff < plain_diff:
        raise AssertionError("[dense-pass] the warped image is no closer "
                             "to A than B is")

    rng = np.random.RandomState(23)
    img = procedural_texture(rng, 768, 1024).astype(np.float32) / 255.0
    size = rng.uniform(16, 700, (CROP_AND_RESIZE_BOXES, 2))
    corner = rng.uniform(0, 1, (CROP_AND_RESIZE_BOXES, 2)) \
        * (np.array([1024, 768]) - size)
    boxes = np.concatenate([corner, size], axis=1).astype(np.float32)
    t0 = time.perf_counter()
    got = sampling.crop_and_resize(torch.from_numpy(img).cuda(), boxes, n)
    torch.cuda.synchronize()
    crop_s = time.perf_counter() - t0
    cpu = sampling.crop_and_resize(torch.from_numpy(img), boxes, n)
    crop_err = float((got.cpu() - cpu).abs().max())
    log(f"[dense-pass] crop_and_resize, {CROP_AND_RESIZE_BOXES} boxes of a "
        f"768x1024 image to {n}: card vs CPU max abs err {crop_err:.2e} "
        f"(tol {CROP_AND_RESIZE_TOL}), {crop_s * 1e3:.1f} ms on the card "
        f"(first call)")
    if got.shape != (CROP_AND_RESIZE_BOXES, n, n, 3) \
            or not crop_err <= CROP_AND_RESIZE_TOL:
        raise AssertionError("[dense-pass] crop_and_resize: the card "
                             "disagrees with the CPU")
    record.update(
        untraced_s=untraced_s, kernels_in_trace=kernels,
        dense_flow_err=flow_err,
        confidence_err=con_err, median_px=float(np.median(err)),
        median_px_confident=median_conf,
        confident_share=float(conf.mean()), warped_diff=warped_diff,
        unwarped_diff=plain_diff, crop_and_resize_err=crop_err,
        phase_s=time.perf_counter() - t_phase)
    log(f"[dense-pass] phase wall {record['phase_s']:.2f} s")
    return record


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


def flagship_backbone(mods, model) -> None:
    """The flagship's backbone weights into ``model``."""
    state = mods.params_from_flax(mods.load_flagship(FLAGSHIP))
    prefix = "backbone."
    model.backbone.load_state_dict(
        {k[len(prefix):]: v for k, v in state.items()
         if k.startswith(prefix)}, strict=True)


def make_trainer(mods, cfg, train_cfg, batch, out_dir, seed=0):
    """A Trainer at step 0 on the card: the flagship's backbone, everything
    else drawn afresh from ``seed``; its loaders yield ``batch`` (already on
    the card) once an epoch."""
    trainer = mods.Trainer(mods.build_model(cfg), cfg, train_cfg,
                           lambda: [batch], lambda: [batch], out_dir=out_dir,
                           use_tensorboard=False, device="cuda")
    trainer.initialize(seed=seed)
    flagship_backbone(mods, trainer.state.model)
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
    mods.optim.launches = 0
    main_run = run_steps(attention, trainer, TRAIN_STEPS, "train")
    main_run["adam_launches"] = mods.optim.launches
    if main_run["adam_launches"] != 2 * TRAIN_STEPS:
        raise AssertionError(f"[adam] {TRAIN_STEPS} steps launched the Adam "
                             f"kernels {main_run['adam_launches']} times, "
                             f"not twice a step")
    adam = phase_adam(mods, trainer)
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
                         lr_backbone=backbone_run, bfloat16=bf16_run,
                         adam=adam)


def adam_copy(mods, opt) -> tuple:
    """(parameters, optimizer): copies of ``opt``'s trainable weights,
    their gradients and its state, in an optimizer of their own."""
    named = {}
    for name, p in opt.params.items():
        if p.grad is None:
            raise AssertionError(f"[adam] {name} has no gradient after the "
                                 f"main path's step")
        named[name] = torch.nn.Parameter(p.detach().clone())
        named[name].grad = p.grad.clone()
    twin = mods.optim.Optimizer(opt.cfg, named)
    twin.load_state_dict(opt.state_dict())
    return named, twin


def ulps_apart(got, want) -> tuple:
    """(values that differ, most units in the last place between them) of
    two float32 tensors, bit for bit."""
    diff = (got.contiguous().view(torch.int32).long()
            - want.contiguous().view(torch.int32).long()).abs()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0


def phase_adam(mods, trainer) -> dict:
    """The Adam kernels against their plain version at the published
    model's shapes, from the state the main path's last step left: the
    trainer's trainable weights, gradients and optimizer state copied
    twice, ADAM_STEPS steps of ``Optimizer.step`` on one copy and of
    ``Optimizer.step_plain`` on the other, every weight, moment and counter
    held equal to the bit. Then on the kernels' copy each kernel's device
    time (from ADAM_TIMED_LAUNCHES launches captured in a CUDA graph)
    beside its bytes bound, and a step's wall time back to back beside the
    plain step's."""
    optim = mods.optim
    opt = trainer.state.optimizer
    (k_named, k_opt), (p_named, p_opt) = adam_copy(mods, opt), \
        adam_copy(mods, opt)
    for _ in range(ADAM_STEPS):
        k_opt.step()
        p_opt.step_plain()
    torch.cuda.synchronize()
    differ, worst = [], 0
    for name in k_named:
        for kind, got, want in (
                ("w", k_named[name].detach(), p_named[name].detach()),
                ("mu", k_opt.mu[name], p_opt.mu[name]),
                ("nu", k_opt.nu[name], p_opt.nu[name])):
            n, ulp = ulps_apart(got, want)
            if n:
                differ.append(f"{kind}[{name}]: {n}")
                worst = max(worst, ulp)
    counters = {c: (int(getattr(k_opt, c)), int(getattr(p_opt, c)))
                for c in ("count", "notfinite_count", "total_notfinite",
                          "last_finite")}
    tensors = len(k_named)
    elements = sum(p.numel() for p in k_named.values())
    log(f"[adam] {ADAM_STEPS} steps from the main path's state (Adam count "
        f"{int(opt.count)}), {tensors} tensors, {elements} parameters: "
        f"kernels vs step_plain, values that differ: {len(differ)} tensors "
        f"{differ[:4]}, at most {worst} ulp; counters (kernels, plain) "
        f"{counters}")
    if differ or any(a != b for a, b in counters.values()):
        raise AssertionError("[adam] the kernels do not equal step_plain to "
                             "the bit")

    def timed_wall(step, calls=10) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / calls

    step_ms = timed_wall(k_opt.step)
    plain_ms = timed_wall(p_opt.step_plain)
    lib = optim._library()
    step = k_opt._kernel_step()
    n_chunks = len(k_opt._chunks) // 2

    def finite():
        lib.cotr_adam_finite(
            k_opt._table.data_ptr(), tensors, n_chunks, optim.KERNEL_CHUNK,
            k_opt._flag.data_ptr(), torch.cuda.current_stream().cuda_stream)

    def update():
        lib.cotr_adam_update(
            k_opt._table.data_ptr(), tensors, n_chunks, optim.KERNEL_CHUNK,
            ctypes.byref(step), torch.cuda.current_stream().cuda_stream)

    record = dict(steps=ADAM_STEPS, from_count=int(opt.count),
                  tensors=tensors, elements=elements, differ=len(differ),
                  max_ulp=worst, step_wall_ms=step_ms,
                  plain_step_wall_ms=plain_ms)
    # The update streams 28 B an element (reads g, w, mu, nu; writes w, mu,
    # nu), far past the card's 50 MB L2, so its replays read memory. The
    # check reads g alone, 4 B an element, which fits in L2: replayed on
    # its own it would read L2 after the first launch. So it is timed as a
    # step runs it, before an update, and its time is the pair's less the
    # update's.
    update_ms = graph_ms(update, ADAM_TIMED_LAUNCHES)
    pair_ms = graph_ms(lambda: (finite(), update()), ADAM_TIMED_LAUNCHES)
    for name, ms, per_element in (("adam_finite", pair_ms - update_ms, 4),
                                  ("adam_update", update_ms, 28)):
        bound = per_element * elements / PEAK_BYTES_PER_S * 1e3
        record[name] = dict(ms=ms, bound_ms=bound,
                            bytes=per_element * elements)
        log(f"[adam] {name}: {ms:.4f} ms on the card (graph replay), bytes "
            f"bound {bound:.4f} ms ({per_element} B an element from "
            f"memory)")
    log(f"[adam] a step back to back: {step_ms:.3f} ms through the kernels, "
        f"{plain_ms:.3f} ms through step_plain")
    del k_named, k_opt, p_named, p_opt
    torch.cuda.empty_cache()
    return record


def adam_kernel_entries(train: dict) -> list:
    """The ``kernels`` line's entries of the two Adam kernels: each
    launched once a step of the main training path."""
    adam = train["adam"]
    launches = train["main"]["adam_launches"] // 2
    return [dict(
        name=f"{name}, float32", kernel=name, route="cuda",
        source="cotr_tpu_torch/csrc/adam.cu",
        replaces="cotr_tpu/training/optim.py:69", dtype="float32",
        launches=launches,
        launches_by_path={"training, 30 steps (the einsum path)": launches},
        max_ulp=adam["max_ulp"], ms=adam[name]["ms"],
        bound_ms=adam[name]["bound_ms"], bound_by="bytes",
        bytes=adam[name]["bytes"], step_wall_ms=adam["step_wall_ms"],
        plain_step_wall_ms=adam["plain_step_wall_ms"],
        timed_at=f"{adam['tensors']} tensors, {adam['elements']} float32 "
                 f"parameters") for name in ("adam_finite", "adam_update")]


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


# --------------------------------------------------------------- parallelism

def same_refinement(got: np.ndarray, want: np.ndarray) -> dict:
    """Distances of two runs' answers (rows of x_a, y_a, x_b, y_b for the
    same queries), held to the "same refinement, other dispatch
    composition" gate."""
    diff = np.linalg.norm(got[:, 2:] - want[:, 2:], axis=1)
    return dict(within_1px=float(np.mean(diff <= 1.0)),
                median_px=float(np.median(diff)),
                max_px=float(diff.max()),
                ok=bool(np.mean(diff <= 1.0) >= SAME_WITHIN_1PX
                        and np.median(diff) <= SAME_MEDIAN_PX))


def phase_parallel_serve(attention, par, runner, pair) -> dict:
    """The engines on a local mesh that lists the card twice, against the
    same engines without a mesh, at full width: the squad engine on 2,000
    grid queries of the 768 x 1024 pair, the multi-pair call on 8 pairs x
    32 queries, the scan engine's cycle-consistent call (100 kept); then
    the bench_sharded twin at N = 2. One card listed twice runs both shares
    in turn: this proves the split and the equal answers, not a speed."""
    mesh = par.make_mesh(devices=PARALLEL_MESH)
    img_a, img_b, hmat = pair
    h, w = img_a.shape[:2]
    queries = grid_queries(h, w)
    n = len(queries)
    kw = dict(zoom_ins=ZOOMS, queries_a=queries, force=True, max_corrs=n)
    out = {"mesh": PARALLEL_MESH}

    # the squad engine: first use of the halved shapes outside the timing
    par.FasterSparseEngine(runner, mode="tile", mesh=mesh
                           ).cotr_corr_multiscale(
        img_a, img_b, **dict(kw, queries_a=queries[::8], max_corrs=n // 8))
    sharded = par.FasterSparseEngine(runner, mode="tile", mesh=mesh)
    with counted(attention, {}) as squad:
        got = sharded.cotr_corr_multiscale(img_a, img_b, **kw)
    single = par.FasterSparseEngine(runner, mode="tile")
    t0 = time.perf_counter()
    want = single.cotr_corr_multiscale(img_a, img_b, **kw)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    if got.shape != (n, 4) or not np.isfinite(got).all():
        raise AssertionError(f"[parallel-serve] squad engine on the mesh: "
                             f"{got.shape} or non-finite output")
    err = np.linalg.norm(apply_h(hmat, got[:, :2]) - got[:, 2:], axis=1)
    stepper = sharded._stepper
    squad.update(queries=n, vs_unsharded=same_refinement(got, want),
                 unsharded_wall_s=single_s, median_px=float(np.median(err)),
                 dispatch_count=stepper.dispatch_count,
                 canvas_count=stepper.canvas_count,
                 device_canvas_count=stepper.device_canvas_count,
                 unsharded_canvas_count=single._stepper.canvas_count)
    log(f"[parallel-serve] squad engine, {n} queries on {PARALLEL_MESH}: "
        f"{squad['wall_s']:.2f} s wall (unsharded {single_s:.2f} s); "
        f"against the unsharded engine {squad['vs_unsharded']}; median "
        f"error vs the known homography {np.median(err):.2f} px; "
        f"dispatch_count {stepper.dispatch_count}, canvas_count "
        f"{stepper.canvas_count} (unsharded "
        f"{single._stepper.canvas_count}), per device "
        f"{stepper.device_canvas_count}")
    log_counts("parallel-serve", squad)
    out["squad"] = squad

    # the multi-pair call
    rng = np.random.RandomState(6)
    pairs, pair_queries = [], []
    for _ in range(8):
        a, b, _ = make_pair(rng, (480, 640), angle=rng.uniform(-4, 4),
                            scale=rng.uniform(0.97, 1.04),
                            shift=rng.uniform(-12, 12, 2))
        pairs.append((a, b))
        pair_queries.append(np.stack(
            [rng.uniform(0.15 * 640, 0.85 * 640, 32),
             rng.uniform(0.15 * 480, 0.85 * 480, 32)], axis=1))
    mkw = dict(zoom_ins=ZOOMS, force=True, max_corrs=32,
               queries_list=pair_queries, pair_seeds=list(range(8)))
    with counted(attention, {}) as multi:
        got = par.FasterSparseEngine(runner, mode="tile", seed_stride=4,
                                     mesh=mesh
                                     ).cotr_corr_multiscale_multipair(
            pairs, **mkw)
    want = par.FasterSparseEngine(runner, mode="tile", seed_stride=4
                                  ).cotr_corr_multiscale_multipair(pairs,
                                                                   **mkw)
    multi["vs_unsharded"] = [same_refinement(g, w_)
                             for g, w_ in zip(got, want)]
    log(f"[parallel-serve] multi-pair, 8 x 32 on the mesh: "
        f"{multi['wall_s']:.2f} s wall; against the unsharded call, worst "
        f"pair {min(r['within_1px'] for r in multi['vs_unsharded']):.1%} "
        f"within 1 px")
    log_counts("parallel-serve", multi)
    out["multipair"] = multi

    # the scan engine's cycle-consistent call: the answers both runs keep
    ckw = dict(zoom_ins=ZOOMS, max_corrs=100, return_idx=True)
    with counted(attention, {}) as scan:
        got, got_idx = par.SparseEngine(
            runner, mode="tile", mesh=mesh
        ).cotr_corr_multiscale_with_cycle_consistency(img_a, img_b, **ckw)
    want, want_idx = par.SparseEngine(
        runner, mode="tile").cotr_corr_multiscale_with_cycle_consistency(
        img_a, img_b, **ckw)
    common = np.intersect1d(got_idx, want_idx)
    union = np.union1d(got_idx, want_idx)
    pick_got = {int(i): r for i, r in zip(got_idx, got)}
    pick_want = {int(i): r for i, r in zip(want_idx, want)}
    both = same_refinement(np.stack([pick_got[int(i)] for i in common]),
                           np.stack([pick_want[int(i)] for i in common]))
    both["kept_alike"] = float(len(common) / len(union))
    both["ok"] = both["ok"] and both["kept_alike"] >= SAME_WITHIN_1PX
    scan.update(kept=int(len(got_idx)), unsharded_kept=int(len(want_idx)),
                vs_unsharded=both)
    log(f"[parallel-serve] scan engine, cycle-consistent, on the mesh: "
        f"{scan['wall_s']:.2f} s wall, {len(got_idx)} kept (unsharded "
        f"{len(want_idx)}); against the unsharded call {both}")
    log_counts("parallel-serve", scan)
    out["scan"] = scan

    # the bench twin at N = 2
    os.makedirs(OUT_DIR, exist_ok=True)
    bench_path = os.path.join(OUT_DIR, "bench_sharded.json")
    with counted(attention, {}) as bench:
        result = par.bench_sharded.main(
            ["--n", "2", "--devices", ",".join(PARALLEL_MESH), "--groups",
             "16", "--members", "16", "--out", bench_path], device="cuda")
    bench["result"] = result
    log(f"[parallel-serve] bench_sharded N=2: grouped "
        f"{result['configs']['grouped_n1']['wall_s']:.4f} -> "
        f"{result['configs']['grouped_n2']['wall_s']:.4f} s a call, raw "
        f"deviation {result['configs']['grouped_n2']['max_abs_dev_vs_n1']:.2e}"
        f"; scan {result['configs']['scan_n1']['wall_s']:.4f} -> "
        f"{result['configs']['scan_n2']['wall_s']:.4f} s a call, "
        f"{result['configs']['scan_n2']['share_within_1px']:.1%} within 1 px")
    log_counts("parallel-serve", bench)
    out["bench"] = bench

    failed = [k for k in ("squad", "scan") if not out[k]["vs_unsharded"]["ok"]]
    failed += [f"multipair pair {i}" for i, r in
               enumerate(multi["vs_unsharded"]) if not r["ok"]]
    if failed:
        raise AssertionError(f"[parallel-serve] sharded answers disagree "
                             f"with the unsharded ones: {failed}")
    if not (kernel_variants(attention, squad).get("tile")
            and kernel_variants(attention, multi).get("tile")
            and kernel_variants(attention, scan).get("row")
            and kernel_variants(attention, scan).get("tile")):
        raise AssertionError("[parallel-serve] the sharded paths did not "
                             "launch both the tile and the row kernel")
    if stepper.device_canvas_count != [stepper.canvas_count // 2] * 2:
        raise AssertionError("[parallel-serve] the squads did not split "
                             "in halves")
    return out


def parallel_run(attention, mods, par, cfg, train_cfg, batch, **kw) -> dict:
    """``PARALLEL_TRAIN_STEPS`` steps from the flagship's backbone and fresh
    weights elsewhere (seed 0), each step's dropout seeded as the Trainer
    seeds it; with ``mesh`` (and ``zero1_axis``) through the data-parallel
    step."""
    model = mods.build_model(cfg)
    par.init_weights(model, torch.Generator().manual_seed(0))
    flagship_backbone(mods, model)
    state = par.create_train_state(model, train_cfg, None, "cuda", **kw)
    step = par.make_train_step(train_cfg, kw.get("mesh"))
    generator = torch.Generator(device=batch["crop"].device)
    events, losses = [], []
    with counted(attention, {}) as record:
        for i in range(PARALLEL_TRAIN_STEPS):
            generator.manual_seed((train_cfg.seed + 1) * 1_000_003 + i)
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            events.append(event)
            state, metrics = step(state, batch, generator)
            losses.append(metrics["loss"])
        last = torch.cuda.Event(enable_timing=True)
        last.record()
    marks = events + [last]
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    record.update(losses=[float(x) for x in losses],
                  ms_per_step=statistics.median(ms[1:]), ms_by_step=ms,
                  weights={k: v.detach().clone() for k, v in
                           model.named_parameters() if v.requires_grad},
                  zero1_tensors=len(state.optimizer.zero1))
    del model, state
    torch.cuda.empty_cache()
    return record


def deviation(run: dict, ref: dict) -> tuple:
    """(largest relative loss difference, largest weight difference)."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(run["losses"], ref["losses"]))
    weight_abs = max(float((run["weights"][k] - v).abs().max())
                     for k, v in ref["weights"].items())
    return loss_rel, weight_abs


def phase_parallel_train(attention, mods, par, batch) -> dict:
    """The data-parallel train step in a one-rank NCCL process group (a
    FileStore under OUT_DIR, not a TCP port): 5 ``TrainConfig()`` steps at
    batch 24 from the same state and batch as 5 unsharded steps, then the
    same with ZeRO-1; ms a step for each.

    The unsharded step does not reproduce itself bit for bit under cuDNN's
    default algorithms (the input projection's weight gradient sums in
    another order from run to run), and Adam's first steps turn that
    rounding into weight differences near the rate. So two unsharded runs
    are first compared as they are, for the reading, and the gated runs use
    ``torch.backends.cudnn.deterministic``."""
    cfg = mods.COTRConfig()
    train_cfg = mods.TrainConfig()
    store_path = os.path.join(OUT_DIR, "parallel_train_store")
    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(store_path):
        os.remove(store_path)
    started = par.init_distributed(
        "cuda", store=torch.distributed.FileStore(store_path, 1), rank=0,
        world_size=1)
    if not started:
        raise AssertionError("[parallel-train] a process group was running")
    deterministic = torch.backends.cudnn.deterministic
    try:
        mesh = par.make_mesh()
        backend = torch.distributed.get_backend()
        run = functools.partial(parallel_run, attention, mods, par, cfg,
                                train_cfg, batch)
        first, again = run(), run()
        free_rel, free_abs = deviation(again, first)
        log(f"[parallel-train] two unsharded runs under cuDNN's default "
            f"algorithms: loss within {free_rel:.2e} rel, weights within "
            f"{free_abs:.2e} ({first['ms_per_step']:.1f} and "
            f"{again['ms_per_step']:.1f} ms a step)")
        torch.backends.cudnn.deterministic = True
        runs = {"unsharded": run(), "dp": run(mesh=mesh),
                "dp + zero1": run(mesh=mesh, zero1_axis="data")}
        out = {"backend": backend, "mesh": mesh.shape,
               "default_algorithms": dict(
                   loss_max_rel=free_rel, weight_max_abs=free_abs,
                   ms_per_step=[first["ms_per_step"],
                                again["ms_per_step"]])}
        ref = runs["unsharded"]
        for name in ("dp", "dp + zero1"):
            got = runs[name]
            loss_rel, weight_abs = deviation(got, ref)
            out[name] = dict(ms_per_step=got["ms_per_step"],
                             ms_by_step=got["ms_by_step"],
                             losses=got["losses"], loss_max_rel=loss_rel,
                             weight_max_abs=weight_abs,
                             launches=got["launches"],
                             zero1_tensors=got["zero1_tensors"])
            log(f"[parallel-train] {name} over {backend} (world size 1) vs "
                f"unsharded, deterministic cuDNN, {PARALLEL_TRAIN_STEPS} "
                f"steps at batch {batch['crop'].shape[0]}: loss within "
                f"{loss_rel:.2e} rel (tol {PARALLEL_LOSS_RTOL}), weights "
                f"within {weight_abs:.2e} (tol {RESUME_ATOL}); "
                f"{got['ms_per_step']:.1f} ms a step against "
                f"{ref['ms_per_step']:.1f} ms")
            if not (loss_rel <= PARALLEL_LOSS_RTOL
                    and weight_abs <= RESUME_ATOL):
                raise AssertionError(f"[parallel-train] {name} differs from "
                                     "the unsharded step")
            if got["launches"]:
                raise AssertionError(f"[parallel-train] {name} launched the "
                                     "forward-only attention kernel")
        out["unsharded"] = dict(ms_per_step=ref["ms_per_step"],
                                ms_by_step=ref["ms_by_step"],
                                losses=ref["losses"])
        out["launches"] = sum(r["launches"] for r in
                              (first, again, *runs.values()))
        out["shape_counts"] = []
        return out
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.distributed.destroy_process_group()


@contextlib.contextmanager
def replaced(module, name: str, value):
    """``module.name`` is ``value`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def phase_triage_dense(attention) -> dict:
    """The triage_dense twin at its defaults: the flagship in bfloat16, two
    1024 x 1024 images, TRIAGE_DENSE_TRIALS trials, each followed by a
    split call. Gates:
    every trial's output is finite (the twin raises otherwise); the phases
    of the reported split call sum to that call's wall within
    TRIAGE_SPLIT_SHARE (no stage of the call goes untimed); and that wall,
    the split calls' median, is the trials' median within the same share
    (the split stands for a plain call)."""
    from cotr_tpu_torch.tools import triage_dense

    with counted(attention, {}) as record:
        report = triage_dense.main(
            ["--trials", str(TRIAGE_DENSE_TRIALS), "--side", "1024"],
            device="cuda")
    split = report["phase_split_one_call_s"]
    phase_sum = (split["canvas_build_upload"] + split["device_pass"]
                 + split["map_resize_merge_on_device"] + split["fetch"])
    share = phase_sum / split["call_wall"]
    of_median = split["call_wall"] / report["median_s"]
    record.update(report=report, phase_sum_s=phase_sum, split_share=share,
                  split_wall_of_median=of_median)
    log(f"[triage-dense] dense_flow on 1024 x 1024, bfloat16: median "
        f"{report['median_s']:.3f} s (IQR {report['iqr_s']}), "
        f"{report['q_s_median']:.0f} queries/s; the median split call "
        f"{split}: its phases summed, {phase_sum:.3f} s = "
        f"{share:.3f} of its wall; its wall {of_median:.3f} of the trials' "
        f"median")
    log_counts("triage-dense", record)
    if abs(share - 1.0) > TRIAGE_SPLIT_SHARE \
            or abs(of_median - 1.0) > TRIAGE_SPLIT_SHARE:
        raise AssertionError(f"[triage-dense] the phases sum to {share:.3f} "
                             f"of their call's wall, which is {of_median:.3f}"
                             " of the trials' median")
    return record


def phase_triage_multipair(attention, out_dir: str) -> dict:
    """The triage_multipair twin at its defaults (64 pairs of 32 queries,
    256 x 256, zooms 0.5 and 0.25, bfloat16) but TRIAGE_MULTIPAIR_TRIALS
    trials, at seed strides 1 and 4. Gate: the cost centres' calls a trial
    are those the job must make: one seed pass, two image stacks, a squad
    formation for each pair at each zoom level, and at each level one
    dispatch for each group_cap squads of all pairs (the squads counted as
    they are formed); the wrapped dispatch calls over the warm call and the
    trials equal the engine's own dispatch_count."""
    from cotr_tpu_torch.inference import grouped
    from cotr_tpu_torch.tools import triage_multipair

    pairs, levels = 64, 2
    runs = {}
    for stride in (1, 4):
        engines, squads = [], []

        def recording(args, device, build=triage_multipair.build_engine):
            engines.append(build(args, device))
            return engines[-1]

        def forming(*a, form=grouped.form_squads, **kw):
            squad_of, pilots = form(*a, **kw)
            squads.append(len(pilots))
            return squad_of, pilots

        with replaced(triage_multipair, "build_engine", recording), \
                replaced(grouped, "form_squads", forming), \
                counted(attention, {}) as record:
            report = triage_multipair.main(
                ["--ckpt", FLAGSHIP, "--trials",
                 str(TRIAGE_MULTIPAIR_TRIALS), "--seed_stride", str(stride),
                 "--out", os.path.join(out_dir, f"multipair_{stride}.json")],
                device="cuda")
        calls = report["calls_per_trial"]
        dispatches = engines[0]._stepper.dispatch_count
        jobs = TRIAGE_MULTIPAIR_TRIALS + 1
        # squads by (job, level), formed level-major, every pair each level
        per_level = np.asarray(squads).reshape(-1, pairs).sum(axis=1)
        group_cap = engines[0].group_cap
        want_dispatches = [int(-(-g // group_cap)) for g in per_level]
        want = {"dense_seed_s_calls": 1, "image_stack_upload_s_calls": 2,
                "squad_formation_s_calls": pairs * levels,
                "dispatch_enqueue_s_calls": sum(want_dispatches[levels:])
                // TRIAGE_MULTIPAIR_TRIALS}
        record.update(report=report, engine_dispatch_count=dispatches,
                      squads_per_level=per_level.tolist(),
                      expected_calls=want)
        log(f"[triage-multipair] seed_stride {stride}: median wall "
            f"{report['wall_s_median']:.3f} s ({report['q_s']:.0f} "
            f"queries/s); cost centres a trial "
            f"{report['cost_centers_s_per_trial']}, calls {calls} (the job "
            f"needs {want}: squads per level {per_level.tolist()} over "
            f"{jobs} calls, {group_cap} a dispatch), unaccounted "
            f"{report['unaccounted_s']:.3f} s (the device's compute: "
            f"dispatch_enqueue is enqueue time only); the engine's "
            f"dispatch_count {dispatches} over {TRIAGE_MULTIPAIR_TRIALS} + "
            f"1 calls")
        log_counts("triage-multipair", record)
        if len(squads) != jobs * pairs * levels or calls != want \
                or dispatches != sum(want_dispatches) \
                or dispatches != jobs * calls["dispatch_enqueue_s_calls"]:
            raise AssertionError(f"[triage-multipair] stride {stride}: "
                                 f"calls {calls}, the job's {want}, "
                                 f"{len(squads)} squad formations, the "
                                 f"engine's dispatch_count {dispatches}")
        runs[f"seed_stride {stride}"] = record
    return runs


def phase_triage_guided(attention, pair, out_dir: str) -> dict:
    """The triage_guided twin on the serving phase's 768 x 1024 pair (B a
    known homography of A), 2,048 keypoints of each image drawn from a seed
    inside an 8 px margin, the flagship in bfloat16, zooms
    linspace(0.5, 0.0625, 4), TRIAGE_GUIDED_ROUNDS rounds. Gate: every
    answer finite (the twin raises otherwise), the probe's ms above 0, and
    both correlations of the probe with the walls defined and finite."""
    from cotr_tpu_torch.tools import triage_guided

    rng = np.random.RandomState(31)
    paths = {}
    for key, array in [("img_a", pair[0]), ("img_b", pair[1])] + [
            (f"kpts_{side}", np.stack([
                rng.uniform(GUIDED_MARGIN, pair[i].shape[1] - GUIDED_MARGIN,
                            GUIDED_KEYPOINTS),
                rng.uniform(GUIDED_MARGIN, pair[i].shape[0] - GUIDED_MARGIN,
                            GUIDED_KEYPOINTS)], 1).astype(np.float32))
            for i, side in enumerate("ab")]:
        paths[key] = os.path.join(out_dir, f"guided_{key}.npy")
        np.save(paths[key], array)
    argv = ["--rounds", str(TRIAGE_GUIDED_ROUNDS), "--ckpt", FLAGSHIP,
            "--out", os.path.join(out_dir, "guided.json")]
    for key, path in paths.items():
        argv += [f"--{key}", path]
    with counted(attention, {}) as record:
        summary = triage_guided.main(argv, device="cuda")
    record.update(summary=summary)
    log(f"[triage-guided] {TRIAGE_GUIDED_ROUNDS} rounds: probe "
        f"{summary['probe_ms']} ms; multi-pair wall {summary['multipair']} "
        f"s; serial {summary['serial']} s; corr(probe, multi-pair) "
        f"{summary['corr_probe_vs_multipair']}, corr(probe, serial) "
        f"{summary['corr_probe_vs_serial']}")
    log_counts("triage-guided", record)
    correlations = (summary["corr_probe_vs_multipair"],
                    summary["corr_probe_vs_serial"])
    if not (summary["probe_ms"]["min"] > 0
            and summary["multipair"]["speedup_vs_ref_79s"] is None
            and all(c is not None and np.isfinite(c) for c in correlations)):
        raise AssertionError(f"[triage-guided] {summary['probe_ms']}, "
                             f"{summary['multipair']}")
    return record


def phase_bench_loader(out_dir: str) -> dict:
    """The bench_loader twin at the JAX tool's defaults (500 captures of
    240 x 320, batch 24, 20 batches, 4 workers) in the host layout, then in
    the device-synth layout on the same scene. Gate: 20 batches timed, the
    JAX tool's report keys (its TPU step rate aside) and batch keys."""
    from cotr_tpu_torch.tools import bench_loader

    argv = LOADER_ARGV + ["--root", os.path.join(out_dir, "loader_scene")]
    runs = {}
    for device_synth in (False, True):
        t0 = time.perf_counter()
        report = bench_loader.main(
            argv + (["--keep", "--device_synth"] if device_synth else []))
        wall = time.perf_counter() - t0
        name = "device_synth" if device_synth else "host"
        runs[name] = dict(report=report, wall_s=wall)
        log(f"[bench-loader] {name} layout: {report['batches_timed']} "
            f"batches of {report['batch_size']} at "
            f"{report['batches_per_s']:.3f} batches/s, "
            f"{report['samples_per_s']:.1f} samples/s; run wall {wall:.1f} s"
            + ("" if device_synth else " (the scene's 500 captures "
               "written in it)"))
        if not (report["batches_timed"] == 20
                and set(report) == LOADER_REPORT_KEYS
                and report["keys"] == LOADER_BATCH_KEYS[device_synth]):
            raise AssertionError(f"[bench-loader] {name}: {report}")
    return runs


def _processes_with(marker: str) -> list:
    """Live processes, this one aside, whose environment holds ``marker``."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if marker.encode() not in f.read():
                    continue
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(") ", 1)[-1][0] != "Z":
                    found.append(int(pid))
        except OSError:
            continue
    return found


def phase_generated_training(out_dir: str) -> dict:
    """The run_generated_training twin at full width (the flagship warm
    start, 6 + 6 layers, bfloat16, one train scene of 400 captures and a
    held-out one of 100, 240 x 320, batches 24 / 16 / 16, the eval on 6
    pairs of a 24 x 24 grid), cut in iterations only (GENTRAIN_ITERS).
    Gates: stage 1 resumes after its SIGTERM past the validation step; the
    held-out EPE is finite; no process of the run outlives it. The stages
    and the eval run in subprocesses, so their launches are not counted
    here: the stages' validation shapes (GENTRAIN_SHAPES, bfloat16) are
    checked in phase_path_shapes, and the eval's are the squad engine's, as
    in [megadepth-eval]."""
    from cotr_tpu_torch.tools import run_generated_training

    marker = f"COTR_SMOKE_GENTRAIN={os.getpid()}"
    key, value = marker.split("=")
    os.environ[key] = value
    argv = ["--root", os.path.join(out_dir, "gen_scenes"),
            "--out", os.path.join(out_dir, "gen_training"),
            "--init_weights", FLAGSHIP]
    for flag, n in GENTRAIN_ITERS.items():
        argv += [flag, str(n)]
    try:
        t0 = time.perf_counter()
        summary = run_generated_training.main(argv, device="cuda")
        wall = time.perf_counter() - t0
        orphans = _processes_with(marker)
    finally:
        del os.environ[key]
    stage1 = summary["stages"]["stage1"]
    proof = stage1["resume_proof"]
    epe = summary["heldout_eval"]["epe_median"]
    log(f"[generated-training] {wall:.1f} s: stage 1 killed after iter "
        f"{proof['preempted_at']}, resumed at iter "
        f"{proof['resumed_first_val']}; losses (iter, train, val): stage 1 "
        f"{stage1['iters_leg_a'] + stage1['iters_leg_b']}, stage 2 "
        f"{summary['stages']['stage2']['iters']}, stage 3 "
        f"{summary['stages']['stage3']['iters']}; held-out median EPE "
        f"{epe:.2f} px ({summary['heldout_eval'].get('pairs')} pairs); "
        f"processes left: {orphans}. The stages and the eval ran in "
        f"subprocesses: their launches are not counted here (validation "
        f"shapes {GENTRAIN_SHAPES} in bfloat16 are checked with the path "
        f"shapes; the eval's are the squad engine's, as in "
        f"[megadepth-eval])")
    if not (proof["resumed_first_val"] > proof["preempted_at"]
            >= GENTRAIN_ITERS["--valid_iter"] and np.isfinite(epe)
            and not orphans):
        raise AssertionError(f"[generated-training] resume {proof}, EPE "
                             f"{epe}, processes left {orphans}")
    return dict(summary=summary, wall_s=wall)


def start_nn_numpy(config: str) -> dict:
    """[nn-dist]'s reference: the numpy path on NN_SAMPLED cells of
    [megadepth-data]'s scene, drawn from a seed, in a spawned process pool
    started in the background (it overlaps [goldens], which waits on its
    subprocesses). Returns what phase_nn_dist needs."""
    from cotr_tpu_torch.tools import prepare_nn_distance_mat as nn_dist

    with open(config) as f:
        raw = json.load(f)
    sdd = raw["scenes_name_list"][0]
    scene_args = (sdd["scene_dir"], sdd["image_dir"], sdd["depth_dir"],
                  raw["valid_list_json"], "no_crop")
    n = len(nn_dist.read_scene(scene_args).captures)
    cells = [(i, j) for i in range(n) for j in range(n) if i != j]
    rng = np.random.RandomState(17)
    sampled = [cells[k] for k in rng.choice(len(cells), NN_SAMPLED,
                                            replace=False)]

    def run():
        t0 = time.perf_counter()
        out = nn_dist.numpy_cells(scene_args, sampled, NN_PROCESSES)
        return out, time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return dict(scene_args=scene_args, n=n, sampled=sampled, future=future)


def phase_nn_dist(reference: dict, out_dir: str) -> dict:
    """The prepare_nn_distance_mat twin on [megadepth-data]'s scene (48
    views of 768 x 1024): the whole 48 x 48 matrix on the card. Gates: on
    NN_SAMPLED cells the numpy path (``start_nn_numpy``) agrees exactly but
    on NN_INEXACT and within NN_TOL on all; two --cells invocations give
    the matrix one gives; a second run gives it bit for bit."""
    from cotr_tpu_torch.tools import prepare_nn_distance_mat as nn_dist

    scene_dir, image_dir, depth_dir, valid_list, _ = reference["scene_args"]
    base = ["--scene_dir", scene_dir, "--image_dir", image_dir,
            "--depth_dir", depth_dir, "--valid_list", valid_list]

    def run(name, *extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist = nn_dist.main(base + ["--out", os.path.join(
            out_dir, f"{name}.npy"), *extra], device="cuda")
        torch.cuda.synchronize()
        return dist, time.perf_counter() - t0

    whole, wall = run("whole")
    n = whole.shape[0]
    run("split", "--cells", str(NN_SPLIT))
    split, _ = run("split")
    again, again_wall = run("again")
    want, numpy_wall = reference["future"].result()
    sampled = reference["sampled"]
    dev = [abs(float(whole[c]) - float(np.float32(want[c]))) for c in sampled]
    exact = sum(d == 0.0 for d in dev)
    off = whole[~np.eye(n, dtype=bool)]
    record = dict(views=n, cells=n * (n - 1), wall_s=wall,
                  second_wall_s=again_wall, numpy_cells=NN_SAMPLED,
                  numpy_wall_s=numpy_wall, exact=exact,
                  max_abs_dev=max(dev), split_equal=bool(
                      split.tobytes() == whole.tobytes()),
                  repeat_equal=bool(again.tobytes() == whole.tobytes()),
                  mean_iou=float(off.mean()), max_iou=float(off.max()))
    log(f"[nn-dist] {n} x {n} matrix of [megadepth-data]'s scene, "
        f"{record['cells']} cells on the card in {wall:.2f} s (again "
        f"{again_wall:.2f} s; the reads of {n} depths included); numpy on "
        f"{NN_SAMPLED} sampled cells in a pool of {NN_PROCESSES}: "
        f"{numpy_wall:.2f} s (beside [goldens]); equal on {exact} of "
        f"{NN_SAMPLED}, largest deviation {max(dev):.3e}; --cells "
        f"{NN_SPLIT} then the rest equal to one run: "
        f"{record['split_equal']}; a second run bit for bit: "
        f"{record['repeat_equal']}; off-diagonal IoU mean "
        f"{record['mean_iou']:.4f}, largest {record['max_iou']:.4f}")
    if not (exact >= NN_SAMPLED - NN_INEXACT and max(dev) <= NN_TOL
            and record["split_equal"] and record["repeat_equal"]
            and whole.min() >= 0 and record["max_iou"] > 0):
        raise AssertionError(f"[nn-dist] {record}")
    return record


def phase_goldens(demo_dir: str) -> dict:
    """The make_demo_goldens twin with --only demo_single_pair and
    --only demo_wbs, each given [demos]' generated inputs after "--"
    (GOLDEN_INPUTS; the single pair without --densify, which adds nothing
    to the picture), in float32 as [demos] ran them, the two invocations at
    once: compare_to_golden passes against the pictures [demos] wrote for
    the same inputs. The demos run in subprocesses: their launches are
    [demos]' shapes, counted there."""
    from cotr_tpu_torch.demos.demo_utils import read_png
    from cotr_tpu_torch.tools import make_demo_goldens

    golden_dir = os.path.join(demo_dir, "goldens")

    def make(name):
        t0 = time.perf_counter()
        (path,) = make_demo_goldens.main(
            ["--weights", FLAGSHIP, "--dtype", "float32", "--only", name,
             "--out_dir", golden_dir, "--", *GOLDEN_INPUTS[name][0]],
            device="cuda")
        return path, time.perf_counter() - t0

    # the demos resolve their inputs from the directory they start in
    with contextlib.chdir(demo_dir), \
            concurrent.futures.ThreadPoolExecutor(len(GOLDEN_INPUTS)) as pool:
        made = dict(zip(GOLDEN_INPUTS, pool.map(make, GOLDEN_INPUTS)))
    runs = {}
    for name, (path, wall) in made.items():
        demos_png = GOLDEN_INPUTS[name][1]
        verdict = make_demo_goldens.compare_to_golden(
            read_png(path), read_png(os.path.join(demo_dir, demos_png)))
        runs[name] = dict(verdict, wall_s=wall, path=path)
        log(f"[goldens] {name}: {wall:.1f} s (a subprocess on the card, "
            f"beside the other); against [demos]' {demos_png}: {verdict}")
        if not verdict["ok"]:
            raise AssertionError(f"[goldens] {name}: {verdict}")
    return runs


def phase_side_by_side(demo_dir: str, goldens: dict) -> dict:
    """The make_side_by_side twin on the goldens and [demos]' pictures in
    the place of the reference's (the single-pair pair; the others are
    absent and skipped, as the JAX tool skips them). Gate: the composite's
    shape as the JAX tool computes it."""
    from cotr_tpu_torch.demos.demo_utils import read_png
    from cotr_tpu_torch.tools import make_side_by_side

    ref_dir = os.path.join(demo_dir, "reference")
    os.makedirs(ref_dir)
    os.symlink(os.path.join(demo_dir, "sparse_output.png"),
               os.path.join(ref_dir, "sparse_output.png"))
    ours = os.path.dirname(goldens["demo_single_pair"]["path"])
    made = make_side_by_side.main(["--ours", ours, "--ref", ref_dir,
                                   "--out", os.path.join(demo_dir, "sbs")])
    (path,) = made
    got = read_png(path).shape
    h_ours, w_ours = read_png(os.path.join(ours, "demo_single_pair.png")
                              ).shape[:2]
    h_ref, w_ref = read_png(os.path.join(ref_dir, "sparse_output.png")
                            ).shape[:2]
    want = (360 + 22, int(round(w_ours * 360 / h_ours)) + 8
            + int(round(w_ref * 360 / h_ref)), 3)
    log(f"[side-by-side] {len(made)} composite, {got} (the JAX tool's rule "
        f"gives {want}); the four pairs without files skipped")
    if got != want:
        raise AssertionError(f"[side-by-side] {got} != {want}")
    return dict(path=path, shape=list(got))


def merged_shape_counts(records) -> list:
    total = {}
    for record in records:
        for row in record["shape_counts"]:
            key = (row["b"], row["lq"], row["s"], row["dtype"])
            total[key] = total.get(key, 0) + row["launches"]
    return [dict(b=b, lq=lq, s=s, dtype=dtype, launches=n)
            for (b, lq, s, dtype), n in sorted(total.items())]


def kernel_entry(name, kernel, keep, timed, rows, shape_counts,
                 paths) -> dict:
    """The ``kernels`` line's entry of the kernel whose shapes ``keep``
    selects (``kernel``: its CUDA function): its launches on the paths
    (raises if none), its largest error at its checked shapes, its times at
    (B, Lq) = ``timed``. The exp floor stays in the log and in
    ``chip_smoke.json``: it is computed, not measured."""
    counts = [r for r in shape_counts if keep(r)]
    launches = sum(r["launches"] for r in counts)
    if launches < 1:
        raise AssertionError(f"the paths launched no {name} kernel")
    shapes = [{k: x for k, x in r.items() if k != "exp_floor_ms"}
              for r in rows if keep(r)]
    main_row = next(r for r in shapes if (r["b"], r["lq"]) == timed)
    return dict(
        name=name, kernel=kernel, route="cuda",
        source="cotr_tpu_torch/csrc/attention.cu",
        replaces="cotr_tpu/ops/pallas_attention.py:70",
        dtype=main_row["dtype"],
        launches=launches, shape_counts=counts,
        launches_by_path={k: sum(r["launches"] for r in p["shape_counts"]
                                 if keep(r)) for k, p in paths.items()},
        max_abs_err=max(r["max_abs_err"] for r in shapes),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
        **{k: main_row[k] for k in ("graph_ms", "graph_library_ms")
           if k in main_row},
        timed_at=f"B={timed[0]} Lq={timed[1]} S={main_row['s']} H=8 hd=32 "
                 f"{main_row['dtype']}", shapes=shapes)


def main() -> int:
    started = time.perf_counter()
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
    from cotr_tpu_torch.training import optim as optim_mod
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
        PrefetchLoader=PrefetchLoader, PhaseTimer=PhaseTimer,
        optim=optim_mod)

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
    from cotr_tpu_torch.models.cotr import init_weights
    from cotr_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from cotr_tpu_torch.tools import bench_sharded

    # the parallel phases' entry points
    par = types.SimpleNamespace(
        make_mesh=make_mesh, init_distributed=init_distributed,
        FasterSparseEngine=FasterSparseEngine, SparseEngine=SparseEngine,
        bench_sharded=bench_sharded, init_weights=init_weights,
        create_train_state=train_step_mod.create_train_state,
        make_train_step=train_step_mod.make_train_step)
    par_serve = phase_parallel_serve(attention, par, runner, big_pair)
    del runner
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, "build")) as triage_dir:
        triage_dense = phase_triage_dense(attention)
        triage_multipair = phase_triage_multipair(attention, triage_dir)
        triage_guided = phase_triage_guided(attention, big_pair, triage_dir)
    torch.cuda.empty_cache()
    train_parity = phase_train_parity(load_model, COTRConfig(), loss_mod,
                                      train_step_mod, TrainConfig())
    batch = on_card(make_train_batch(np.random.RandomState(7), 24,
                                     TrainConfig().num_kp))
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, "build")) as out_dir:
        trainer, train = phase_train(attention, mods, batch, out_dir)
        eval_step = phase_eval_step(attention, mods, trainer, batch)
        checkpoint = phase_checkpoint(attention, mods, trainer, batch,
                                      out_dir)
        convert = phase_convert(attention, mods, os.path.join(
            out_dir, "checkpoints", "checkpoint.pt"), out_dir)
        del trainer
        torch.cuda.empty_cache()
        par_train = phase_parallel_train(attention, mods, par, batch)
        del batch
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
        nn_reference = start_nn_numpy(config)
        goldens = phase_goldens(demo_dir)
        side_by_side = phase_side_by_side(demo_dir, goldens)
        nn_dist = phase_nn_dist(nn_reference, md_dir)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, "build")) as suite_dir:
        suite = phase_eval_suite(attention, suite_dir)
        bench_loader = phase_bench_loader(suite_dir)
        gen_training = phase_generated_training(suite_dir)
    # last: the profiler's CUDA tracing (CUPTI) stays out of every timed
    # phase before it
    from cotr_tpu_torch.inference import dense
    from cotr_tpu_torch.utils.profiling import trace
    runner = ModelRunner(load_model(FLAGSHIP, COTRConfig(), device="cuda"),
                         device="cuda")
    dense_record = phase_dense_pass(attention, dense, runner, sampling,
                                    trace)
    del runner
    if file_digest(FLAGSHIP) != flagship_digest:
        raise AssertionError("checkpoints/flagship.npz changed during the "
                             "run")
    # each path's own run; the comparison runs beside them (scan engine on
    # the squad phase's queries, the serial calls, the einsum evaluation)
    # are left out, and so is serving the trained weights, which repeats
    # the scan engine's shapes
    paths = {"scan engine, 3 pairs": serve,
             "dense_pass, one square pair": dense_record,
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
                 suite["diagnose-tail"],
             "squad engine on a mesh of cuda:0 x 2, 2,000 queries":
                 par_serve["squad"],
             "multi-pair on the mesh, 8 pairs x 32 queries":
                 par_serve["multipair"],
             "cycle-consistent scan engine on the mesh, 1 pair":
                 par_serve["scan"],
             "bench_sharded twin, N = 2": par_serve["bench"],
             "train steps of [parallel-train], 5 x 5 (the einsum path)":
                 par_train,
             f"triage_dense twin, 1 + {TRIAGE_DENSE_TRIALS} dense_flow calls "
             f"and {TRIAGE_DENSE_TRIALS} split calls": triage_dense,
             **{f"triage_multipair twin, 64 pairs x 32 queries, {tag}": run
                for tag, run in triage_multipair.items()},
             f"triage_guided twin, 1 + {TRIAGE_GUIDED_ROUNDS} rounds":
                 triage_guided}
    shape_counts = merged_shape_counts(paths.values())
    # the generated-training stages' validation shapes: launched in their
    # subprocesses, so checked here without a count
    counted_keys = {(r["b"], r["lq"], r["s"], r["dtype"])
                    for r in shape_counts}
    subprocess_shapes = [dict(b=b, lq=lq, s=512, dtype="bfloat16")
                         for b, lq in GENTRAIN_SHAPES
                         if (b, lq, 512, "bfloat16") not in counted_keys]
    rows += phase_path_shapes(attention, shape_counts + subprocess_shapes,
                              rows)

    # one entry a kernel, each with its own launches (they sum to the
    # paths'): the float32 and bfloat16 tile kernels (wgmma) and the row
    # kernel in each dtype
    def kind(r):
        return r["dtype"], attention.choose_kernel(
            r["lq"], r["s"], getattr(torch, r["dtype"]))

    kernels = [
        kernel_entry(f"flash_cross_attention, {dtype} {variant}", symbol,
                     lambda r, key=(dtype, variant): kind(r) == key, timed,
                     rows, shape_counts, paths)
        for dtype, variant, symbol, timed in (
            ("float32", "tile", "attention_kernel_tile_f32", (8, 8192)),
            ("float32", "row", "attention_kernel_row<float>", (256, 1)),
            ("bfloat16", "tile", "attention_kernel_tile_bf16", (8, 8192)),
            ("bfloat16", "row", "attention_kernel_row<__nv_bfloat16>",
             (256, 1)))]
    kernels += adam_kernel_entries(train)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, build=build, crops=crops, forward=forward,
                       serve_wall_s=serve["wall_s"], serve=serve,
                       dense_pass=dense_record,
                       squad=squad, multipair=multipair,
                       train_parity=train_parity, train=train,
                       eval_step=eval_step, checkpoint=checkpoint,
                       synthetic_loader=synth_loader,
                       synthetic_train=synth_train,
                       synthetic_eval=synth_eval, megadepth_data=md_data,
                       device_synth=md_synth, megadepth_train=md_train,
                       megadepth_eval=md_eval, convert=convert,
                       demos=demos, eval_suite=suite,
                       parallel_serve=par_serve, parallel_train=par_train,
                       triage_dense=triage_dense,
                       triage_multipair=triage_multipair,
                       triage_guided=triage_guided,
                       bench_loader=bench_loader,
                       generated_training=gen_training, nn_dist=nn_dist,
                       goldens=goldens, side_by_side=side_by_side,
                       kernel_shapes=rows, kernels=kernels),
                  f, indent=1)
    log(f"[serve] wall {serve['wall_s']:.3f} s; [dense-pass] "
        f"{dense_record['phase_s']:.2f} s; [grouped] wall "
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
        f"[diagnose-tail] {suite['diagnose-tail']['wall_s']:.2f} s; "
        f"[parallel-serve] squad engine on the mesh "
        f"{par_serve['squad']['wall_s']:.2f} s (unsharded "
        f"{par_serve['squad']['unsharded_wall_s']:.2f} s); [parallel-train] "
        f"{par_train['dp']['ms_per_step']:.1f} ms a DP step, "
        f"{par_train['dp + zero1']['ms_per_step']:.1f} ms with ZeRO-1, "
        f"{par_train['unsharded']['ms_per_step']:.1f} ms unsharded; "
        f"[triage-dense] median {triage_dense['report']['median_s']:.3f} s; "
        f"[triage-multipair] "
        + ", ".join(f"{tag} {run['report']['wall_s_median']:.3f} s"
                    for tag, run in triage_multipair.items())
        + f"; [triage-guided] multi-pair median "
        f"{triage_guided['summary']['multipair']['median']:.3f} s; "
        f"[bench-loader] "
        + ", ".join(f"{tag} {run['report']['samples_per_s']:.1f} samples/s"
                    for tag, run in bench_loader.items())
        + f"; [generated-training] {gen_training['wall_s']:.1f} s; "
        f"[nn-dist] {nn_dist['wall_s']:.2f} s for {nn_dist['cells']} cells")
    log(f"[chip_smoke] {time.perf_counter() - started:.1f} s from its "
        f"start to its last line")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
