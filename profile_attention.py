#!/usr/bin/env python3
"""Where the bfloat16 tile kernel's time goes, phase by phase, on the card.

    python3 profile_attention.py [--shapes 8x8192,256x512] [--tile-rows 128]

Neither Nsight tool runs on the card's machine, so this builds
``cotr_tpu_torch/csrc/attention.cu`` into ``build/`` with its phase clocks
on (the ``PHASE_CLOCK*`` macros, empty in every other build), which read
``clock64()`` at each phase boundary of the one-exp path
(``bf16_tile_staged`` and the step's staging in
``attention_kernel_tile_bf16``): thread 0 of each warpgroup of block 0 adds
each phase's SM clocks into shared memory, and the block writes them out at
its end. It prints, for each shape, the clocks of one 64-row tile in each
phase and warpgroup (block 0's sums over its tiles), and the card's name
and power limit. The reads cost a few tens of clocks a phase.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "cotr_tpu_torch", "csrc", "attention.cu")
PHASES = ["q k^T, first half (waited)", "first half: maxima, exps",
          "q k^T, second half (rest)", "second half: maxima, exps",
          "barrier: maxima and sums", "halves' factors",
          "pack p to bf16, issue p v", "p v (rest of the wait)",
          "partial output to smem", "barrier: partials",
          "sum partials, store", "step: stage q, wait"]

# the kernel's phase clocks (PHASE_CLOCK* in the source): thread 0 of each
# warpgroup adds the clocks since the last boundary into shared memory, and
# block 0 writes them out at its end
PRELUDE = """#include <cuda_runtime.h>
#define COTR_PROFILE_PHASES
__shared__ unsigned long long prof_clk[32];
__device__ unsigned long long prof_out[32];
#define PHASE_CLOCK_START() long long phase_t_ = clock64()
#define PHASE_CLOCK(i) { const long long t2_ = clock64(); \\
  if (threadIdx.x % kWgThreads == 0) \\
    prof_clk[th.wg * 16 + (i)] += t2_ - phase_t_; \\
  phase_t_ = t2_; }
#define PHASE_CLOCKS_CLEAR() { if (threadIdx.x < 32) \\
  prof_clk[threadIdx.x] = 0; __syncthreads(); }
#define PHASE_CLOCKS_WRITE() { __syncthreads(); \\
  if (blockIdx.x == 0 && threadIdx.x < 32) \\
    prof_out[threadIdx.x] = prof_clk[threadIdx.x]; }
#include "SOURCE_PATH"
extern "C" int cotr_profile_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, prof_out, 32 * 8);
}
"""


def build() -> str:
    src = PRELUDE.replace("SOURCE_PATH", SOURCE)
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "attention_profiled.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, "libcotr_attention_profiled.so")
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, path], check=True)
    return lib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", default="8x8192,4x8192,256x512,128x257")
    parser.add_argument("--tile-rows", type=int, default=128)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cotr_tpu_torch.ops import attention
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    lib = ctypes.CDLL(build())
    fn = lib.cotr_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    attention._lib = lib  # the wrapper launches the profiled copy
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clocks = (ctypes.c_ulonglong * 32)()
    for shape in args.shapes.split(","):
        b, lq = (int(x) for x in shape.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
                   for s in ((b, lq, 8, 32), (b, 512, 8, 32),
                             (b, 512, 8, 32)))
        with torch.no_grad():
            attention.flash_cross_attention(q, k, v,
                                            tile_rows=args.tile_rows)
        torch.cuda.synchronize()
        if lib.cotr_profile_read(clocks) != 0:
            raise RuntimeError("could not read the clocks")
        # block 0's tiles of 64 rows: the first steps of the sequence
        # (batch, head, row tile), as the kernel shares them out
        row_tiles = -(-lq // args.tile_rows)
        steps = b * 8 * row_tiles
        grid = min(steps, sms)
        tiles = sum(-(-min(args.tile_rows, lq - j % row_tiles
                           * args.tile_rows) // 64)
                    for j in range(steps // grid + (steps % grid > 0)))
        print(f"B={b} Lq={lq} S=512 H=8 tile_rows={args.tile_rows}: SM "
              f"clocks of one 64-row tile by phase (block 0, {tiles} tiles;"
              f" warpgroup 0, warpgroup 1)")
        for i, name in enumerate(PHASES):
            per = [clocks[w * 16 + i] / tiles for w in range(2)]
            print(f"  {name:26s} {per[0]:9.0f} {per[1]:9.0f}")
        totals = [sum(clocks[w * 16 + i] for i in range(len(PHASES)))
                  / tiles for w in range(2)]
        print(f"  {'total':26s} {totals[0]:9.0f} {totals[1]:9.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
