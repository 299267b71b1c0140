#!/usr/bin/env python3
"""Where a tile kernel's time goes, phase by phase, on the card.

    python3 profile_attention.py [--dtype bfloat16] [--shapes 8x8192,256x512]
        [--tile-rows 128]

Neither Nsight tool runs on the card's machine, so this builds
``cotr_tpu_torch/csrc/attention.cu`` into ``build/`` with its phase clocks
on (the ``PHASE_CLOCK*`` macros, empty in every other build), which read
``clock64()`` at each phase boundary: in bfloat16 of the one-exp path
(``bf16_tile_staged`` and the step's staging in
``attention_kernel_tile_bf16``), in float32 of the two computing
warpgroups of ``attention_kernel_tile_f32`` (``f32_consume``). Thread 0 of
each warpgroup of block 0 adds each phase's SM clocks into shared memory,
and the block writes them out at its end. It prints, for each shape, the
clocks in each phase and warpgroup (block 0's sums over its steps): in
bfloat16 those of one 64-row tile, in float32 those of one step (a
warpgroup's 64 rows against the step's chunks) and of one chunk; and the
card's name and power limit. The reads cost a few tens of clocks a phase.

``--wgmma-rate`` measures instead what the float32 kernel's products can
reach: chains of TF32 wgmma as the kernel issues them (12 m64n64k8 steps,
A from registers or from shared memory; 24 m64n32k8), by one warpgroup of
an SM and by two at once, on every SM, in SM clocks a chain and
multiply-adds a clock an SM against the TF32 peak of 1,024.
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
PHASES_F32 = ["step: split q, fetch the next", "wait for a staged chunk",
              "q k^T (12 wgmma, waited)", "maxima, exps, split p",
              "p v (16 wgmma, waited), rescale",
              "store, or merge the two halves"]
# the staging warpgroup of the float32 kernel (its thread 0)
PHASES_F32_STAGER = ["stager: wait for a free stage",
                     "stager: split, store a chunk"]
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
__shared__ unsigned long long prof_clk[48];
__device__ unsigned long long prof_out[48];
#define PHASE_CLOCK_START() long long phase_t_ = clock64()
#define PHASE_CLOCK(i) { const long long t2_ = clock64(); \\
  asm volatile("{\\n.reg .pred p;\\nsetp.eq.u32 p, %0, 0;\\n" \\
               "@p red.shared.add.u64 [%1], %2;\\n}" \\
               :: "r"(threadIdx.x % kWgThreads), \\
                  "r"(smem_addr(&prof_clk[th.wg * 16 + (i)])), \\
                  "l"(t2_ - phase_t_) : "memory"); \\
  phase_t_ = t2_; }
#define PHASE_CLOCKS_CLEAR() { if (threadIdx.x < 48) \\
  prof_clk[threadIdx.x] = 0; __syncthreads(); }
#define PHASE_CLOCKS_WRITE() { __syncthreads(); \\
  if (blockIdx.x == 0 && threadIdx.x < 48) \\
    prof_out[threadIdx.x] = prof_clk[threadIdx.x]; }
#include "SOURCE_PATH"
extern "C" int cotr_profile_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, prof_out, 48 * 8);
}
"""


# chains of the float32 kernel's products on every SM (--wgmma-rate), built
# after the kernel's source for its wgmma wrappers
WGMMA_RATE = """#include "SOURCE_PATH"
namespace {
__device__ __forceinline__ void ss_n64(float (&d)[32], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %34, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\\n}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
// kMode 0: 12 x m64n64k8, A from registers; 1: the same, A from shared
// memory; 2: 24 x m64n32k8, A from registers
template <int kMode>
__global__ void __launch_bounds__(256, 1)
wgmma_rate(unsigned long long* out, int iters, int active) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(base);
  for (int i = threadIdx.x; i < 16384; i += blockDim.x)
    reinterpret_cast<float*>(base)[i] = 0.0f;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg >= active) return;
  float d[32];
  uint32_t a[4][4];
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) a[i][j] = 0u;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
    if (kMode == 0) {
#pragma unroll
      for (int s = 0; s < 12; ++s)
        wgmma_tf32_n64(d, a[s % 4], desc_sw128(sb + 8192 + 32 * (s % 4)), 1);
    } else if (kMode == 1) {
#pragma unroll
      for (int s = 0; s < 12; ++s)
        ss_n64(d, desc_sw128(sb + 32 * (s % 4)),
               desc_sw128(sb + 8192 + 32 * (s % 4)));
    } else {
#pragma unroll
      for (int s = 0; s < 24; ++s)
        wgmma_tf32_n32(*reinterpret_cast<float(*)[16]>(d), a[s % 4],
                       desc_sw128(sb + 8192 + 32 * (s % 4)), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(d);
  }
  const long long t1 = clock64();
  if (threadIdx.x % 128 == 0 && blockIdx.x == 0) out[wg] = t1 - t0;
  if (d[0] == 12345.0f) out[4] = 1;  // keeps the products
}
template <int kMode>
cudaError_t launch_rate(unsigned long long* out, int iters, int active) {
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_rate<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  if (e != cudaSuccess) return e;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  wgmma_rate<kMode><<<sms, 256, 65536>>>(out, iters, active);
  return cudaGetLastError();
}
}  // namespace
extern "C" int cotr_wgmma_rate(int mode, int active, int iters,
                               unsigned long long* host) {
  unsigned long long* dev = nullptr;
  cudaError_t e = cudaMalloc(&dev, 8 * 8);
  if (e != cudaSuccess) return (int)e;
  cudaMemset(dev, 0, 8 * 8);
  e = mode == 0 ? launch_rate<0>(dev, iters, active)
      : mode == 1 ? launch_rate<1>(dev, iters, active)
                  : launch_rate<2>(dev, iters, active);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpy(host, dev, 8 * 8, cudaMemcpyDeviceToHost);
  cudaFree(dev);
  return (int)e;
}
"""


def wgmma_rate() -> None:
    lib = ctypes.CDLL(build(WGMMA_RATE, "wgmma_rate"))
    host = (ctypes.c_ulonglong * 8)()
    iters = 2000
    fma = 12 * 64 * 64 * 8  # a chain's multiply-adds, every form
    for mode, name in enumerate(("12 x m64n64k8, A in registers",
                                 "12 x m64n64k8, A in shared memory",
                                 "24 x m64n32k8, A in registers")):
        for active in (1, 2):
            err = lib.cotr_wgmma_rate(mode, active, iters, host)
            if err != 0:
                raise RuntimeError(f"wgmma_rate failed: CUDA error {err}")
            per = [host[w] / iters for w in range(active)]
            print(f"[wgmma-rate] {name}, {active} warpgroup(s) an SM: SM "
                  f"clocks a chain {', '.join(f'{x:.0f}' for x in per)}; "
                  f"{fma * active / max(per):.0f} multiply-adds a clock an "
                  f"SM (TF32 peak 1024)", flush=True)


def build(prelude: str = PRELUDE, name: str = "attention_profiled") -> str:
    src = prelude.replace("SOURCE_PATH", SOURCE)
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"libcotr_{name}.so")
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, path], check=True)
    return lib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", default="8x8192,4x8192,256x512,128x257")
    parser.add_argument("--tile-rows", type=int, default=128)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32"))
    parser.add_argument("--wgmma-rate", action="store_true")
    args = parser.parse_args(argv)
    f32 = args.dtype == "float32"
    phases = PHASES_F32 if f32 else PHASES
    if not torch.cuda.is_available():
        print("profile_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cotr_tpu_torch.ops import attention
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    if args.wgmma_rate:
        wgmma_rate()
        return 0
    lib = ctypes.CDLL(build())
    fn = lib.cotr_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    attention._lib = lib  # the wrapper launches the profiled copy
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clocks = (ctypes.c_ulonglong * 48)()
    for shape in args.shapes.split(","):
        b, lq = (int(x) for x in shape.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(
            getattr(torch, args.dtype)) for s in ((b, lq, 8, 32),
                                                  (b, 512, 8, 32),
                                                  (b, 512, 8, 32)))
        with torch.no_grad():
            attention.flash_cross_attention(q, k, v,
                                            tile_rows=args.tile_rows)
        torch.cuda.synchronize()
        if lib.cotr_profile_read(clocks) != 0:
            raise RuntimeError("could not read the clocks")
        # block 0's steps: the first of the sequence (batch, head, row
        # tile), as the kernel shares them out
        row_tiles = -(-lq // args.tile_rows)
        steps = b * 8 * row_tiles
        grid = min(steps, sms)
        mine = steps // grid + (steps % grid > 0)
        if f32:
            # a warpgroup's 64 rows a step, against every chunk of 64 keys
            # (128 rows a step) or every other one (64)
            tiles = mine
            chunks = 512 // 64 // (2 if args.tile_rows == 64 else 1)
            unit = f"one step ({chunks} chunks of 64 keys a warpgroup)"
        else:
            tiles = sum(-(-min(args.tile_rows, lq - j % row_tiles
                               * args.tile_rows) // 64)
                        for j in range(mine))
            unit = "one 64-row tile"
        print(f"B={b} Lq={lq} S=512 H=8 {args.dtype} tile_rows="
              f"{args.tile_rows}: SM clocks of {unit} by phase (block 0, "
              f"{tiles} {'steps' if f32 else 'tiles'}; warpgroup 0, "
              f"warpgroup 1)")
        for i, name in enumerate(phases):
            per = [clocks[w * 16 + i] / tiles for w in range(2)]
            print(f"  {name:32s} {per[0]:9.0f} {per[1]:9.0f}")
        totals = [sum(clocks[w * 16 + i] for i in range(len(phases)))
                  / tiles for w in range(2)]
        print(f"  {'total':32s} {totals[0]:9.0f} {totals[1]:9.0f}")
        if f32:
            print(f"  {'total a chunk':32s} {totals[0] / chunks:9.0f} "
                  f"{totals[1] / chunks:9.0f}")
            for i, name in enumerate(PHASES_F32_STAGER):
                print(f"  {name:32s} {clocks[32 + i] / tiles:9.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
