#!/usr/bin/env python3
"""Time the attention kernels of two checkouts side by side on one card.

    python3 compare_attention.py OTHER_CHECKOUT [--dtype bfloat16]
        [--shapes 1x512,1x8192] [--rounds 1]

Runs ``chip_smoke.check_shape`` (the kernel against its plain version, its
time beside SDPA's, the bound, the exp floor and the kernel's graph-replay
device time, in bfloat16 SDPA's too) at every shape of
``chip_smoke.SHAPES`` plus ``EXTRA_SHAPES`` (or at ``--shapes``, each
BxLq, S = 512) for
OTHER_CHECKOUT's kernels, this checkout's, this checkout's again and
OTHER_CHECKOUT's again, each in a process of its own (both checkouts hold a
package of the same name), so that drift on the card shows; ``--rounds``
repeats that order. ``check_shape`` comes from this checkout every time;
each checkout builds its own ``csrc/attention.cu`` into its own ``build/``.

With ``--shapes`` it also splits each shape's back-to-back time
(``host_split``): the host's cost of a call, and the device's time a call
when the calls queue up, outside a graph; and the host's cost of the C
launch alone (``raw_call``), for this dtype's tile kernel and float32's.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# shapes the paths launch beyond chip_smoke.SHAPES, by dtype
EXTRA_SHAPES = {"bfloat16": [(4, 512), (16, 512), (16, 200)],
                "float32": [(64, 512), (2, 8192), (16, 512)]}
# SM clocks of the spin the calls queue behind: 0.1 s at 1.98 GHz, longer
# than the host takes to enqueue them
SPIN_CLOCKS = 200_000_000

_RUN = """
import sys
sys.path.insert(0, {checkout!r})
from cotr_tpu_torch.ops import attention
sys.path[0] = {root!r}  # chip_smoke from this checkout, whichever is timed
import chip_smoke, compare_attention, torch
torch.backends.cuda.matmul.allow_tf32 = False
rate = chip_smoke.exp_rate_per_s()
shapes = {shapes!r}
for label, b, lq in shapes or chip_smoke.SHAPES + [
        ("launched on a path", b, lq) for b, lq in {extra!r}]:
    chip_smoke.check_shape(attention, label, b, lq, {dtype!r}, rate)
    if shapes:
        compare_attention.log_host_split(attention, b, lq, {dtype!r})
"""


def host_split(fn, calls: int = 200) -> tuple:
    """(host ms, queued device ms) a call of ``fn``: the calls are enqueued
    behind a spin of the card's, so the host never waits for the card and
    the card runs them back to back once the spin ends; the host's clock
    over the enqueueing, CUDA events around the calls. Raises if the spin
    ended before the last call was enqueued."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CLOCKS)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    covered = not start.query()
    end.record()
    end.synchronize()
    if not covered:
        raise RuntimeError("the spin ended before the calls were enqueued")
    return host_ms, start.elapsed_time(end) / calls


def raw_call(attention, q, k, v, tile_rows):
    """The C entry point alone, its arguments made once: the host's cost of
    the launch without the wrapper's Python."""
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    b, lq, h, hd = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq,
            k.shape[1], h, hd, int(q.dtype == torch.bfloat16), strides,
            1.0 / math.sqrt(hd), tile_rows,
            torch.cuda.current_stream().cuda_stream)
    fn = attention._library().cotr_flash_attention

    def call():
        if fn(*args) != 0:
            raise RuntimeError("launch failed")
    return call, out


def log_host_split(attention, b, lq, dtype, s=512) -> None:
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(b * 131 + lq)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, dtype)) for shape in ((b, lq, 8, 32), (b, s, 8, 32),
                                             (b, s, 8, 32)))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel = host_split(lambda: attention.flash_cross_attention(q, k, v))
    sdpa = host_split(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    # the C launch alone: this dtype's tile kernel at its tile height, and
    # the float32 tile kernel on the same inputs in float32
    call, out = raw_call(attention, q, k, v, attention.TILE_ROWS[q.dtype])
    raw = host_split(call)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    call32, out32 = raw_call(attention, q32, k32, v32, 64)
    raw32 = host_split(call32)
    torch.cuda.synchronize()  # the calls wrote out and out32
    del out, out32
    t0 = time.perf_counter()
    for _ in range(1000):
        torch.cuda.current_device()
    get_device_ms = (time.perf_counter() - t0) * 1e3 / 1000
    print(f"[host] B={b:<4d} Lq={lq:<5d} {dtype}: kernel host "
          f"{kernel[0]:.4f} ms a call, queued device {kernel[1]:.4f} ms; "
          f"sdpa host {sdpa[0]:.4f} ms, queued device {sdpa[1]:.4f} ms; "
          f"C launch alone: {dtype} tile {raw[0]:.4f} ms, float32 tile "
          f"{raw32[0]:.4f} ms; torch.cuda.current_device() "
          f"{get_device_ms:.4f} ms", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--shapes", default="")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    other = os.path.abspath(args.other)
    shapes = [("shape", *(int(x) for x in shape.split("x")))
              for shape in args.shapes.split(",") if shape]
    for _ in range(args.rounds):
        for tag, checkout in (("other", other), ("this", ROOT),
                              ("this", ROOT), ("other", other)):
            print(f"[compare] {tag}: {checkout}", flush=True)
            subprocess.run([sys.executable, "-c", _RUN.format(
                checkout=checkout, root=ROOT, shapes=shapes,
                extra=EXTRA_SHAPES[args.dtype], dtype=args.dtype)],
                check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
