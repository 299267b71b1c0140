"""A profiler trace, a host wall-clock phase timer and a chained per-op
time (counterparts of ``trace``, ``PhaseTimer`` and ``chained_op_time`` in
cotr_tpu/utils/profiling.py), and the spans the port marks its layers with.
Device timelines come from ``torch.profiler`` and CUDA events
(profile_serve.py, profile_train.py, chip_smoke.py)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks one layer's work as ``name`` in a profiler
    trace: ``torch.profiler.record_function(name)`` while a torch
    profiler collects (:func:`trace`, or any ``torch.profiler.profile``), so
    the span sits on the clock of the card's kernels; otherwise one shared
    no-op context, which costs well under a microsecond. A span adds no
    synchronize and draws from no random stream."""
    if getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the body (CPU activity, and the
    card's where there is one) and write it into ``log_dir`` as a Chrome
    trace, ``<pid>.<ns>.pt.trace.json`` (Perfetto or chrome://tracing read
    it), also when the body raises. Yields the profiler, whose
    ``key_averages()`` sum the trace by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


class PhaseTimer:
    """Accumulating wall-clock phase timer.

    with timer.phase("encode"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {n} calls, "
                         f"{t / n * 1000:.2f}ms avg")
        return "\n".join(lines)


def chained_op_time(fn: Callable, *args, iters: int = 20) -> float:
    """Per-op time in ms from a dependency chain: ``fn(acc, *args)``
    returns a 0-d tensor that the next call consumes, so no call can start
    before the one before it ends. A chain of 1 call and one of
    ``iters + 1`` calls are each run once to warm up and once timed; the
    result is (t(iters + 1) - t(1)) / iters, which leaves out what both
    chains pay once (launch, the final read).

    On the card each chain is timed with CUDA events; on the CPU with the
    host clock. The device is that of the first tensor in ``args``."""
    device = next((a.device for a in args if torch.is_tensor(a)),
                  torch.device("cpu"))

    def chain(n: int):
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(n):
            acc = fn(acc, *args)
        return acc

    def timed(n: int) -> float:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(n)
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        float(chain(n))
        return (time.perf_counter() - t0) * 1000.0

    timed(1)
    timed(iters + 1)
    t1 = timed(1)
    tn = timed(iters + 1)
    return (tn - t1) / iters
