"""The program's own spans in a traced window, for the per-layer readers.

``cotr_tpu_torch.utils.profiling.span`` opens a ``cotr.*`` range at each
layer boundary of the port while a profiler collects (the benchmark's own
spans are ``cotr_bench.*``). The readers take those ranges from the window
thread's host events (``Trace.host_name``, ``host_start``, ``host_end``),
clipped to the window.

Each idle nanosecond of the card in the window (outside the union of its
kernel, copy and set intervals, ``Trace.busy_intervals``) is charged by
exact overlap to the innermost ``cotr.*`` span open at that instant, or to
no span; so the classes of one run add up to its ``idle_percent``.
``trace.idle_gaps`` charges a whole gap to one host event at its middle,
searching a bounded number of events back, and is left as it is.

Whether the program has spans is read from the checkout, not from the
trace: a program whose ``cotr_tpu_torch.utils.profiling`` defines no
``span`` (one from before them) reads None, and the result line leaves the
metrics out; a program that has ``span`` and left the span a reader needs
out of the window fails by that span's name.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cotr_tpu_torch.utils import profiling

PREFIX = "cotr."
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")
_RUNTIME = re.compile(r"cu(da)?[A-Z]")


def traced(m, metric: str):
    """The run's ``Trace``; an untraced window fails by the metric's name."""
    if m.trace is None:
        raise LookupError(f"{metric}: the window was not traced")
    return m.trace


def spans(trace) -> List[Tuple[str, int, int]]:
    """(name, start, end) of the ``cotr.*`` spans, clipped to the window,
    in order of start (an outer span before an inner one that starts with
    it)."""
    out = []
    for name, s, e in zip(trace.host_name, trace.host_start,
                          trace.host_end):
        if name.startswith(PREFIX):
            s, e = max(int(s), trace.w0), min(int(e), trace.w1)
            if e > s:
                out.append((name, s, e))
    out.sort(key=lambda x: (x[1], -x[2]))
    return out


def program_has_spans() -> bool:
    """Whether the checkout's program marks its layers with spans."""
    return hasattr(profiling, "span")


def program(m, metric: str, needs: str):
    """(trace, spans) of the run; None for a program without spans; a
    window without ``needs`` fails by its name."""
    trace = traced(m, metric)
    if not program_has_spans():
        return None
    found = spans(trace)
    if not any(n == needs for n, _, _ in found):
        have = sorted({n for n, _, _ in found})
        raise LookupError(f"{metric}: no {needs} span in the window; it "
                          f"holds {have}")
    return trace, found


def innermost(found: Sequence[tuple], w0: int, w1: int
              ) -> Tuple[np.ndarray, np.ndarray, List[Optional[str]]]:
    """The window cut into segments, each with the innermost span open over
    it (None where no span is): (starts, ends, names). Spans of one thread
    nest, so a stack of the open ones gives the innermost."""
    cuts: List[Tuple[int, int, Optional[str]]] = []
    stack: List[tuple] = []
    at = w0

    def emit(end, name):
        nonlocal at
        if end > at:
            cuts.append((at, end, name))
            at = end

    for span in found:
        _, s, _ = span
        while stack and stack[-1][2] <= s:
            top = stack.pop()
            emit(top[2], top[0])
        emit(s, stack[-1][0] if stack else None)
        stack.append(span)
    while stack:
        top = stack.pop()
        emit(top[2], top[0])
    emit(w1, None)
    return (np.array([c[0] for c in cuts], np.int64),
            np.array([c[1] for c in cuts], np.int64), [c[2] for c in cuts])


def idle_before(busy: np.ndarray, w0: int, t: np.ndarray) -> np.ndarray:
    """Idle nanoseconds of the card from the window's start ``w0`` to each
    ``t``; ``busy`` is the (k, 2) union of the device intervals, in
    order."""
    done = np.concatenate([[0], np.cumsum(busy[:, 1] - busy[:, 0])])
    k = np.searchsorted(busy[:, 0], t, side="right")
    last = np.clip(k - 1, 0, None)
    part = np.where(k > 0, np.minimum(t, busy[last, 1]) - busy[last, 0], 0) \
        if len(busy) else np.zeros_like(t)
    return (t - w0) - (done[last] * (k > 0) + part)


def idle_by_span(trace, found: Sequence[tuple]) -> Dict[Optional[str], int]:
    """Idle nanoseconds of the window by the innermost span's name."""
    starts, ends, names = innermost(found, trace.w0, trace.w1)
    busy = np.array(trace.busy_intervals(), np.int64).reshape(-1, 2)
    idle = idle_before(busy, trace.w0, ends) \
        - idle_before(busy, trace.w0, starts)
    out: Dict[Optional[str], int] = {}
    for name, ns in zip(names, idle):
        out[name] = out.get(name, 0) + int(ns)
    return out


def idle_share(m, metric: str, names: Sequence[Optional[str]],
               needs: str) -> Optional[float]:
    """Percent of the window in which the card idled with one of ``names``
    innermost (None: no span); ``needs`` is the span the metric cannot do
    without."""
    got = program(m, metric, needs)
    if got is None:
        return None
    trace, found = got
    by = idle_by_span(trace, found)
    return 100.0 * sum(by.get(n, 0) for n in names) / (trace.w1 - trace.w0)


def span_share(m, metric: str, name: str) -> Optional[float]:
    """Percent of the window inside ``name`` spans."""
    got = program(m, metric, name)
    if got is None:
        return None
    trace, found = got
    inside = sum(e - s for n, s, e in found if n == name)
    return 100.0 * inside / (trace.w1 - trace.w0)


def launches_per_span(m, metric: str, name: str) -> Optional[float]:
    """Kernel-launch runtime calls of the window's thread that start inside
    ``name`` spans, over the number of those spans; None on a trace with no
    CUDA runtime event (a run on the CPU) or from a program without
    spans."""
    if not any(_RUNTIME.match(n) for n in traced(m, metric).host_name):
        return None
    got = program(m, metric, name)
    if got is None:
        return None
    trace, found = got
    mine = [(s, e) for n, s, e in found if n == name]
    at = np.sort(np.array([s for n, s in zip(trace.host_name,
                                             trace.host_start)
                           if n in LAUNCHES], np.int64))
    inside = sum(int(np.searchsorted(at, e) - np.searchsorted(at, s))
                 for s, e in mine)
    return inside / len(mine)
