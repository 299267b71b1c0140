"""What a ``torch.profiler`` trace of the window says: the device's busy
time (the union of its kernel, copy and set intervals), the kernels'
device time by name, and the idle gaps by what the host was doing.

The window is the benchmark's ``cotr_bench.window`` span; the copies of the
benchmark's spans that the profiler puts on the device's timeline are not
device work. An idle gap is
charged to the innermost host event of the thread that ran the window
which covers the gap's middle (an aten op, a CUDA runtime call, or a
``cotr_bench.*`` span), or to ``python`` where none does.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

WINDOW_SPAN = "cotr_bench.window"
_PROFILER_OWN = ("Buffer Flush", "Activity Buffer Request")
_LOOK_BACK = 64


def _ns(evt, which: str) -> int:
    fn = getattr(evt, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(evt, f"{which}_us")() * 1000)


def _device(evt) -> bool:
    return "CUDA" in str(evt.device_type())


def _annotation(evt) -> bool:
    flag = getattr(evt, "is_user_annotation", None)
    kind = str(getattr(evt, "activity_type", lambda: "")())
    return bool(flag and flag()) or "annotation" in kind \
        or evt.name().startswith("cotr_bench.")


def short_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:]", "_", name)[:64]


class Trace:
    """The events of one profiler run, split into device intervals and
    host events."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        dev, host = [], []
        window = None
        for e in events:
            name = e.name()
            if name in _PROFILER_OWN:
                continue
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            if _device(e):
                # a span's copy on the device's timeline is no work
                if not _annotation(e):
                    dev.append((start, end, name))
            else:
                thread = getattr(e, "start_thread_id", lambda: 0)()
                host.append((start, end, name, thread))
                if name == WINDOW_SPAN:
                    window = (start, end, thread)
        if window is None:
            raise RuntimeError("the trace holds no cotr_bench.window span")
        self.w0, self.w1, thread = window
        self.window_s = (self.w1 - self.w0) / 1e9
        dev.sort()
        self.dev = [(max(s, self.w0), min(e, self.w1), n) for s, e, n in dev
                    if e > self.w0 and s < self.w1]
        main = [h for h in host if h[3] == thread and h[2] != WINDOW_SPAN
                and h[1] > self.w0 and h[0] < self.w1]
        main.sort()
        self.host_start = np.array([h[0] for h in main], np.int64)
        self.host_end = np.array([h[1] for h in main], np.int64)
        self.host_name = [h[2] for h in main]

    def busy_intervals(self) -> List[tuple]:
        merged = []
        for s, e, _ in self.dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_s(self) -> Dict[str, float]:
        """Device seconds in the window by kernel name."""
        out: Dict[str, float] = {}
        for s, e, n in self.dev:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out

    def idle_gaps(self) -> Dict[str, float]:
        """Idle seconds of the device in the window by host activity."""
        edges = [self.w0]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.w1)
        edges = np.array(edges, np.int64).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        if not len(gaps):
            return {}
        mids = (gaps[:, 0] + gaps[:, 1]) // 2
        length = (gaps[:, 1] - gaps[:, 0]) / 1e9
        owner = np.full(len(mids), -1)
        idx = np.searchsorted(self.host_start, mids, side="right") - 1
        for k in range(_LOOK_BACK):
            cand = idx - k
            ok = (owner < 0) & (cand >= 0)
            cand_c = np.clip(cand, 0, None)
            if not len(self.host_end):
                break
            hit = ok & (self.host_end[cand_c] >= mids)
            owner[hit] = cand_c[hit]
        out: Dict[str, float] = {}
        for o, sec in zip(owner, length):
            name = self.host_name[o] if o >= 0 else "python"
            out[name] = out.get(name, 0.0) + float(sec)
        return out

    def breakdown(self) -> dict:
        def top(d):
            items = sorted(d.items(), key=lambda kv: -kv[1])[:10]
            return [[short_name(k), v] for k, v in items]

        return {"device_ops": top(self.kernel_s()),
                "idle_gaps": top(self.idle_gaps())}


def idle_percent(m) -> float:
    """Per-layer reader: 100 (1 - busy / window) of the traced window."""
    if m.trace is None:
        raise LookupError("idle_share: the window was not traced")
    return 100.0 * (1.0 - m.trace.busy_s() / m.trace.window_s)
