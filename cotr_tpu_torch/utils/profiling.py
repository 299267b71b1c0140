"""Host wall-clock phase timer (counterpart of ``PhaseTimer`` in
cotr_tpu/utils/profiling.py). Device timelines come from ``torch.profiler``
and CUDA events (profile_serve.py, profile_train.py, chip_smoke.py)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


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
