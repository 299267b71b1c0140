"""Share of the window in which no kernel, copy or set ran on the card:
1 - (union of the device intervals) / window, from ``torch.profiler``."""

from cotr_bench.trace import idle_percent as read  # noqa: F401
