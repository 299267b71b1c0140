"""``utils/profiling.chained_op_time`` of the port against the JAX
package's definition: the per-op time is (t(iters + 1) - t(1)) / iters in
ms, each chain consuming the scalar the call before it returned."""

import time

import numpy as np
import torch

from cotr_tpu_torch.utils.profiling import PhaseTimer, chained_op_time


def test_chained_op_time_chains_each_call_on_the_last():
    seen = []

    def fn(acc, m):
        seen.append(float(acc))
        return acc + m.sum()

    iters = 5
    ms = chained_op_time(fn, torch.ones(4, 4), iters=iters)
    # two warm chains and two timed chains, of 1 and iters + 1 calls
    assert len(seen) == 2 * (1 + iters + 1)
    assert np.isfinite(ms)
    # each chain starts at 0 and every call consumes the last one's output
    chains = [seen[:1], seen[1:iters + 2], seen[iters + 2:iters + 3],
              seen[iters + 3:]]
    for chain in chains:
        assert chain == [16.0 * k for k in range(len(chain))]


def test_chained_op_time_is_the_per_call_difference_in_ms():
    """A call that sleeps 5 ms reads about 5 ms: the fixed cost both chains
    pay once (the 30 ms of the first call) drops out."""
    def fn(acc, x):
        if float(acc) == 0.0:
            time.sleep(0.03)  # paid once by every chain
        time.sleep(0.005)
        return acc + x

    ms = chained_op_time(fn, torch.ones(()), iters=10)
    assert 4.0 <= ms <= 15.0, ms


def test_phase_timer_reports_each_phase():
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("a"):
            pass
    assert timer.counts["a"] == 2 and "a: " in timer.report()
