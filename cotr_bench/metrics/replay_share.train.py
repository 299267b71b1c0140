"""Share of the window's train steps (``cotr.train.step`` spans) that hold
a ``cotr.train.replay`` span, the step's CUDA graph replayed, in %. A
program whose step has no graph reads 0."""

import numpy as np

from cotr_bench import program_spans


def read(m):
    got = program_spans.program(m, "replay_share.train", "cotr.train.step")
    if got is None:
        return None
    _, found = got
    steps = [(s, e) for n, s, e in found if n == "cotr.train.step"]
    replays = np.sort(np.array([s for n, s, _ in found
                                if n == "cotr.train.replay"], np.int64))
    held = sum(int(np.searchsorted(replays, e) > np.searchsorted(replays, s))
               for s, e in steps)
    return 100.0 * held / len(steps)
