"""Median distance in pixels between each returned point in B and the known
homography's image of its point in A, over the answers to one full pass of
the cell's fixed pool (the window's first pass, completed after the window
where it held less): the same pairs whatever the seed, taken on the host by
the benchmark from what the engine returned."""

import numpy as np


def read(m):
    if m.pool_errors is None or not len(m.pool_errors):
        raise LookupError("px_err_p50: the driver returned no answers of "
                          "its pool")
    return float(np.median(m.pool_errors))
