"""Seconds from the process's start to the first timed request: imports,
the weights, the inputs made on the card, any build of the kernels, and the
warm-up of the cell's own shapes (host clock, after a synchronize)."""


def read(m):
    return m.setup_s
