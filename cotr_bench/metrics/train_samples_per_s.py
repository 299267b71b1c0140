"""Training samples over the whole window, counted in whole steps; the
window ends in ``torch.cuda.synchronize()`` (host clock)."""


def read(m):
    return m.answers / m.window_s
