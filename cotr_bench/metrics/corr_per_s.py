"""Correspondences returned over the whole window: the window opens at the
first timed request and closes at the end of the first request that
finishes after ``--seconds``; only whole requests count (host clock, each
request ending where its answers are on the host)."""


def read(m):
    return m.answers / m.window_s
