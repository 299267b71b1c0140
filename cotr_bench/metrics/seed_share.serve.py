"""Share of the window's wall in the engine's dense seed pass: the
benchmark's span around ``SparseEngine._dense_fields_many``, which ends in
a synchronize; installed in traced runs only."""


def read(m):
    if "seed" not in m.spans:
        raise LookupError("seed_share.serve: no cotr_bench.seed span in "
                          "the window (SparseEngine._dense_fields_many "
                          "was not called)")
    return 100.0 * m.spans["seed"] / m.window_s
