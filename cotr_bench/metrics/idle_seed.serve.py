"""Share of the window in which the card idled while the innermost program
span was ``cotr.seed``: the dense seed pass's host work and its wait for
the fields."""

from cotr_bench import program_spans


def read(m):
    return program_spans.idle_share(m, "idle_seed.serve", ["cotr.seed"],
                                    "cotr.seed")
