"""Share of the window in which the card idled while the innermost program
span was ``cotr.engine.call``: the engine's own host work (seeding from the
fields, image stacks, the filters and ranking), outside the seed pass and
the refinement."""

from cotr_bench import program_spans


def read(m):
    return program_spans.idle_share(m, "idle_engine.serve",
                                    ["cotr.engine.call"], "cotr.engine.call")
