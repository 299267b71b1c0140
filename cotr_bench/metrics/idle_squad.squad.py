"""Share of the window in which the card idled while the innermost program
span was ``cotr.squad.refine`` or ``cotr.squad.form``: squad formation and
its tables, the dispatches' padding and enqueue, the predictions mapped
back on the host."""

from cotr_bench import program_spans


def read(m):
    return program_spans.idle_share(
        m, "idle_squad.squad", ["cotr.squad.refine", "cotr.squad.form"],
        "cotr.squad.refine")
