"""Share of the window in which the card idled while the innermost program
span was ``cotr.train.optimizer`` (``Optimizer.step``)."""

from cotr_bench import program_spans


def read(m):
    return program_spans.idle_share(m, "idle_optim.train",
                                    ["cotr.train.optimizer"],
                                    "cotr.train.optimizer")
