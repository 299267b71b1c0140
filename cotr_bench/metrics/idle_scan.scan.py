"""Share of the window in which the card idled while the innermost program
span was ``cotr.scan.refine`` (``BatchRefiner.refine``: the zoom loop's
enqueue and the history's copy back)."""

from cotr_bench import program_spans


def read(m):
    return program_spans.idle_share(m, "idle_scan.scan",
                                    ["cotr.scan.refine"], "cotr.scan.refine")
