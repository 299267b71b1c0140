"""Share of the window's wall inside the program's ``cotr.seed`` spans
(``SparseEngine._dense_fields_many``: canvases, device passes, the fields'
mapping, resize and merge on the host, ending where the last field is on
the host): the in-program twin of ``seed_share.serve``, without its added
synchronize."""

from cotr_bench import program_spans


def read(m):
    return program_spans.span_share(m, "seed_span.serve", "cotr.seed")
