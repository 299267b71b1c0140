"""Model operations of what ran in the window over the window and the
card's peak in the configuration's dtype (bfloat16 989 TFLOP/s, float32
against TF32's 495 TFLOP/s). The work is reckoned from the attention
wrapper's calls by shape (``ops.attention.shape_counts``): every canvas
encoded and every query decoded, with the sizes of ``cotr_bench.flops``."""

from cotr_bench import flops


def read(m):
    if not m.shape_counts:
        raise LookupError("mfu.serve: the window counted no attention call "
                          "(ops.attention.shape_counts is empty)")
    work = flops.serve_flops(m.shape_counts, m.sizes)
    return 100.0 * work / m.window_s / flops.PEAK_FLOPS[m.sizes["dtype"]]
