"""The train step's model operations times the steps of the window, over
the window (host clock) and the card's peak in the configuration's dtype
(float32 against TF32's 495 TFLOP/s): two forwards of the batch and the
backward of everything past the frozen backbone
(``cotr_bench.flops.train_step_flops``)."""

from cotr_bench import flops


def read(m):
    t = m.traffic
    queries = int(t["num_kp"]) * (2 if t["bidirectional"] else 1)
    work = flops.train_step_flops(m.sizes, int(t["batch"]), queries) \
        * m.counters["steps"]
    return 100.0 * work / m.window_s / flops.PEAK_FLOPS[m.sizes["dtype"]]
