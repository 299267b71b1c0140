"""The readers of the program's spans (``cotr_bench/program_spans.py`` and
the metrics that use it) on hand-built traces: host spans and busy
intervals made up in nanoseconds, in a ``Trace`` built without a
profiler."""

import numpy as np
import pytest

from cotr_bench import program_spans, run
from cotr_tpu_torch.utils import profiling
from cotr_bench.tests.tiny import REPO
from cotr_bench.trace import Trace, idle_percent

SERVE = ("idle_engine.serve", "idle_seed.serve", "idle_squad.squad",
         "idle_scan.scan")
READERS = SERVE + ("seed_span.serve", "optim_launches.train",
                   "idle_optim.train")


def make_trace(host, busy, w0=0, w1=1000):
    """A window [w0, w1) with host events (name, start, end) on its thread
    and device intervals (start, end)."""
    t = Trace.__new__(Trace)
    t.w0, t.w1 = w0, w1
    t.window_s = (w1 - w0) / 1e9
    t.dev = [(s, e, "kernel") for s, e in sorted(busy)]
    host = sorted(host, key=lambda h: h[1])
    t.host_name = [h[0] for h in host]
    t.host_start = np.array([h[1] for h in host], np.int64)
    t.host_end = np.array([h[2] for h in host], np.int64)
    return t


def ctx(trace):
    return run.MetricContext(trace=trace, counters={}, spans={}, answers=1,
                             window_s=1.0, pool_errors=None)


def read(metric, trace):
    return run.reader(REPO, metric)(ctx(trace))


SERVE_TRACE = make_trace(
    host=[("cotr.engine.call", 0, 900),          # request 1
          ("cotr.seed", 50, 300),
          ("aten::mm", 60, 70),
          ("cotr.squad.refine", 350, 800),
          ("cotr.squad.form", 360, 420),
          ("cotr.squad.form", 600, 650),
          ("cotr.scan.refine", 820, 880),
          ("cotr_bench.seed", 40, 310)],         # the benchmark's own
    busy=[(100, 200), (250, 380), (400, 700), (950, 980)])


def unspanned(trace):
    """Percent of the window in which the card idled outside every
    ``cotr.*`` span (the benchmark's loop between requests)."""
    by = program_spans.idle_by_span(trace, program_spans.spans(trace))
    return 100.0 * by.get(None, 0) / (trace.w1 - trace.w0)


def test_serving_idle_classes_sum_to_the_idle_share():
    got = sum(read(m, SERVE_TRACE) for m in SERVE) + unspanned(SERVE_TRACE)
    assert abs(got - idle_percent(ctx(SERVE_TRACE))) < 1e-9


def test_each_idle_nanosecond_goes_to_the_innermost_span_by_overlap():
    # idle: [0,100) [200,250) [380,400) [700,950) [980,1000)
    # engine: [0,50) + [300,350) - busy [300,350) + [800,820) + [880,900)
    assert read("idle_engine.serve", SERVE_TRACE) == pytest.approx(
        100 * (50 + 0 + 20 + 20) / 1000)
    # seed [50,300): idle [50,100) and [200,250)
    assert read("idle_seed.serve", SERVE_TRACE) == pytest.approx(10.0)
    # squad [350,800), forms nested: idle [380,400) and [700,800)
    assert read("idle_squad.squad", SERVE_TRACE) == pytest.approx(12.0)
    assert read("idle_scan.scan", SERVE_TRACE) == pytest.approx(6.0)
    # after the call: [900,950) and [980,1000)
    assert unspanned(SERVE_TRACE) == pytest.approx(7.0)


def test_a_gap_that_straddles_a_span_edge_splits_by_overlap():
    trace = make_trace(host=[("cotr.engine.call", 0, 1000),
                             ("cotr.seed", 0, 500)],
                       busy=[(0, 400), (700, 1000)])
    # the gap [400, 700) is 100 in the seed and 200 after it
    assert read("idle_seed.serve", trace) == pytest.approx(10.0)
    assert read("idle_engine.serve", trace) == pytest.approx(20.0)


def test_nested_spans_charge_the_innermost():
    trace = make_trace(host=[("cotr.engine.call", 0, 1000),
                             ("cotr.squad.refine", 100, 900),
                             ("cotr.squad.form", 100, 300)],
                       busy=[])
    by = program_spans.idle_by_span(trace, program_spans.spans(trace))
    assert by == {"cotr.engine.call": 200, "cotr.squad.form": 200,
                  "cotr.squad.refine": 600}
    assert read("idle_squad.squad", trace) == pytest.approx(80.0)
    assert read("idle_engine.serve", trace) == pytest.approx(20.0)


def test_spans_are_clipped_to_the_window():
    trace = make_trace(host=[("cotr.engine.call", -500, 300),
                             ("cotr.seed", 200, 2000)],
                       busy=[], w0=0, w1=1000)
    assert read("seed_span.serve", trace) == pytest.approx(80.0)
    assert unspanned(trace) == pytest.approx(0.0)


def test_seed_span_sums_the_seed_spans_over_the_window():
    assert read("seed_span.serve", SERVE_TRACE) == pytest.approx(25.0)


TRAIN_TRACE = make_trace(
    host=[("cotr.train.step", 0, 400), ("cotr.train.forward", 0, 100),
          ("cudaLaunchKernel", 10, 11), ("cotr.train.backward", 100, 200),
          ("cotr.train.optimizer", 200, 400),
          ("cudaLaunchKernel", 210, 211), ("cudaLaunchKernelExC", 220, 221),
          ("cuLaunchKernel", 230, 231), ("cudaMemcpyAsync", 240, 241),
          ("cotr.train.step", 500, 900), ("cotr.train.optimizer", 700, 900),
          ("cudaLaunchKernel", 750, 751), ("cudaLaunchKernel", 900, 901),
          ("cudaLaunchKernel", 950, 951)],
    busy=[(0, 250), (500, 800)])


def test_launches_count_only_under_optimizer_spans():
    # 3 in the first step's optimizer span, 1 in the second's; the copy is
    # no launch, and the launches before and after fall outside
    assert read("optim_launches.train", TRAIN_TRACE) == pytest.approx(2.0)


def test_optimizer_idle_share():
    # optimizer spans [200,400) and [700,900): idle [250,400), [800,900)
    assert read("idle_optim.train", TRAIN_TRACE) == pytest.approx(25.0)


def test_launches_are_nothing_without_cuda_runtime_events():
    trace = make_trace(host=[("cotr.train.step", 0, 400),
                             ("cotr.train.optimizer", 200, 400),
                             ("aten::add_", 210, 220)], busy=[])
    assert read("optim_launches.train", trace) is None
    assert read("idle_optim.train", trace) == pytest.approx(20.0)


#: a traced window of a program without spans: the benchmark's own spans
#: and aten events, no ``cotr.*`` span
UNSPANNED_TRACE = make_trace(host=[("cotr_bench.seed", 0, 300),
                                   ("cudaLaunchKernel", 10, 11),
                                   ("aten::mm", 20, 30)], busy=[(0, 100)])


@pytest.mark.parametrize("metric", READERS)
def test_a_program_without_spans_reads_nothing(metric, monkeypatch):
    """The parent of the spans: its profiling module has no ``span``; the
    result line leaves the metric out."""
    monkeypatch.delattr(profiling, "span")
    assert read(metric, UNSPANNED_TRACE) is None


@pytest.mark.parametrize("others", [True, False],
                         ids=["other_spans", "no_span"])
@pytest.mark.parametrize("metric,missing", [
    ("seed_span.serve", "cotr.seed"),
    ("idle_engine.serve", "cotr.engine.call"),
    ("idle_seed.serve", "cotr.seed"),
    ("idle_squad.squad", "cotr.squad.refine"),
    ("idle_scan.scan", "cotr.scan.refine"),
    ("optim_launches.train", "cotr.train.optimizer"),
    ("idle_optim.train", "cotr.train.optimizer"),
])
def test_a_reader_fails_by_the_name_of_its_missing_span(metric, missing,
                                                        others):
    """A program that has ``span`` fails by the missing span's name, also
    where the window holds no ``cotr.*`` span at all (a lost gate, say)."""
    trace = UNSPANNED_TRACE
    if others:
        trace = make_trace(host=[("cotr.train.step" if "serve" in metric
                                  or "squad" in metric or "scan" in metric
                                  else "cotr.engine.call", 0, 500),
                                 ("cudaLaunchKernel", 10, 11)],
                           busy=[(0, 100)])
    with pytest.raises(LookupError, match=missing):
        read(metric, trace)


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_of_an_untraced_window_fails_by_name(metric):
    m = run.MetricContext(counters={}, spans={}, trace=None, answers=4,
                          window_s=1.0, pool_errors=None)
    with pytest.raises(LookupError, match="not traced"):
        run.reader(REPO, metric)(m)


def test_every_new_reader_is_a_program_span_metric_of_the_benchmark():
    bench = run.load_bench(REPO)
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for metric in READERS:
        assert by_name[metric]["source"] == "program_span"
    cells = {c["name"] for c in bench["workloads"]}
    for metric in SERVE + ("seed_span.serve",):
        assert set(by_name[metric]["workloads"]) <= cells
        assert "train_b24.f32" not in by_name[metric]["workloads"]
