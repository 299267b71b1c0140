"""``replay_share.train`` on hand-built traces (``make_trace`` of the span
readers' tests): the share of the window's train steps that replayed the
step's CUDA graph."""

import pytest

from cotr_bench import run
from cotr_bench.tests.test_cotr_bench_spans import (UNSPANNED_TRACE, ctx,
                                                    make_trace, read)
from cotr_bench.tests.tiny import REPO
from cotr_tpu_torch.utils import profiling

METRIC = "replay_share.train"


def step(at, replay):
    """A step of 100 ns at ``at``: a replay then Adam, or the eager
    forward, backward and Adam."""
    inner = [("cotr.train.replay", at + 5, at + 60)] if replay else \
        [("cotr.train.forward", at + 5, at + 30),
         ("cotr.train.backward", at + 30, at + 60)]
    return [("cotr.train.step", at, at + 100), *inner,
            ("cotr.train.optimizer", at + 60, at + 100),
            ("cudaLaunchKernel", at + 70, at + 71)]


@pytest.mark.parametrize("replayed,want", [
    ((True,) * 8, 100.0), ((False,) * 8, 0.0),
    ((False, True, True, True, True, True, True, True), 87.5)])
def test_the_share_of_steps_that_hold_a_replay(replayed, want):
    host = [e for i, r in enumerate(replayed) for e in step(100 * i, r)]
    trace = make_trace(host=host, busy=[(0, 800)], w1=800)
    assert read(METRIC, trace) == pytest.approx(want)


def test_a_replay_outside_every_step_counts_for_none():
    trace = make_trace(host=step(0, False) + step(100, False)
                       + [("cotr.train.replay", 250, 300)],
                       busy=[], w1=400)
    assert read(METRIC, trace) == pytest.approx(0.0)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "span")
    assert read(METRIC, UNSPANNED_TRACE) is None


def test_a_window_without_a_train_step_fails_by_its_name():
    trace = make_trace(host=[("cotr.engine.call", 0, 500)], busy=[])
    with pytest.raises(LookupError, match="cotr.train.step"):
        read(METRIC, trace)


def test_an_untraced_window_fails_by_name():
    m = ctx(None)
    with pytest.raises(LookupError, match="not traced"):
        run.reader(REPO, METRIC)(m)


def test_it_is_a_program_span_metric_of_the_training_cell():
    bench = run.load_bench(REPO)
    entry = {m["name"]: m for m in bench["per_layer"]}[METRIC]
    assert entry == {"name": METRIC, "unit": "%", "better": "higher",
                     "source": "program_span", "layer": "training step",
                     "moves": "train_samples_per_s",
                     "workloads": ["train_b24.f32"]}
