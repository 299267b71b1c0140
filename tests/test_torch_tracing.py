"""The port's spans (``utils.profiling.span``): with no profiler a span is
one shared no-op that enters no ``record_function``; under
``utils.profiling.trace`` the Chrome trace holds the layers' span tree
(``cotr.engine.call`` around the dense seed and the squad or scan
refinement, ``cotr.train.step`` around its forward, backward and optimizer
step); and a profiler changes no answer of the engines or the train step.

The engines run on the identity stub (every host path, in seconds) and on
the small random-weight model; the train step on the small model."""

import copy
import glob
import json
import os

import numpy as np
import pytest
import torch

from cotr_tpu_torch.config import COTRConfig, TrainConfig
from cotr_tpu_torch.inference import FasterSparseEngine, SparseEngine
from cotr_tpu_torch.inference.runner import ModelRunner
from cotr_tpu_torch.models.cotr import build_model, init_weights
from cotr_tpu_torch.training import train_step as ts
from cotr_tpu_torch.utils import profiling
from tests.test_torch_common import (SMALL, TorchIdentityRunner,
                                     few_torch_threads,  # noqa: F401
                                     smooth_image)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

ZOOMS = [0.5, 0.25]
GROUPING = dict(mode="tile", max_load=8, group_cap=16, group_bucket=4,
                member_bucket=4, seed_stride=8)


def _images(n=2, hw=(200, 300)):
    rng = np.random.RandomState(11)
    return [smooth_image(rng, hw) for _ in range(n)]


def _queries(seed, n=16):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(60, 240, n), rng.uniform(60, 140, n)],
                    axis=1)


@pytest.fixture(scope="module")
def small_model():
    model = build_model(COTRConfig(**SMALL))
    init_weights(model, torch.Generator().manual_seed(3))
    return model.eval()


def _scan(runner):
    img = _images(1)[0]
    engine = SparseEngine(runner, mode="tile", seed=4, seed_stride=8)
    return engine.cotr_corr_multiscale(
        img, img, zoom_ins=ZOOMS, max_corrs=16, queries_a=_queries(1),
        return_idx=True)


def _squad(runner):
    img = _images(1)[0]
    engine = FasterSparseEngine(runner, seed=4, **GROUPING)
    return engine.cotr_corr_multiscale(
        img, img, zoom_ins=ZOOMS, converge_iters=2, max_corrs=16,
        queries_a=_queries(2), force=True, return_idx=True)


def _multipair(runner):
    pairs = [(im, im) for im in _images()]
    engine = FasterSparseEngine(runner, **GROUPING)
    return engine.cotr_corr_multiscale_multipair(
        pairs, zoom_ins=ZOOMS, max_corrs=16,
        queries_list=[_queries(3), _queries(4)], force=True,
        return_idx=True, pair_seeds=[5, 6])


def _cycle(runner):
    img = _images(1)[0]
    engine = SparseEngine(runner, mode="tile", seed=7, seed_stride=8)
    return engine.cotr_corr_multiscale_with_cycle_consistency(
        img, img, zoom_ins=ZOOMS, max_corrs=8, queries_a=_queries(5),
        return_idx=True, return_cycle_error=True)


def _cycle_multipair(runner):
    pairs = [(im, im) for im in _images()]
    engine = FasterSparseEngine(runner, **GROUPING)
    return engine.cotr_corr_multiscale_with_cycle_consistency_multipair(
        pairs, zoom_ins=ZOOMS, max_corrs=8,
        queries_list=[_queries(6), _queries(7)], return_idx=True,
        pair_seeds=[8, 9])


def _corr_base(runner):
    img = _images(1)[0]
    return SparseEngine(runner, mode="tile").corr_base_many(
        [(img, img, _queries(8))])


def _squad_small_model(model):
    img = _images(1, hw=(128, 128))[0]
    engine = FasterSparseEngine(ModelRunner(model, device="cpu"), seed=4,
                                **dict(GROUPING, seed_stride=16))
    return engine.cotr_corr_multiscale(
        img, img, zoom_ins=[0.5], max_corrs=4, queries_a=_queries(9, 4) / 2,
        force=True, return_idx=True)


#: each path, and the (outer, inner) span pairs its trace must nest
PATHS = {
    "scan": (_scan, [("cotr.engine.call", "cotr.seed"),
                     ("cotr.engine.call", "cotr.scan.refine")]),
    "squad": (_squad, [("cotr.engine.call", "cotr.seed"),
                       ("cotr.engine.call", "cotr.squad.refine"),
                       ("cotr.squad.refine", "cotr.squad.form")]),
    "multipair": (_multipair, [("cotr.engine.call", "cotr.seed"),
                               ("cotr.engine.call", "cotr.squad.refine"),
                               ("cotr.squad.refine", "cotr.squad.form")]),
    "cycle": (_cycle, [("cotr.engine.call", "cotr.seed"),
                       ("cotr.engine.call", "cotr.engine.call"),
                       ("cotr.engine.call", "cotr.scan.refine")]),
    "cycle_multipair": (_cycle_multipair,
                        [("cotr.engine.call", "cotr.seed"),
                         ("cotr.engine.call", "cotr.engine.call"),
                         ("cotr.squad.refine", "cotr.squad.form")]),
    "corr_base": (_corr_base, []),
}


def _spans(log_dir) -> list:
    """(name, start, end) of the Chrome trace's ``cotr.*`` spans."""
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("name", "").startswith("cotr.")]


def _nests(spans, outer, inner) -> bool:
    return any(o != i and o[0] == outer and i[0] == inner
               and o[1] <= i[1] and i[2] <= o[2]
               for o in spans for i in spans)


def _assert_same(got, want):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def recorded(monkeypatch):
    """The name of every ``record_function`` a span enters."""
    calls = []
    real = torch.profiler.record_function

    def recording(name, args=None):
        calls.append(name)
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    return calls


def test_span_without_a_profiler_enters_no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("cotr.a") is profiling.span("cotr.b")
    with profiling.span("cotr.a"):
        pass
    for run, _ in PATHS.values():
        run(TorchIdentityRunner())


def test_span_is_the_no_op_where_torch_lacks_the_profiler_flag(monkeypatch):
    """The gate reads a private torch flag; a torch without it runs every
    call untraced and raises nothing."""
    monkeypatch.delattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert profiling.span("cotr.a") is profiling.span("cotr.b")
    plain = _scan(TorchIdentityRunner())
    monkeypatch.undo()
    _assert_same(plain, _scan(TorchIdentityRunner()))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_engine_answers_are_the_same_under_a_profiler_and_its_trace_nests(
        path, tmp_path, recorded):
    run, nesting = PATHS[path]
    plain = run(TorchIdentityRunner())
    assert not recorded
    with profiling.trace(str(tmp_path)):
        traced = run(TorchIdentityRunner())
    _assert_same(traced, plain)
    spans = _spans(tmp_path)
    names = {s[0] for s in spans}
    assert "cotr.engine.call" in names
    for outer, inner in nesting:
        assert _nests(spans, outer, inner), (outer, inner, spans)
    assert set(recorded) == names


def test_small_model_answers_are_the_same_under_a_profiler(small_model,
                                                           tmp_path):
    plain = _squad_small_model(small_model)
    with profiling.trace(str(tmp_path)):
        traced = _squad_small_model(small_model)
    _assert_same(traced, plain)
    spans = _spans(tmp_path)
    assert _nests(spans, "cotr.engine.call", "cotr.seed")
    assert _nests(spans, "cotr.squad.refine", "cotr.squad.form")


def test_train_step_is_the_same_under_a_profiler_and_its_trace_nests(
        small_model, tmp_path, recorded):
    rng = np.random.RandomState(31)
    crops = np.stack([smooth_image(rng, (256, 256)) for _ in range(2)])
    batch = {"image": torch.from_numpy(np.concatenate([crops, crops[::-1]],
                                                      axis=2)),
             "queries": torch.from_numpy(rng.uniform(
                 0.05, 0.45, (2, 4, 2)).astype(np.float32)),
             "targets": torch.from_numpy(rng.uniform(
                 0.55, 0.95, (2, 4, 2)).astype(np.float32))}
    cfg = TrainConfig(batch_size=2, num_kp=4)
    step = ts.make_train_step(cfg)
    out = []
    for traced in (False, True):
        state = ts.create_train_state(copy.deepcopy(small_model), cfg,
                                      device="cpu")
        if traced:
            with profiling.trace(str(tmp_path)):
                state, metrics = step(state, batch,
                                      torch.Generator().manual_seed(0))
        else:
            state, metrics = step(state, batch,
                                  torch.Generator().manual_seed(0))
        out.append((state, metrics))
    (s0, m0), (s1, m1) = out
    assert s0.step == s1.step == 1
    for k in m0:
        np.testing.assert_array_equal(m1[k].numpy(), m0[k].numpy())
    for (n, p0), p1 in zip(s0.model.named_parameters(),
                           s1.model.parameters()):
        np.testing.assert_array_equal(p1.detach().numpy(),
                                      p0.detach().numpy(), err_msg=n)
    spans = _spans(tmp_path)
    for inner in ("forward", "backward", "optimizer"):
        assert _nests(spans, "cotr.train.step", f"cotr.train.{inner}")
    assert set(recorded) == {s[0] for s in spans}
