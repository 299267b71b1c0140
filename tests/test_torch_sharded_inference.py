"""Sharded inference on a local mesh (counterpart of
tests/test_sharded_inference.py, which the JAX package marks slow): the
squad stepper and both engines split their squad or task axis over a mesh
that lists the CPU 8 times, and must reproduce the unsharded ones.

* The stepper on a 1 + 1 model at full width (random weights), single-pair
  ``dispatch`` and multi-pair ``dispatch_indexed``: raw outputs within 1e-5
  of the unsharded stepper's.
* ``FasterSparseEngine`` and ``SparseEngine`` on that model: within 1e-3 px
  of the same engine without the mesh.
* Both engines with the mesh against the JAX package's unsharded engines:
  on the identity stub (exact arithmetic) equal, with the global dispatch
  and canvas counts, and 1/8 of the canvases on each device; on the small
  real model of tests/test_torch_engine.py (mesh of 4) within that test's
  tolerance (``_agree``: 95% within 1 px, median within 0.1 px).
"""

import numpy as np
import pytest
import torch

from cotr_tpu.inference.engine import FasterSparseEngine as JaxFaster
from cotr_tpu.inference.engine import SparseEngine as JaxEngine
from cotr_tpu.inference.runner import ModelRunner as JaxRunner
from cotr_tpu_torch.inference import FasterSparseEngine, SparseEngine
from cotr_tpu_torch.inference.grouped import GroupedStepper
from cotr_tpu_torch.inference.runner import ModelRunner
from cotr_tpu_torch.parallel.mesh import make_mesh
from tests import test_torch_dist_common as dc
from tests.test_torch_common import (JaxIdentityRunner, TorchIdentityRunner,
                                     few_torch_threads, small_models,  # noqa: F401,E501
                                     smooth_image)
from tests.test_torch_engine_grouped import _agree

pytestmark = pytest.mark.usefixtures("few_torch_threads")

STEPPER_TOL = 1e-5
PX_TOL = 1e-3
MESH = ["cpu"] * 8


@pytest.fixture(scope="module")
def runner(few_torch_threads):  # noqa: F811
    return ModelRunner(dc.build(), device="cpu")


def _squads(rng, g=8, m=16, size=512):
    boxes = np.concatenate(
        [np.floor(rng.uniform(0, size - 256, (g, 2))).astype(np.float32),
         np.full((g, 2), 256.0, np.float32)], axis=1)
    queries = rng.uniform(0.05, 0.45, (g, m, 2)).astype(np.float32)
    return boxes, queries


def test_sharded_stepper_matches_single_device(runner):
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.uniform(0, 1, (512, 512, 3))
                           .astype(np.float32))
    boxes, queries = _squads(rng)
    single = GroupedStepper(runner)
    sharded = GroupedStepper(runner, mesh=make_mesh(devices=MESH))
    want = single(img, img, boxes, boxes, queries)
    got = sharded(img, img, boxes, boxes, queries)
    np.testing.assert_allclose(got, want, rtol=0, atol=STEPPER_TOL)
    assert sharded.canvas_count == single.canvas_count == 8
    assert sharded.device_canvas_count == [1] * 8

    # multi-pair: image stacks and a pair index a squad
    stack = torch.from_numpy(rng.uniform(0, 1, (2, 512, 512, 3))
                             .astype(np.float32))
    idx = np.array([0, 1] * 4, np.int32)
    want = single.dispatch_indexed(stack, stack, idx, boxes, boxes, queries)
    got = sharded.dispatch_indexed(stack, stack, idx, boxes, boxes, queries)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=STEPPER_TOL)
    assert sharded.dispatch_count == 2 and sharded.canvas_count == 16
    assert sharded.device_canvas_count == [2] * 8
    with pytest.raises(ValueError, match="multiples"):
        sharded(img, img, boxes[:6], boxes[:6], queries[:6])


@pytest.mark.parametrize("engine", ["squad", "scan"])
def test_sharded_engine_matches_single_device(runner, engine):
    rng = np.random.RandomState(1)
    img_a = smooth_image(rng, (256, 256))
    img_b = smooth_image(rng, (256, 256))
    queries = rng.uniform(30, 226, (8, 2))
    kw = dict(zoom_ins=[0.5], converge_iters=1, max_corrs=8,
              queries_a=queries, force=True)
    cls = FasterSparseEngine if engine == "squad" else SparseEngine
    common = dict(mode="tile", seed_stride=4)
    if engine == "squad":
        common.update(group_bucket=8, group_cap=8)
    single = cls(runner, **common).cotr_corr_multiscale(img_a, img_b, **kw)
    sharded_engine = cls(runner, mesh=make_mesh(devices=MESH), **common)
    sharded = sharded_engine.cotr_corr_multiscale(img_a, img_b, **kw)
    assert single.shape == sharded.shape == (8, 4)
    np.testing.assert_allclose(sharded, single, rtol=0, atol=PX_TOL)
    if engine == "scan":
        assert sharded_engine.refiner.device_task_count == [1] * 8


def _queries(seed, n, lo=(60, 60), hi=(240, 140)):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(lo[0], hi[0], n),
                     rng.uniform(lo[1], hi[1], n)], axis=1)


@pytest.mark.parametrize("converge_iters,cycle_select", [(1, False),
                                                         (3, True)])
def test_sharded_squad_engine_equals_jax_on_stub(converge_iters,
                                                 cycle_select):
    img = smooth_image(np.random.RandomState(7), (200, 300))
    kw = dict(zoom_ins=[0.5, 0.25], converge_iters=converge_iters,
              max_corrs=40, queries_a=_queries(3, 40), force=True,
              return_idx=True, cycle_select=cycle_select)
    grouping = dict(mode="tile", max_load=8, group_cap=16, group_bucket=8,
                    member_bucket=4, seed=2)
    port = FasterSparseEngine(TorchIdentityRunner(),
                              mesh=make_mesh(devices=MESH), **grouping)
    ref = JaxFaster(JaxIdentityRunner(), task_bucket=8, **grouping)
    corrs, idx = port.cotr_corr_multiscale(img, img, **kw)
    want, want_idx = ref.cotr_corr_multiscale(img, img, **kw)
    assert corrs.shape[0] > 30
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(corrs, want)
    stepper = port._stepper
    # counts are global, as the JAX package's; each device took 1/8
    assert stepper.dispatch_count == ref._stepper.dispatch_count
    assert stepper.canvas_count == ref._stepper.canvas_count
    assert stepper.device_canvas_count == [stepper.canvas_count // 8] * 8


def test_sharded_multipair_and_scan_engines_equal_jax_on_stub():
    rng = np.random.RandomState(21)
    pairs = [(smooth_image(rng, hw),) * 2 for hw in [(200, 300), (256, 256)]]
    queries = [_queries(30, 24, lo=(30, 30), hi=(270, 170)),
               _queries(31, 24, lo=(30, 30), hi=(226, 226))]
    kw = dict(zoom_ins=[0.5, 0.25], converge_iters=2, max_corrs=24,
              queries_list=queries, force=True, pair_seeds=[11, 22])
    grouping = dict(mode="tile", max_load=8)
    port = FasterSparseEngine(TorchIdentityRunner(),
                              mesh=make_mesh(devices=MESH), **grouping)
    ref = JaxFaster(JaxIdentityRunner(), task_bucket=8, **grouping)
    for got, want in zip(port.cotr_corr_multiscale_multipair(pairs, **kw),
                         ref.cotr_corr_multiscale_multipair(pairs, **kw)):
        np.testing.assert_array_equal(got, want)
    assert port._stepper.canvas_count == ref._stepper.canvas_count
    assert port._stepper.device_canvas_count == \
        [port._stepper.canvas_count // 8] * 8

    img = pairs[0][0]
    kw = dict(zoom_ins=[0.5, 0.25], converge_iters=2, max_corrs=12,
              queries_a=_queries(4, 12), force=True)
    scan = SparseEngine(TorchIdentityRunner(), mode="tile",
                        mesh=make_mesh(devices=MESH))
    want = JaxEngine(JaxIdentityRunner(), mode="tile", task_bucket=8
                     ).cotr_corr_multiscale(img, img, **kw)
    np.testing.assert_array_equal(scan.cotr_corr_multiscale(img, img, **kw),
                                  want)
    # 12 tasks padded to 16, in one refinement call: two a device
    assert scan.refiner.device_task_count == [2] * 8


def test_engines_refuse_buckets_that_do_not_split():
    with pytest.raises(ValueError, match="multiples"):
        FasterSparseEngine(TorchIdentityRunner(), group_bucket=4,
                           mesh=make_mesh(devices=MESH))


def test_sharded_scan_engine_matches_jax_on_the_small_model():
    """tests/test_torch_engine.py's case with the port's refinement split
    over 4 devices."""
    jmodel, variables, tmodel = small_models()
    rng = np.random.RandomState(1)
    img_a = smooth_image(rng, (240, 240))
    img_b = smooth_image(rng, (240, 240))
    queries = rng.uniform(10, 230, (20, 2))
    kw = dict(zoom_ins=[0.5, 0.25], queries_a=queries, force=True,
              max_corrs=20)
    got = SparseEngine(ModelRunner(tmodel, device="cpu"), mode="tile",
                       seed_stride=4, mesh=make_mesh(devices=["cpu"] * 4)
                       ).cotr_corr_multiscale(img_a, img_b, **kw)
    want = JaxEngine(JaxRunner(jmodel, variables), mode="tile",
                     seed_stride=4, task_bucket=4
                     ).cotr_corr_multiscale(img_a, img_b, **kw)
    _agree(got, want, 20)
