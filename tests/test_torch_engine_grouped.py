"""The port's FasterSparseEngine vs the JAX package's: exactly on the
identity stub (whose arithmetic is exact), within a stated tolerance on a
small real model, and its multi-pair entry points against its own serial
loop.

The multi-pair path maps predictions back to pixels in float64 where the
single-pair path rounds that product to float32 (in both packages), so a
multi-pair call agrees with its serial loop to SERIAL_TOL, not bit for bit;
against the JAX multi-pair call it agrees exactly."""

import numpy as np
import pytest

from cotr_tpu.inference.engine import FasterSparseEngine as JaxFaster
from cotr_tpu.inference.engine import SparseEngine as JaxEngine
from cotr_tpu.inference.runner import ModelRunner as JaxRunner
from cotr_tpu_torch.config import InferenceConfig
from cotr_tpu_torch.inference import FasterSparseEngine, SparseEngine
from cotr_tpu_torch.inference.runner import ModelRunner
from tests.test_torch_common import (JaxIdentityRunner, TorchIdentityRunner,
                                     small_models, smooth_image)

ZOOMS = [0.5, 0.25]
#: pixels; float32 rounding of coordinates of a few hundred is 3e-5
SERIAL_TOL = 1e-4


@pytest.fixture(scope="module")
def nonsquare_image():
    return smooth_image(np.random.RandomState(7), (200, 300))


def _queries(seed, n, lo=(60, 60), hi=(240, 140)):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(lo[0], hi[0], n),
                     rng.uniform(lo[1], hi[1], n)], axis=1)


@pytest.mark.parametrize("mode", ["tile", "stretching"])
@pytest.mark.parametrize("safe_area", [0.5, 0.8])
@pytest.mark.parametrize("converge_iters,cycle_select,force", [
    (1, False, False), (3, False, True), (1, True, True)])
def test_faster_engine_matches_jax_on_stub(nonsquare_image, mode, safe_area,
                                           converge_iters, cycle_select,
                                           force):
    """Seeding, squad formation from the engine's stream, refinement, the
    cycle check through the squad machinery, conclude; the counts of device
    calls and padded canvases too."""
    kw = dict(zoom_ins=ZOOMS, converge_iters=converge_iters, max_corrs=40,
              queries_a=_queries(3, 40), force=force, return_idx=True,
              cycle_select=cycle_select)
    grouping = dict(mode=mode, safe_area=safe_area, max_load=8,
                    group_cap=16, group_bucket=4, member_bucket=4, seed=2)
    port = FasterSparseEngine(TorchIdentityRunner(), **grouping)
    ref = JaxFaster(JaxIdentityRunner(), task_bucket=8, **grouping)
    corrs, idx = port.cotr_corr_multiscale(nonsquare_image, nonsquare_image,
                                           **kw)
    ref_corrs, ref_idx = ref.cotr_corr_multiscale(nonsquare_image,
                                                  nonsquare_image, **kw)
    assert corrs.shape[0] > 30
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(corrs, ref_corrs)
    assert port._stepper.dispatch_count == ref._stepper.dispatch_count
    assert port._stepper.canvas_count == ref._stepper.canvas_count
    assert port.total_tasks == ref.total_tasks
    # the squads shared canvases: fewer real canvases than tasks x levels
    assert port._stepper.dispatch_count >= len(ZOOMS)


def test_random_seeding_and_cycle_wrapper_match_jax_on_stub(nonsquare_image):
    kw = dict(zoom_ins=ZOOMS, max_corrs=20, return_idx=True,
              return_cycle_error=True)
    port = FasterSparseEngine(TorchIdentityRunner(), mode="tile", seed=5,
                              max_load=16)
    ref = JaxFaster(JaxIdentityRunner(), mode="tile", seed=5, max_load=16,
                    task_bucket=8)
    got = port.cotr_corr_multiscale_with_cycle_consistency(
        nonsquare_image, nonsquare_image, **kw)
    want = ref.cotr_corr_multiscale_with_cycle_consistency(
        nonsquare_image, nonsquare_image, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _stub_pairs():
    rng = np.random.RandomState(21)
    sizes = [(200, 300), (256, 256), (180, 240)]
    pairs = []
    for hw in sizes:
        img = smooth_image(rng, hw)
        pairs.append((img, img))
    queries = [_queries(30 + k, 24, lo=(30, 30), hi=(hw[1] - 30, hw[0] - 30))
               for k, hw in enumerate(sizes)]
    return pairs, queries, [11, 22, 33]


@pytest.mark.parametrize("seeding", ["force", "filtered", "random", "areas"])
def test_multipair_matches_serial_loop_and_jax_on_stub(seeding):
    """One multi-pair call equals N serial calls on engines seeded
    pair_seeds[i] (each pair draws from a stream of its own), and equals the
    JAX multi-pair call."""
    pairs, queries, seeds = _stub_pairs()
    kw = dict(zoom_ins=ZOOMS, converge_iters=2, max_corrs=24)
    single_kw, multi_kw = dict(kw), dict(kw)
    if seeding == "random":
        queries = [None] * len(pairs)
    else:
        multi_kw["queries_list"] = queries
        multi_kw["force"] = single_kw["force"] = seeding != "filtered"
    if seeding == "areas":
        multi_kw["areas_list"] = [(0.5, 0.4)] * len(pairs)
        single_kw["areas"] = (0.5, 0.4)
    grouping = dict(mode="tile", max_load=8)

    serial = []
    for (a, b), q, seed in zip(pairs, queries, seeds):
        eng = FasterSparseEngine(TorchIdentityRunner(), seed=seed, **grouping)
        serial.append(eng.cotr_corr_multiscale(a, b, queries_a=q,
                                               return_idx=True, **single_kw))
    port = FasterSparseEngine(TorchIdentityRunner(), **grouping)
    multi = port.cotr_corr_multiscale_multipair(
        pairs, return_idx=True, pair_seeds=seeds, **multi_kw)
    ref = JaxFaster(JaxIdentityRunner(), task_bucket=8, **grouping)
    want = ref.cotr_corr_multiscale_multipair(
        pairs, return_idx=True, pair_seeds=seeds, **multi_kw)
    assert len(multi) == len(pairs)
    for (corrs, idx), (s_corrs, s_idx), (j_corrs, j_idx) in zip(
            multi, serial, want):
        assert corrs.shape[0] > 0
        np.testing.assert_array_equal(idx, s_idx)
        err = np.abs(corrs - s_corrs).max(axis=1)
        if seeding == "random":
            # random seeds sit on whole pixels, where the rounding above
            # decides which way patch_box_np's floor falls: a few answers
            # move by one pixel
            assert err.max() <= 1.0 + SERIAL_TOL, err
            assert np.mean(err <= SERIAL_TOL) >= 0.8, err
        else:
            assert err.max() <= SERIAL_TOL, err
        np.testing.assert_array_equal(idx, j_idx)
        np.testing.assert_array_equal(corrs, j_corrs)
    assert port._stepper.dispatch_count == ref._stepper.dispatch_count
    assert port._stepper.canvas_count == ref._stepper.canvas_count
    # without return_idx the corrs come alone
    again = FasterSparseEngine(TorchIdentityRunner(), **grouping)
    plain = again.cotr_corr_multiscale_multipair(pairs, pair_seeds=seeds,
                                                 **multi_kw)
    np.testing.assert_array_equal(plain[0], multi[0][0])


@pytest.mark.parametrize("with_queries", [True, False])
def test_cycle_multipair_matches_serial_loop_and_jax_on_stub(with_queries):
    """Each pair's forward and backward pass consume ONE stream in serial
    order, so the multi-pair wrapper equals serial cycle calls."""
    pairs, queries, seeds = _stub_pairs()
    if not with_queries:
        queries = [None] * len(pairs)
    kw = dict(zoom_ins=ZOOMS, max_corrs=24, return_idx=True,
              return_cycle_error=True)
    grouping = dict(mode="tile", max_load=8)
    serial = []
    for (a, b), q, seed in zip(pairs, queries, seeds):
        eng = FasterSparseEngine(TorchIdentityRunner(), seed=seed, **grouping)
        serial.append(eng.cotr_corr_multiscale_with_cycle_consistency(
            a, b, queries_a=q, **kw))
    multi = FasterSparseEngine(TorchIdentityRunner(), **grouping
                               ).cotr_corr_multiscale_with_cycle_consistency_multipair(
        pairs, queries_list=queries, pair_seeds=seeds, **kw)
    want = JaxFaster(JaxIdentityRunner(), task_bucket=8, **grouping
                     ).cotr_corr_multiscale_with_cycle_consistency_multipair(
        pairs, queries_list=queries, pair_seeds=seeds, **kw)
    for got, ser, ref in zip(multi, serial, want):
        assert len(got) == 3 and got[0].shape[0] > 0
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        if not with_queries:
            # random seeds: the 24 kept are the least of 80 cycle errors
            # that tie at the rounding's size, so the serial loop may keep
            # others; only the JAX multi-pair call is comparable
            continue
        # rows are ranked by cycle errors that tie to within the rounding,
        # so they are held together by their query index
        order, s_order = np.argsort(got[1]), np.argsort(ser[1])
        np.testing.assert_array_equal(got[1][order], ser[1][s_order])
        np.testing.assert_allclose(got[0][order], ser[0][s_order], rtol=0,
                                   atol=SERIAL_TOL)
        np.testing.assert_allclose(got[2][order], ser[2][s_order], rtol=0,
                                   atol=2 * SERIAL_TOL)


def test_multipair_draws_pair_seeds_from_the_engine_stream():
    pairs, queries, _ = _stub_pairs()
    kw = dict(zoom_ins=ZOOMS, max_corrs=24, queries_list=queries, force=True)
    got = FasterSparseEngine(TorchIdentityRunner(), mode="tile", seed=4,
                             max_load=8
                             ).cotr_corr_multiscale_multipair(pairs, **kw)
    want = JaxFaster(JaxIdentityRunner(), mode="tile", seed=4, max_load=8,
                     task_bucket=8
                     ).cotr_corr_multiscale_multipair(pairs, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert FasterSparseEngine(TorchIdentityRunner()
                              ).cotr_corr_multiscale_multipair([]) == []


def test_multipair_input_errors():
    pairs, queries, seeds = _stub_pairs()
    eng = FasterSparseEngine(TorchIdentityRunner(), mode="tile")
    with pytest.raises(ValueError):
        eng.cotr_corr_multiscale_multipair(
            pairs, queries_list=queries, force=False,
            areas_list=[(0.5, 0.5)] * 3)
    with pytest.raises(ValueError):
        eng.cotr_corr_multiscale_multipair(
            pairs, queries_list=[None] * 3, force=True,
            areas_list=[(0.5, 0.5)] * 3)


@pytest.mark.parametrize("safe_area", [1.5, 0.0, -0.5])
def test_safe_area_out_of_range_raises(safe_area):
    with pytest.raises(ValueError):
        FasterSparseEngine(TorchIdentityRunner(), safe_area=safe_area)
    with pytest.raises(ValueError):
        JaxFaster(JaxIdentityRunner(), safe_area=safe_area)


def test_constructor_and_from_config():
    cfg = InferenceConfig(mode="tile", max_load=32, batch_size=16)
    eng = FasterSparseEngine.from_config(TorchIdentityRunner(), cfg,
                                         safe_area=0.8)
    assert (eng.max_load, eng.mode, eng.batch_size, eng.safe_area) == \
        (32, "tile", 16, 0.8)
    assert (eng.group_cap, eng.group_bucket, eng.member_bucket,
            eng.member_ladder) == (128, 8, 64, False)


def test_stack_images_pads_to_the_bucket():
    rng = np.random.RandomState(0)
    imgs = [smooth_image(rng, (200, 300)), smooth_image(rng, (260, 100))]
    eng = FasterSparseEngine(TorchIdentityRunner())
    stack = eng._stack_images(imgs)
    assert tuple(stack.shape) == (2, 512, 512, 3)
    np.testing.assert_array_equal(
        stack[0, :200, :300].numpy(), imgs[0].astype(np.float32) / 255.0)
    assert float(stack[0, 200:].abs().max()) == 0.0
    ref = JaxFaster(JaxIdentityRunner())._stack_images(imgs)
    np.testing.assert_array_equal(stack.numpy(), np.asarray(ref))
    # a float image in [0, 255] among them: everything is scaled on the host
    mixed = eng._stack_images([imgs[0], imgs[1].astype(np.float32)])
    np.testing.assert_allclose(mixed.numpy(), stack.numpy(), atol=1e-7)


@pytest.mark.parametrize("engine_kind", ["scan", "squad"])
@pytest.mark.parametrize("cycle_select", [False, True, "rescue"])
def test_collect_diagnostics_matches_jax_on_stub(nonsquare_image,
                                                 engine_kind, cycle_select):
    """The opt-in diagnostics hold the same keys with equal arrays."""
    if engine_kind == "scan":
        port = SparseEngine(TorchIdentityRunner(), mode="tile")
        ref = JaxEngine(JaxIdentityRunner(), mode="tile", task_bucket=8)
    else:
        port = FasterSparseEngine(TorchIdentityRunner(), mode="tile",
                                  max_load=8)
        ref = JaxFaster(JaxIdentityRunner(), mode="tile", max_load=8,
                        task_bucket=8)
    assert port.collect_diagnostics is False and port.last_diag is None
    kw = dict(zoom_ins=ZOOMS, max_corrs=16, queries_a=_queries(4, 16),
              force=True, cycle_select=cycle_select)
    # (both engines make the same calls, so their streams stay in step)
    port.cotr_corr_multiscale(nonsquare_image, nonsquare_image, **kw)
    ref.cotr_corr_multiscale(nonsquare_image, nonsquare_image, **kw)
    assert port.last_diag is None
    port.collect_diagnostics = ref.collect_diagnostics = True
    port.cotr_corr_multiscale(nonsquare_image, nonsquare_image, **kw)
    ref.cotr_corr_multiscale(nonsquare_image, nonsquare_image, **kw)
    got, want = port.last_diag, ref.last_diag
    assert sorted(got) == sorted(want)
    assert ("cycle_err" in got) == bool(cycle_select)
    assert got["history"].shape == (3, 16, 2)  # seed + 2 zoom levels
    assert got["ident"].tolist() == list(range(16))
    assert got["kept_by_filters"].sum() >= 12
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.fixture(scope="module")
def runners():
    jmodel, variables, tmodel = small_models()
    return JaxRunner(jmodel, variables), ModelRunner(tmodel, device="cpu")


def _agree(got, want, n):
    """patch_box floors turn float differences between the frameworks into
    whole-pixel box shifts, so a few queries may jump: at least 95% agree
    within 1 px, the median within 0.1 px."""
    assert got.shape == want.shape == (n, 4)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    err = np.linalg.norm(got[:, 2:] - want[:, 2:], axis=1)
    assert np.mean(err <= 1.0) >= 0.95, err
    assert np.median(err) <= 0.1, err


def test_faster_engine_at_zoom_depth_2_matches_jax(runners):
    """Seeding, two zoom levels of squads and conclude on a small real
    model."""
    jrunner, trunner = runners
    rng = np.random.RandomState(1)
    img_a = smooth_image(rng, (240, 240))
    img_b = smooth_image(rng, (240, 240))
    # clustered queries, so squads have members
    centres = rng.uniform(40, 200, (4, 2))
    queries = centres[rng.randint(0, 4, 24)] + rng.uniform(-8, 8, (24, 2))
    kw = dict(zoom_ins=ZOOMS, queries_a=queries, force=True, max_corrs=24)
    grouping = dict(mode="tile", seed_stride=4, max_load=8, group_cap=8,
                    group_bucket=4, member_bucket=4)
    port = FasterSparseEngine(trunner, **grouping)
    ref = JaxFaster(jrunner, task_bucket=4, **grouping)
    got = port.cotr_corr_multiscale(img_a, img_b, **kw)
    want = ref.cotr_corr_multiscale(img_a, img_b, **kw)
    _agree(got, want, 24)
    assert port._stepper.canvas_count < 24 * len(ZOOMS) + 8


def test_multipair_on_the_small_model_matches_jax(runners):
    jrunner, trunner = runners
    rng = np.random.RandomState(2)
    pairs = [(smooth_image(rng, (240, 240)), smooth_image(rng, (240, 240)))
             for _ in range(2)]
    queries = [rng.uniform(20, 220, (12, 2)) for _ in pairs]
    kw = dict(zoom_ins=ZOOMS, queries_list=queries, force=True,
              max_corrs=12, pair_seeds=[3, 4])
    grouping = dict(mode="tile", seed_stride=4, max_load=8, group_cap=8,
                    group_bucket=4, member_bucket=4)
    got = FasterSparseEngine(trunner, **grouping
                             ).cotr_corr_multiscale_multipair(pairs, **kw)
    want = JaxFaster(jrunner, task_bucket=4, **grouping
                     ).cotr_corr_multiscale_multipair(pairs, **kw)
    for g, w in zip(got, want):
        _agree(g, w, 12)
