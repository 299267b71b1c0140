"""The port's squad refinement (inference/grouped.py, native.py) vs the JAX
package's: the host-side functions exactly, squad formation in both
implementations, and ``refine_grouped`` on the identity stub."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cotr_tpu.inference import grouped as jgrouped
from cotr_tpu_torch import native
from cotr_tpu_torch.inference import grouped
from tests.test_torch_common import (JaxIdentityRunner, TorchIdentityRunner,
                                     smooth_image)


def test_constants_match_jax():
    assert grouped.SAFE_AREA == jgrouped.SAFE_AREA
    assert grouped.CELL_CAP == jgrouped.CELL_CAP


@pytest.mark.parametrize("size,min_dim", [(0.0, 512), (1.0, 512),
                                          (63.9, 512), (64.0, 512),
                                          (65.0, 512), (383.0, 768),
                                          (500.0, 256), (1000.5, 768)])
def test_window_ladder_matches_jax(size, min_dim):
    assert grouped.window_ladder(size, min_dim) == \
        jgrouped.window_ladder(size, min_dim)


@pytest.mark.parametrize("scale", [0.0, 0.0625, 0.3541, 0.5, 1.0, 1.7])
def test_patch_box_np_matches_jax(scale):
    rng = np.random.RandomState(0)
    pos = np.stack([rng.uniform(-20, 660, 50), rng.uniform(-20, 500, 50)], 1)
    got = grouped.patch_box_np(pos, scale, 480, 640)
    want = jgrouped.patch_box_np(pos, scale, 480, 640)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert isinstance(got[2], float)


@pytest.mark.parametrize("member_ladder", [False, True])
def test_member_pad_matches_jax(member_ladder):
    for max_load, bucket in [(256, 64), (8, 64), (4000, 64), (63, 16)]:
        for m_max in (1, 2, 15, 16, 17, 64, 65, 100, 257, 3000, 4001):
            assert grouped._member_pad(m_max, max_load, bucket,
                                       member_ladder) == \
                jgrouped._member_pad(m_max, max_load, bucket, member_ladder)


def _tasks(seed, t=400, hw=(480, 640)):
    rng = np.random.RandomState(seed)
    loc_from = np.stack([rng.uniform(0, hw[1], t), rng.uniform(0, hw[0], t)],
                        axis=1)
    # clustered: a third of the tasks sit around a few centres
    centres = loc_from[rng.randint(0, t, 5)]
    k = t // 3
    loc_from[:k] = centres[rng.randint(0, 5, k)] + rng.normal(0, 12, (k, 2))
    loc_to = loc_from + rng.normal(0, 4, (t, 2))
    active = rng.rand(t) < 0.9
    return loc_from, loc_to, active


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("impl", ["numpy", "native"])
def test_form_squads_matches_jax(seed, impl):
    """Same RandomState stream, same squads; the stream is consumed by one
    permutation a call in both packages."""
    loc_from, loc_to, active = _tasks(seed)
    args = (loc_from, loc_to, active, 0.25, 0.2, (480, 640), (480, 640), 8)
    rng, jrng = np.random.RandomState(seed), np.random.RandomState(seed)
    for safe_area in (0.5, 0.8):
        got = grouped.form_squads(*args, rng, safe_area=safe_area, impl=impl)
        want = jgrouped.form_squads(*args, jrng, safe_area=safe_area)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert rng.randint(1 << 30) == jrng.randint(1 << 30)


def test_form_squads_rejects_unknown_impl():
    loc_from, loc_to, active = _tasks(0, t=10)
    with pytest.raises(ValueError):
        grouped.form_squads(loc_from, loc_to, active, 0.25, 0.25, (480, 640),
                            (480, 640), 8, np.random.RandomState(0),
                            impl="fast")


def test_native_form_squads_degenerate_half_width():
    """Twin of tests/test_native.py's case: a half-width of 0 must not blow
    up the grid; every task becomes a squad of one, as in the numpy scan."""
    rng = np.random.RandomState(0)
    t = 64
    loc = np.stack([rng.uniform(0, 500, t), rng.uniform(0, 400, t)], 1)
    active = np.ones(t, bool)
    order = np.arange(t)
    sq, pilots = native.form_squads(loc, loc, loc[:, 0], loc[:, 1],
                                    loc[:, 0], loc[:, 1], active, 0.0, 0.0,
                                    order, 8)
    ref_sq, ref_pilots = jgrouped._form_squads_numpy(
        loc, loc, active, loc[:, 0], loc[:, 1], loc[:, 0], loc[:, 1],
        0.0, 0.0, order, 8)
    np.testing.assert_array_equal(pilots, ref_pilots)
    np.testing.assert_array_equal(sq, ref_sq)
    assert len(pilots) == t


def test_native_form_squads_pilot_stays_in_its_own_squad():
    """More than max_load free tasks in one window, the pilot's id past the
    cap: the pilot is still a member of its squad, in both versions."""
    t, max_load = 40, 8
    loc = np.full((t, 2), 100.0) + np.arange(t)[:, None] * 1e-3
    active = np.ones(t, bool)
    order = np.array([30] + [i for i in range(t) if i != 30])
    sq, pilots = grouped._form_squads_numpy(
        loc, loc, active, loc[:, 0], loc[:, 1], loc[:, 0], loc[:, 1],
        50.0, 50.0, order, max_load)
    assert pilots[0] == 30 and sq[30] == 0
    assert (sq == 0).sum() == max_load + 1
    nsq, npilots = native.form_squads(loc, loc, loc[:, 0], loc[:, 1],
                                      loc[:, 0], loc[:, 1], active, 50.0,
                                      50.0, order, max_load)
    np.testing.assert_array_equal(nsq, sq)
    np.testing.assert_array_equal(npilots, pilots)


def test_native_form_squads_checks_what_it_indexes_by():
    loc = np.zeros((4, 2))
    ok = (loc, loc, loc[:, 0], loc[:, 1], loc[:, 0], loc[:, 1],
          np.ones(4, bool), 1.0, 1.0)
    with pytest.raises(ValueError):
        native.form_squads(*ok, np.array([0, 4]), 8)
    with pytest.raises(ValueError):
        native.form_squads(*ok, np.array([-1]), 8)
    with pytest.raises(ValueError):
        native.form_squads(loc, loc[:3], *ok[2:], np.arange(4), 8)


def test_squad_tables_match_jax():
    loc_from, loc_to, active = _tasks(3)
    squad_of, pilots = grouped.form_squads(
        loc_from, loc_to, active, 0.25, 0.25, (480, 640), (480, 640), 8,
        np.random.RandomState(3), impl="numpy")
    x0, y0, sf = grouped.patch_box_np(loc_from[pilots], 0.25, 480, 640)
    got = grouped._squad_tables(loc_from, squad_of, len(pilots), x0, y0, sf)
    want = jgrouped._squad_tables(loc_from, squad_of, len(pilots), x0, y0,
                                  sf)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_grouped_stepper_fractional_boxes_use_generic_crop():
    """Twin of tests/test_ops.py's case: boxes with fractional corners must
    not take the windowed crop, whose gather starts at whole pixels."""
    stepper = grouped.GroupedStepper(TorchIdentityRunner())
    intact = np.array([[10.0, 20.0, 64.0, 64.0]], np.float32)
    frac = np.array([[10.5, 20.25, 64.0, 64.0]], np.float32)
    mixed = np.array([[10.0, 20.0, 64.0, 64.0], [0.0, 0.0, 32.0, 32.0]],
                     np.float32)
    assert stepper._step_for(intact, intact) == (64, 64)
    assert stepper._step_for(frac, intact) == (None, None)
    assert stepper._step_for(intact, frac) == (None, None)
    assert stepper._step_for(mixed, intact) == (None, None)
    # and the generic crop really serves them
    img = torch.from_numpy(
        smooth_image(np.random.RandomState(0), (120, 160))).float() / 255
    out = stepper.dispatch(img, img, frac, frac,
                           np.full((1, 3, 2), 0.25, np.float32))
    assert out.shape == (1, 3, 2)
    assert (stepper.dispatch_count, stepper.canvas_count) == (1, 1)


@pytest.mark.parametrize("converge_iters", [1, 3])
@pytest.mark.parametrize("member_ladder", [False, True])
def test_refine_grouped_matches_jax(converge_iters, member_ladder):
    """The identity stub's arithmetic is exact, so the histories must be
    equal, and so must the counts of device calls and padded canvases."""
    rng = np.random.RandomState(11)
    img = smooth_image(rng, (200, 300))
    t = 150
    loc_from = np.stack([rng.uniform(20, 280, t), rng.uniform(20, 180, t)],
                        axis=1)
    loc_to = loc_from + rng.normal(0, 3, (t, 2))
    kw = dict(converge_iters=converge_iters, max_load=16, group_bucket=4,
              member_bucket=8, group_cap=16, member_ladder=member_ladder)
    zooms = [0.5, 0.25, 0.125]

    trunner = TorchIdentityRunner()
    stepper = grouped.GroupedStepper(trunner)
    dev = torch.from_numpy(img).float() / 255.0
    got = grouped.refine_grouped(
        trunner, stepper, dev, img.shape[:2], dev, img.shape[:2], loc_from,
        loc_to, 1.0, 1.0, zooms, np.random.RandomState(5), **kw)

    jrunner = JaxIdentityRunner()
    jstepper = jgrouped.GroupedStepper(jrunner)
    jdev = jnp.asarray(img).astype(jnp.float32) / 255.0
    want = jgrouped.refine_grouped(
        jrunner, jstepper, jdev, img.shape[:2], jdev, img.shape[:2],
        loc_from, loc_to, 1.0, 1.0, zooms, np.random.RandomState(5), **kw)

    assert got.shape == (3, t, 2)
    np.testing.assert_array_equal(got, want)
    assert stepper.dispatch_count == jstepper.dispatch_count
    assert stepper.canvas_count == jstepper.canvas_count
    assert stepper.canvas_count >= stepper.dispatch_count > 3
    # the stub maps each query onto itself within the squad's canvas, so a
    # target lands on its query, moved by the offset between the pilot's two
    # boxes (the seeds' 3-px noise)
    assert np.abs(got[-1] - loc_from).max() < 16.0


def test_refine_grouped_numpy_and_native_squads_agree():
    rng = np.random.RandomState(12)
    img = smooth_image(rng, (200, 300))
    loc_from = np.stack([rng.uniform(20, 280, 80), rng.uniform(20, 180, 80)],
                        axis=1)
    dev = torch.from_numpy(img).float() / 255.0
    out = {}
    for impl in ("native", "numpy"):
        runner = TorchIdentityRunner()
        out[impl] = grouped.refine_grouped(
            runner, grouped.GroupedStepper(runner), dev, img.shape[:2], dev,
            img.shape[:2], loc_from, loc_from + 2.0, 1.0, 1.0, [0.5, 0.25],
            np.random.RandomState(1), max_load=8, squads_impl=impl)
    np.testing.assert_array_equal(out["native"], out["numpy"])
