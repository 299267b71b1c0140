"""The port's dense seed pass vs the JAX package's on a small real model,
and its device-resident mapping, resize and merge against the host path
they replaced (per-field mapping and resize copied to the host, then
``merge_flow_patches``), to the bit."""

import numpy as np
import pytest
import torch

from cotr_tpu.inference.dense import dense_flow_many as jax_dense_flow_many
from cotr_tpu.inference.runner import ModelRunner as JaxRunner
from cotr_tpu_torch.inference import dense
from cotr_tpu_torch.inference.dense import (ImagePatch, _patch_affine,
                                            dense_flow_many,
                                            merge_flow_patches,
                                            to_square_patches)
from cotr_tpu_torch.inference.runner import ModelRunner
from cotr_tpu_torch.ops.sampling import resize_pil
from cotr_tpu_torch.utils.constants import MAX_SIZE
from tests.test_torch_common import (TorchIdentityRunner, small_models,
                                     smooth_image)


@pytest.fixture(scope="module")
def runners():
    jmodel, variables, tmodel = small_models()
    return JaxRunner(jmodel, variables), ModelRunner(tmodel, device="cpu")


def test_dense_flow_seed_stride_4_matches_jax(runners):
    """Tile mode on a non-square pair (2x2 patch canvases), stride-4 grid:
    encode, chunked decode, self-cycle confidence, per-half remap, patch
    affines, host field resize and min-confidence merge."""
    jrunner, trunner = runners
    rng = np.random.RandomState(0)
    pair = (smooth_image(rng, (200, 300)), smooth_image(rng, (200, 300)))
    want = jax_dense_flow_many(jrunner, [pair], seed_stride=4)[0]
    got = dense_flow_many(trunner, [pair], seed_stride=4)[0]
    for name, g, w in zip(("corr_a", "con_a", "corr_b", "con_b"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-3, err_msg=name)


# ------------------------------------------- the seed's fields on the device


def _old_field_to_frame(field, affine, p):
    """The host path this module's device step replaced: one side's field
    mapped by its patch affine in float64, resized with PIL's filter, then
    copied to the host."""
    s, t = (torch.from_numpy(a).to(field.device) for a in affine)
    field = torch.cat([(field[..., :2].double() * s + t).float(),
                       field[..., 2:]], dim=-1)
    return resize_pil(field, (p.h, p.w)).cpu().numpy()


def _old_fields(pairs, corr_all, seed_stride):
    """The oracle: per-field ``_old_field_to_frame`` of the recorded dense
    pass, then ``merge_flow_patches`` of each pair's sides on the host."""
    jobs = [(pi, p_i, p_j) for pi, (a, b) in enumerate(pairs)
            for p_i in to_square_patches(a) for p_j in to_square_patches(b)]
    sides = [([], []) for _ in pairs]
    half = MAX_SIZE // seed_stride
    for k, (pi, p_i, p_j) in enumerate(jobs):
        c_i = _old_field_to_frame(corr_all[k, :, :half], _patch_affine(p_j),
                                  p_i)
        c_j = _old_field_to_frame(corr_all[k, :, half:], _patch_affine(p_i),
                                  p_j)
        sides[pi][0].append(ImagePatch(c_i, p_i.x, p_i.y, p_i.w, p_i.h,
                                       p_i.ow, p_i.oh))
        sides[pi][1].append(ImagePatch(c_j, p_j.x, p_j.y, p_j.w, p_j.h,
                                       p_j.ow, p_j.oh))
    out = []
    for side_a, side_b in sides:
        corr_a, con_a, _ = merge_flow_patches(side_a)
        corr_b, con_b, _ = merge_flow_patches(side_b)
        out.append((corr_a, con_a, corr_b, con_b))
    return out


def _run_recorded(monkeypatch, runner, pairs, seed_stride, dense_pass=None):
    """``dense_flow_many`` with its dense passes and host copies recorded:
    (result, the passes' outputs concatenated, the number of copies to the
    host). Asserts that the device step left the passes' outputs as they
    came."""
    passes, copies = [], []
    run_pass = dense_pass or dense.dense_pass_device
    copy = dense._copy_to_host

    def recorded_pass(*a, **k):
        out = run_pass(*a, **k)
        passes.append((out, out.clone()))
        return out

    monkeypatch.setattr(dense, "dense_pass_device", recorded_pass)
    monkeypatch.setattr(dense, "_copy_to_host",
                        lambda t: copies.append(t.shape) or copy(t))
    got = dense.dense_flow_many(runner, pairs, seed_stride=seed_stride)
    for out, before in passes:
        np.testing.assert_array_equal(out.numpy(), before.numpy())
    return got, torch.cat([out for out, _ in passes], dim=0), len(copies)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g_pair, w_pair in zip(got, want):
        for name, g, w in zip(("corr_a", "con_a", "corr_b", "con_b"),
                              g_pair, w_pair):
            assert g.dtype == np.float64 and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _frame_shapes(pairs):
    return {im.shape[:2] for pair in pairs for im in pair}


@pytest.fixture(scope="module")
def port_runner():
    return ModelRunner(small_models()[2], device="cpu")


_PAIR_CASES = {
    # landscape against portrait: 2 x 2 patch canvases, two frame shapes
    "landscape_portrait": [((200, 300), (300, 200))],
    # square: one canvas, each side its one patch as it is
    "square": [((160, 160), (160, 160))],
    # two pairs of other frame shapes in one call; the second pair's square
    # side merges the two fields of its one patch
    "two_shapes": [((200, 300), (300, 200)), ((150, 250), (150, 150))],
}


@pytest.mark.parametrize("seed_stride", [1, 4])
@pytest.mark.parametrize("case", sorted(_PAIR_CASES))
def test_dense_flow_many_equals_the_host_merge(monkeypatch, port_runner,
                                               case, seed_stride):
    """The device-resident mapping, resize and merge give the host path's
    fields to the bit, in one copy to the host per frame shape (the host
    path made two a job), and leave the dense passes' outputs as they
    were."""
    rng = np.random.RandomState(3)
    pairs = [(smooth_image(rng, a), smooth_image(rng, b))
             for a, b in _PAIR_CASES[case]]
    got, corr_all, n_copies = _run_recorded(monkeypatch, port_runner, pairs,
                                            seed_stride)
    _assert_same(got, _old_fields(pairs, corr_all, seed_stride))
    assert n_copies == len(_frame_shapes(pairs))


def _handmade_pass(fields):
    def run(runner, canvas, stride=1):
        return fields[:canvas.shape[0]].clone()
    return run


def test_device_merge_keeps_ties_the_fill_and_nan_as_the_host_merge(
        monkeypatch):
    """A handmade dense pass on a 256 x 384 / 384 x 256 pair at stride 1
    (the patch fields need no resize, so the values below reach the merge
    as they are): per job and side a constant confidence, with ties between
    jobs, exactly 100.0 (the fill, which never wins), above 100, and NaN
    (never wins); random flows, so a tie taken by the wrong patch shows."""
    rng = np.random.RandomState(5)
    pairs = [(smooth_image(rng, (256, 384)), smooth_image(rng, (384, 256)))]
    nan = float("nan")
    conf_a = [0.5, 0.5, 100.0, nan]   # jobs (i0, j0), (i0, j1), (i1, ...)
    conf_b = [nan, 0.25, 0.25, 120.0]
    fields = torch.from_numpy(rng.uniform(-1, 1, (4, 256, 512, 3)).astype(
        np.float32))
    for k in range(4):
        fields[k, :, :256, 2] = conf_a[k]
        fields[k, :, 256:, 2] = conf_b[k]
    # a few pixels of ties and NaN inside otherwise ordered fields
    fields[1, 10:20, 30:40, 2] = nan
    fields[2, 50:60, 300:310, 2] = 0.25

    got, corr_all, n_copies = _run_recorded(
        monkeypatch, TorchIdentityRunner(), pairs, 1, _handmade_pass(fields))
    _assert_same(got, _old_fields(pairs, corr_all, 1))
    assert n_copies == 2
    con_a, con_b = got[0][1], got[0][3]
    # the overlap of side a's two patches holds the tie at 0.5 and the
    # fill; side b's jobs 1 and 2 tie at 0.25
    assert (con_a == 0.5).any() and (con_a == 100.0).any()
    assert (con_b == 0.25).any() and not np.isnan(con_b).any()


def test_single_patch_sides_pass_through_as_the_host_merge(monkeypatch):
    """A square pair's sides are each one patch over the whole frame: both
    paths hand its field on as it is, confidences of 100, above 100 and NaN
    included, where a merge would have put the fill."""
    rng = np.random.RandomState(6)
    pairs = [(smooth_image(rng, (256, 256)), smooth_image(rng, (256, 256)))]
    fields = torch.from_numpy(rng.uniform(0, 1, (1, 256, 512, 3)).astype(
        np.float32))
    fields[0, 0:8, :, 2] = float("nan")
    fields[0, 8:16, :, 2] = 100.0
    fields[0, 16:24, :, 2] = 120.0
    got, corr_all, n_copies = _run_recorded(
        monkeypatch, TorchIdentityRunner(), pairs, 1, _handmade_pass(fields))
    _assert_same(got, _old_fields(pairs, corr_all, 1))
    assert n_copies == 1
    for con in (got[0][1], got[0][3]):
        assert np.isnan(con[0:8]).all() and (con[16:24] == 120.0).all()
