"""Port vs JAX engine plumbing on the identity stub (twin of
tests/test_engine_modes.py): tile and stretching modes on a non-square
pair, converge_iters > 1 and cycle_select. The stub's arithmetic is exact,
so the two packages must agree exactly.
"""

import numpy as np
import pytest

from cotr_tpu.inference.dense import dense_flow as jax_dense_flow
from cotr_tpu.inference.engine import SparseEngine as JaxEngine
from cotr_tpu_torch.inference.dense import dense_flow, to_square_patches
from cotr_tpu_torch.inference.engine import SparseEngine
from tests.test_torch_common import (JaxIdentityRunner, TorchIdentityRunner,
                                     smooth_image)


@pytest.fixture(scope="module")
def nonsquare_image():
    return smooth_image(np.random.RandomState(7), (200, 300))


def test_to_square_patches_nonsquare(nonsquare_image):
    patches = to_square_patches(nonsquare_image)
    assert [(p.x, p.y, p.w, p.h) for p in patches] == [(0, 0, 200, 200),
                                                        (100, 0, 200, 200)]


def test_dense_flow_tile_matches_jax(nonsquare_image):
    other = np.roll(nonsquare_image, 3, axis=1)
    port = dense_flow(TorchIdentityRunner(), nonsquare_image, other)
    ref = jax_dense_flow(JaxIdentityRunner(), nonsquare_image, other)
    for got, want in zip(port, ref):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,converge_iters,cycle_select,force", [
    ("tile", 1, False, False), ("stretching", 1, False, False),
    ("tile", 3, False, False), ("stretching", 1, True, True),
    ("tile", 2, "rescue", False)])
def test_engine_matches_jax(nonsquare_image, mode, converge_iters,
                            cycle_select, force):
    rng = np.random.RandomState(3)
    queries = np.stack([rng.uniform(60, 240, 12),
                        rng.uniform(60, 140, 12)], axis=1)
    kw = dict(zoom_ins=[0.5, 0.25], converge_iters=converge_iters,
              max_corrs=12, queries_a=queries, force=force,
              return_idx=True, cycle_select=cycle_select)
    port = SparseEngine(TorchIdentityRunner(), batch_size=32, mode=mode)
    ref = JaxEngine(JaxIdentityRunner(), batch_size=32, mode=mode,
                    task_bucket=8)
    corrs, idx = port.cotr_corr_multiscale(nonsquare_image, nonsquare_image,
                                           **kw)
    ref_corrs, ref_idx = ref.cotr_corr_multiscale(nonsquare_image,
                                                  nonsquare_image, **kw)
    assert corrs.shape[0] == 12
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(corrs, ref_corrs)
    assert np.abs(corrs[:, 2:] - corrs[:, :2]).max() < 1.5


def test_random_seeding_and_cycle_wrapper_match_jax(nonsquare_image):
    """Random confident seeds (the RandomState stream) through the
    bidirectional cycle-consistency wrapper."""
    kw = dict(zoom_ins=[0.5, 0.25], max_corrs=20, return_idx=True,
              return_cycle_error=True)
    port = SparseEngine(TorchIdentityRunner(), mode="tile", seed=5)
    ref = JaxEngine(JaxIdentityRunner(), mode="tile", seed=5, task_bucket=8)
    got = port.cotr_corr_multiscale_with_cycle_consistency(
        nonsquare_image, nonsquare_image, **kw)
    want = ref.cotr_corr_multiscale_with_cycle_consistency(
        nonsquare_image, nonsquare_image, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_crop_dtype_follows_the_model_dtype():
    from types import SimpleNamespace

    import torch

    from cotr_tpu_torch.config import COTRConfig

    runner = TorchIdentityRunner()
    assert SparseEngine(runner).crop_dtype == torch.float32
    runner.model = SimpleNamespace(cfg=COTRConfig(dtype="bfloat16"))
    assert SparseEngine(runner).crop_dtype == torch.bfloat16
