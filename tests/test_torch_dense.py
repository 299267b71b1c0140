"""The port's dense seed pass vs the JAX package's on a small real model."""

import numpy as np
import pytest

from cotr_tpu.inference.dense import dense_flow_many as jax_dense_flow_many
from cotr_tpu.inference.runner import ModelRunner as JaxRunner
from cotr_tpu_torch.inference.dense import dense_flow_many
from cotr_tpu_torch.inference.runner import ModelRunner
from tests.test_torch_common import small_models, smooth_image


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
