"""The port's SparseEngine vs the JAX package's on a small real model."""

import numpy as np
import pytest

from cotr_tpu.inference.engine import SparseEngine as JaxEngine
from cotr_tpu.inference.runner import ModelRunner as JaxRunner
from cotr_tpu_torch.inference.engine import SparseEngine
from cotr_tpu_torch.inference.runner import ModelRunner
from tests.test_torch_common import small_models, smooth_image


@pytest.fixture(scope="module")
def runners():
    jmodel, variables, tmodel = small_models()
    return JaxRunner(jmodel, variables), ModelRunner(tmodel, device="cpu")


def test_force_queries_at_zoom_depth_2_match_jax(runners):
    """Seeding, two zoom levels and conclude. patch_box floors turn float
    differences between the frameworks into whole-pixel box shifts, so a few
    queries may jump: at least 95% agree within 1 px, the median within
    0.1 px."""
    jrunner, trunner = runners
    rng = np.random.RandomState(1)
    img_a = smooth_image(rng, (240, 240))
    img_b = smooth_image(rng, (240, 240))
    queries = rng.uniform(10, 230, (20, 2))
    kw = dict(zoom_ins=[0.5, 0.25], queries_a=queries, force=True,
              max_corrs=20)
    got = SparseEngine(trunner, mode="tile", seed_stride=4
                       ).cotr_corr_multiscale(img_a, img_b, **kw)
    want = JaxEngine(jrunner, mode="tile", seed_stride=4, task_bucket=4
                     ).cotr_corr_multiscale(img_a, img_b, **kw)
    assert got.shape == want.shape == (20, 4)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    err = np.linalg.norm(got[:, 2:] - want[:, 2:], axis=1)
    assert np.mean(err <= 1.0) >= 0.95, err
    assert np.median(err) <= 0.1, err
