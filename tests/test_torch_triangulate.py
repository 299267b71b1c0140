"""The port's copy of the sparse -> dense densification vs the JAX
package's module (numpy and scipy on the host in both)."""

import numpy as np
import pytest
from scipy.spatial import Delaunay

from cotr_tpu.inference import triangulate as jtri
from cotr_tpu_torch.inference import triangulate

#: the two are the same arithmetic on the same scipy triangulation
TOL = 1e-12


def _corrs(seed, n=60, from_hw=(48, 64), to_hw=(40, 72)):
    rng = np.random.RandomState(seed)
    xy = np.stack([rng.uniform(0, from_hw[1], n),
                   rng.uniform(0, from_hw[0], n)], axis=1)
    scale = np.array([to_hw[1] / from_hw[1], to_hw[0] / from_hw[0]])
    return np.concatenate([xy, xy * scale + rng.normal(0, 0.5, (n, 2))],
                          axis=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_corr_matches_jax(seed):
    corr = _corrs(seed)
    got = triangulate.triangulate_corr(corr, (48, 64), (40, 72, 3))
    want = jtri.triangulate_corr(corr, (48, 64), (40, 72, 3))
    assert got.shape == (48, 64, 2)
    assert (got != 0).any() and (got[0, 0] == 0).all()  # outside the hull
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_rasterize_barycentric_matches_jax():
    corr = _corrs(2)
    tri = Delaunay(corr[:, :2])
    args = (corr[:, :2], corr[:, 2:], tri.simplices, tri.transform, (48, 64))
    got = triangulate.rasterize_barycentric(*args)
    want = jtri.rasterize_barycentric(*args)
    assert got.shape == (48, 64, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # inside the hull the interpolation reproduces a linear map's values
    pix = np.array([[32.0, 24.0]])
    s = int(tri.find_simplex(pix)[0])
    assert s >= 0 and np.isfinite(got[24, 32]).all()


def test_degenerate_input_returns_none():
    line = np.stack([np.arange(5.0), np.arange(5.0), np.arange(5.0),
                     np.arange(5.0)], axis=1)  # collinear: no triangulation
    assert triangulate.triangulate_corr(line, (8, 8), (8, 8)) is None
    assert jtri.triangulate_corr(line, (8, 8), (8, 8)) is None
