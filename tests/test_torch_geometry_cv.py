"""ops/geometry_cv: the cases of tests/test_cv_ops.py on both packages, and
the port against the JAX package on the same inputs. The numpy functions
are copies and agree exactly; ``warp_perspective`` to 1e-3 on a [0, 255]
image (5e-3 where the output runs past the image's edge); the 8-point F to
1e-5 up to sign; RANSAC on its inlier mask (the two draw their hypotheses
from different generators)."""

import numpy as np
import pytest
import torch

from cotr_tpu.ops import geometry_cv as jax_cv
from cotr_tpu_torch.ops import geometry_cv as port_cv

PACKAGES = {"jax": jax_cv, "port": port_cv}


def _warp(cv, img, h, out_hw):
    """``warp_perspective`` of a numpy image: the port's takes a tensor."""
    if cv is port_cv:
        return port_cv.warp_perspective(torch.from_numpy(img), h,
                                        out_hw).numpy()
    return np.asarray(cv.warp_perspective(img, h, out_hw))


def _ransac(cv, *args, **kw):
    if cv is port_cv:
        kw["device"] = "cpu"
    return cv.find_fundamental_ransac(*args, **kw)


def _two_view_scene(n=200, outliers=0, seed=3):
    rng = np.random.RandomState(seed)
    k = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    pts = rng.uniform(-1, 1, (n, 3))
    pts[:, 2] = rng.uniform(3, 6, n)
    r = np.eye(3)
    t = np.array([0.5, 0.05, 0.0])
    p1 = (k @ pts.T).T
    p1 = p1[:, :2] / p1[:, 2:3]
    cam2 = (r @ pts.T).T + t
    p2 = (k @ cam2.T).T
    p2 = p2[:, :2] / p2[:, 2:3]
    if outliers:
        # the LAST `outliers` rows are corrupted
        p2[n - outliers:] += rng.uniform(30, 80, (outliers, 2))
    return p1, p2, k, r, t


@pytest.mark.parametrize("pkg", PACKAGES)
def test_affine_from_3pts_exact(pkg):
    rng = np.random.RandomState(0)
    a_true = rng.uniform(-2, 2, (2, 3))
    src = rng.uniform(0, 100, (3, 2))
    dst = src @ a_true[:, :2].T + a_true[:, 2]
    np.testing.assert_allclose(PACKAGES[pkg].affine_from_3pts(src, dst),
                               a_true, atol=1e-9)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_homography_roundtrip(pkg):
    cv = PACKAGES[pkg]
    rng = np.random.RandomState(1)
    h_true = np.eye(3) + rng.uniform(-0.1, 0.1, (3, 3))
    h_true /= h_true[2, 2]
    src = np.array([[0.0, 0], [100, 0], [100, 100], [0, 100]])
    dst = cv.apply_homography(h_true, src)
    np.testing.assert_allclose(cv.homography_from_4pts(src, dst), h_true,
                               atol=1e-8)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_warp_perspective_identity(pkg):
    rng = np.random.RandomState(2)
    img = rng.uniform(0, 1, (16, 20, 3)).astype(np.float32)
    out = _warp(PACKAGES[pkg], img, np.eye(3), (16, 20))
    np.testing.assert_allclose(out, img, atol=1e-5)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_eight_point_matches_ground_truth_f(pkg):
    p1, p2, k, r, t = _two_view_scene()
    f = np.asarray(PACKAGES[pkg].eight_point(p1[:50], p2[:50]))
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    f_true = np.linalg.inv(k).T @ tx @ r @ np.linalg.inv(k)
    f_true /= np.linalg.norm(f_true)
    err = min(np.abs(f - f_true).max(), np.abs(f + f_true).max())
    assert err < 5e-4, err


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ransac_fundamental_rejects_outliers(pkg):
    n_out = 40
    p1, p2, *_ = _two_view_scene(n=200, outliers=n_out)
    f, mask = _ransac(PACKAGES[pkg], p1, p2, threshold=1.0,
                      num_hypotheses=512, seed=0)
    assert mask[-n_out:].sum() <= 2 or mask[:160].mean() > 0.9
    assert mask.sum() >= 120


@pytest.mark.parametrize("pkg", PACKAGES)
def test_triangulate_rays_recovers_points(pkg):
    cv = PACKAGES[pkg]
    p1, p2, k, r, t = _two_view_scene(n=50)
    rng = np.random.RandomState(3)
    pts = rng.uniform(-1, 1, (50, 3))
    pts[:, 2] = rng.uniform(3, 6, 50)
    w2c_2 = np.eye(4)
    w2c_2[:3, :3] = r
    w2c_2[:3, 3] = t
    o1, d1 = cv.pixel_rays(p1, k, np.eye(4))
    o2, d2 = cv.pixel_rays(p2, k, np.linalg.inv(w2c_2))
    np.testing.assert_allclose(cv.triangulate_rays_midpoint(o1, d1, o2, d2),
                               pts, atol=1e-6)


# ------------------------------------------------------------------ parity

def test_numpy_functions_agree_exactly():
    rng = np.random.RandomState(4)
    src3, dst3 = rng.uniform(0, 100, (3, 2)), rng.uniform(0, 100, (3, 2))
    src4 = np.array([[0.0, 0], [255, 0], [255, 255], [0, 255]])
    dst4 = src4 + rng.uniform(-50, 50, (4, 2))
    pts = rng.uniform(0, 255, (64, 2))
    for name, args in [("affine_from_3pts", (src3, dst3)),
                       ("homography_from_4pts", (src4, dst4))]:
        np.testing.assert_array_equal(getattr(port_cv, name)(*args),
                                      getattr(jax_cv, name)(*args))
    h = jax_cv.homography_from_4pts(src4, dst4)
    np.testing.assert_array_equal(port_cv.apply_homography(h, pts),
                                  jax_cv.apply_homography(h, pts))
    k = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, 3] = rng.uniform(-1, 1, 3)
    for a, b in zip(port_cv.pixel_rays(pts, k, c2w),
                    jax_cv.pixel_rays(pts, k, c2w)):
        np.testing.assert_array_equal(a, b)
    rays = [rng.uniform(-1, 1, (16, 3)) for _ in range(4)]
    np.testing.assert_array_equal(port_cv.triangulate_rays_midpoint(*rays),
                                  jax_cv.triangulate_rays_midpoint(*rays))


def test_gather_bilinear_matches_jax():
    """The sampling rule at the same coordinates, some outside the image,
    on a noise image in [0, 255]."""
    from cotr_tpu.ops.sampling import _gather_bilinear

    rng = np.random.RandomState(5)
    img = rng.uniform(0, 255, (60, 70, 3)).astype(np.float32)
    x = rng.uniform(-3, 73, (40, 50)).astype(np.float32)
    y = rng.uniform(-3, 63, (40, 50)).astype(np.float32)
    want = np.asarray(_gather_bilinear(img, x, y, zero_outside=True))
    got = port_cv._gather_bilinear_zero_outside(
        torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y))
    assert (want == 0).any()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def _warp_case(seed, outward):
    """A smooth image and a perspective warp. With ``outward`` the corners
    move out of the image, so every output pixel of a smaller grid samples
    inside it; without, they move either way by up to 15 px."""
    from tests.test_torch_common import smooth_image

    rng = np.random.RandomState(seed)
    img = smooth_image(rng, (60, 70)).astype(np.float32)
    src = np.array([[0.0, 0], [69, 0], [69, 59], [0, 59]])
    if outward:
        away = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]])
        dst = src + away * rng.uniform(1, 6, (4, 2))
    else:
        dst = src + rng.uniform(-15, 15, (4, 2))
    return img, jax_cv.homography_from_4pts(src, dst)


@pytest.mark.parametrize("seed", [5, 6])
def test_warp_perspective_matches_jax_inside(seed):
    """A perspective warp that samples inside the image everywhere."""
    img, h = _warp_case(seed, outward=True)
    out_hw = (52, 60)
    want = _warp(jax_cv, img, h, out_hw)
    got = _warp(port_cv, img, h, out_hw)
    assert got.shape == want.shape
    assert not (want == 0).any()
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("out_hw", [(64, 80), (96, 72)])
def test_warp_perspective_matches_jax_with_border(out_hw):
    """A warp whose output runs past the image's edges, where zero padding
    makes a step of a whole pixel value within one pixel. The packages'
    float32 coordinates there differ in their last bit (the JAX package's
    CPU dot rounds one column with fused multiply-adds, the others
    without), which that step turns into up to 2e-3 of a level: the same
    pixels are zero, and the values agree to 5e-3."""
    img, h = _warp_case(5, outward=False)
    want = _warp(jax_cv, img, h, out_hw)
    got = _warp(port_cv, img, h, out_hw)
    assert (want == 0).any()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_warp_perspective_keeps_tensors_on_their_device():
    img = torch.rand(8, 9, 2)
    out = port_cv.warp_perspective(img, np.eye(3), (8, 9))
    assert torch.is_tensor(out) and out.device == img.device
    torch.testing.assert_close(out, img, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [8, 60])
def test_eight_point_matches_jax(n):
    """In float64 on both sides: in float32 either solver is only good to
    1e-5..1e-4 against the float64 solution, and the two round
    differently."""
    import jax

    p1, p2, *_ = _two_view_scene(n=n, seed=6)
    with jax.enable_x64(True):
        want = np.asarray(jax_cv.eight_point(p1, p2))
    assert want.dtype == np.float64
    got = port_cv.eight_point(torch.from_numpy(p1),
                              torch.from_numpy(p2)).numpy()
    err = min(np.abs(got - want).max(), np.abs(got + want).max())
    assert err < 1e-5, err


def test_sampson_dist_matches_jax():
    p1, p2, *_ = _two_view_scene(n=40, outliers=10, seed=7)
    f = np.asarray(jax_cv.eight_point(p1[:30], p2[:30]))
    want = np.asarray(jax_cv._sampson_dist(f, p1.astype(np.float32),
                                           p2.astype(np.float32)))
    got = port_cv._sampson_dist(torch.tensor(f),
                                torch.tensor(p1, dtype=torch.float32),
                                torch.tensor(p2, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("refine", [True, False])
def test_ransac_inlier_mask_matches_jax(refine):
    n_out = 40
    p1, p2, *_ = _two_view_scene(n=200, outliers=n_out)
    _, want = jax_cv.find_fundamental_ransac(
        p1, p2, threshold=1.0, num_hypotheses=512, seed=0, refine=refine)
    f, got = port_cv.find_fundamental_ransac(
        p1, p2, threshold=1.0, num_hypotheses=512, seed=0, refine=refine,
        device="cpu")
    np.testing.assert_array_equal(got, want)
    assert f.shape == (3, 3) and abs(np.linalg.norm(f) - 1.0) < 1e-5


def test_ransac_needs_eight_pairs():
    p = np.zeros((7, 2))
    with pytest.raises(ValueError):
        port_cv.find_fundamental_ransac(p, p, device="cpu")
