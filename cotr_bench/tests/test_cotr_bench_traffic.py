"""The seed chooses textures and homographies, never a size."""

import numpy as np
import pytest

from cotr_bench import pairs

TRAFFIC = {"angle_deg": 4.0, "scale": [0.95, 1.05], "shift_px": 20.0,
           "queries": 64, "margin": 8}
TRAIN = {"batch": 3, "num_kp": 10, "angle_deg": 12.0, "scale": [0.9, 1.12],
         "shift_px": 14.0}


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 40 + 3])
def test_pair_shapes_do_not_depend_on_the_seed(seed):
    p = pairs.make_pair(seed, 0, (48, 64), TRAFFIC, "cpu")
    assert p.img_a.shape == p.img_b.shape == (48, 64, 3)
    assert p.img_a.dtype == np.uint8
    assert p.queries.shape == (64, 2)
    assert ((p.queries >= 8) & (p.queries <= [56, 40])).all()
    # the homography stays within the traffic's ranges
    lin = p.hmat[:2, :2]
    scale = np.sqrt(abs(np.linalg.det(lin)))
    assert 0.95 <= scale <= 1.05
    angle = np.degrees(np.arctan2(lin[1, 0], lin[0, 0]))
    assert abs(angle) <= 4.0


def test_same_seed_same_inputs_other_seed_other_textures():
    a = pairs.make_pair(7, 1, (32, 40), TRAFFIC, "cpu")
    b = pairs.make_pair(7, 1, (32, 40), TRAFFIC, "cpu")
    c = pairs.make_pair(8, 1, (32, 40), TRAFFIC, "cpu")
    assert np.array_equal(a.img_a, b.img_a) and np.array_equal(a.img_b,
                                                               b.img_b)
    assert np.array_equal(a.queries, b.queries)
    assert not np.array_equal(a.img_a, c.img_a)


def test_truth_is_the_homography_image_of_the_queries():
    p = pairs.make_pair(3, 0, (40, 40), TRAFFIC, "cpu")
    assert np.allclose(p.truth, pairs.apply_h(p.hmat, p.queries))


def test_warp_matches_its_definition():
    """B(H x) = A(x): a bilinear sample of A at the inverse map of each B
    pixel centre, by numpy in float64."""
    rng = pairs.rng_for(1, 9)
    img = pairs.procedural_texture(rng, 24, 30)
    h = pairs.known_homography(24, 30, 3.0, 1.02, (1.5, -2.0))
    got = pairs.warp_homography(img, h).numpy()
    ys, xs = np.mgrid[0:24, 0:30].astype(np.float64)
    src = np.linalg.inv(h) @ np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5,
                                       np.ones(720)])
    sx = np.clip(src[0] / src[2] - 0.5, 0, 30 - 1.001)
    sy = np.clip(src[1] / src[2] - 0.5, 0, 24 - 1.001)
    x0, y0 = sx.astype(int), sy.astype(int)
    fx, fy = (sx - x0)[:, None], (sy - y0)[:, None]
    f = img.numpy().astype(np.float64)
    top = f[y0, x0] * (1 - fx) + f[y0, x0 + 1] * fx
    bot = f[y0 + 1, x0] * (1 - fx) + f[y0 + 1, x0 + 1] * fx
    want = np.round((top * (1 - fy) + bot * fy).reshape(24, 30, 3))
    assert np.array_equal(got, want.astype(np.uint8))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 77])
def test_train_batches_have_one_shape(seed):
    b = pairs.make_train_batch(seed, 0, TRAIN, "cpu")
    assert b["crop"].shape == (3, 256, 256, 3)
    assert b["h_mat"].shape == (3, 3, 3)
    assert b["queries"].shape == b["targets"].shape == (3, 20, 2)
    q = b["queries"].numpy()
    assert ((q >= 0) & (q <= 1)).all()


def test_pool_pairs_differ():
    a = pairs.make_pair(5, 0, (32, 32), TRAFFIC, "cpu")
    b = pairs.make_pair(5, 1, (32, 32), TRAFFIC, "cpu")
    assert not np.array_equal(a.img_a, b.img_a)
