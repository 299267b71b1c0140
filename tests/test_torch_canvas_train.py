"""The device-side warp and the training canvas of the port against
cotr_tpu/ops/canvas.py on the CPU, on seeded smooth crops and homographies.

Tolerance 1e-4 absolute: the port inverts each homography by the adjugate in
float64 where JAX inverts in float32, which moves a sampling position by
about 1e-5 px; on [0, 1] crops whose neighbouring pixels differ by a few
hundredths that is under 1e-6, and 1e-4 on the normalized canvas (a division
by a std of 0.22). The bilinear sample is continuous across a cell boundary,
so a floor that flips there changes nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cotr_tpu.ops import canvas as jax_canvas
from cotr_tpu_torch.ops import canvas as port_canvas

from tests.test_torch_common import smooth_image

ATOL = 1e-4


def _homographies(rng, n):
    out = []
    for _ in range(n):
        a = np.deg2rad(rng.uniform(-25, 25))
        s = rng.uniform(0.8, 1.25)
        h = np.array([[s * np.cos(a), -s * np.sin(a), rng.uniform(-30, 30)],
                      [s * np.sin(a), s * np.cos(a), rng.uniform(-30, 30)],
                      [rng.uniform(-2e-4, 2e-4), rng.uniform(-2e-4, 2e-4), 1]])
        out.append(h)
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(21)
    crops = np.stack([smooth_image(rng, (256, 256)) for _ in range(3)])
    h_mats = _homographies(rng, 3)
    h_mats[0] = np.eye(3)
    photo = np.concatenate([rng.uniform(0.7, 1.3, (3, 2, 3)),
                            rng.uniform(-0.1, 0.1, (3, 2, 1))],
                           axis=-1).astype(np.float32)
    return crops, h_mats, photo


def _report(got, want):
    diff = np.abs(got - want)
    bad = np.argwhere(diff > ATOL)
    return (f"{len(bad)} pixels differ by more than {ATOL}, the first at "
            f"(b, y, x, c) = {bad[:5].tolist()}, max {diff.max():.3e}")


def test_warp_homography_batch_matches_jax(inputs):
    crops, h_mats, _ = inputs
    images = crops.astype(np.float32) / 255.0
    want = np.asarray(jax_canvas.warp_homography_batch(
        jnp.asarray(images), jnp.asarray(h_mats)))
    got = port_canvas.warp_homography_batch(
        torch.from_numpy(images), torch.from_numpy(h_mats)).numpy()
    assert got.shape == want.shape == (3, 256, 256, 3)
    assert np.abs(got - want).max() <= ATOL, _report(got, want)
    # the identity homography returns the image
    np.testing.assert_allclose(got[0], images[0], atol=1e-6, rtol=0)


@pytest.mark.parametrize("with_photo", [False, True])
def test_canvas_from_crops_and_homographies_matches_jax(inputs, with_photo):
    crops, h_mats, photo = inputs
    want = np.asarray(jax_canvas.canvas_from_crops_and_homographies(
        jnp.asarray(crops), jnp.asarray(h_mats),
        jnp.asarray(photo) if with_photo else None))
    got = port_canvas.canvas_from_crops_and_homographies(
        torch.from_numpy(crops), torch.from_numpy(h_mats),
        torch.from_numpy(photo) if with_photo else None).numpy()
    assert got.shape == want.shape == (3, 256, 512, 3)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= ATOL, _report(got, want)


def test_inverse_by_the_adjugate(inputs):
    _, h_mats, _ = inputs
    inv = port_canvas._inverse_3x3(torch.from_numpy(h_mats)).numpy()
    np.testing.assert_allclose(inv, np.linalg.inv(h_mats.astype(np.float64)),
                               rtol=1e-6, atol=1e-9)


def test_denormalize_and_make_canvas_batch_match_jax(inputs):
    crops, _, _ = inputs
    a, b = crops[:2], crops[1:]
    want = jax_canvas.make_canvas_batch(a, b)
    got = port_canvas.make_canvas_batch(torch.from_numpy(a),
                                        torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        port_canvas.denormalize_canvas(got).numpy(),
        jax_canvas.denormalize_canvas(want), atol=1e-6, rtol=0)
    side = port_canvas.two_images_side_by_side(torch.from_numpy(a[0]),
                                               torch.from_numpy(b[0]))
    np.testing.assert_array_equal(
        side.numpy(), jax_canvas.two_images_side_by_side(a[0], b[0]))
