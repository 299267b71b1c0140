"""The port's position embeddings, canvas and sampling ops vs the JAX
package (and PIL for the host field resize)."""

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from cotr_tpu.models import position as jpos
from cotr_tpu.ops import canvas as jcanvas
from cotr_tpu.ops import sampling as jsamp
from cotr_tpu_torch.models import position
from cotr_tpu_torch.ops import canvas, sampling


@pytest.mark.parametrize("sine_type", ["lin_sine", "exp_sine"])
def test_position_embeddings_match_jax(sine_type):
    rng = np.random.RandomState(0)
    coords = rng.uniform(0, 1, (3, 7, 2)).astype(np.float32)
    want = np.asarray(jpos.nerf_positional_encoding(
        jnp.asarray(coords), 16, sine_type))
    got = position.nerf_positional_encoding(torch.from_numpy(coords), 16,
                                            sine_type).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(
        position.image_position_embedding(16, 32, 64, sine_type),
        jpos.image_position_embedding(16, 32, 64, sine_type), atol=1e-6)


def test_normalize_canvas_matches_jax():
    rng = np.random.RandomState(1)
    a = rng.randint(0, 255, (8, 9, 3), np.uint8)
    b = rng.randint(0, 255, (8, 9, 3), np.uint8)
    want = np.asarray(jcanvas.normalize_canvas(
        jcanvas.two_images_side_by_side(jnp.asarray(a), jnp.asarray(b))))
    got = canvas.normalize_canvas(canvas.two_images_side_by_side(
        torch.from_numpy(a), torch.from_numpy(b))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# the dense pass's canvas halves: downscales of 300x420 and 768 patches,
# the identity at 256, upscales of small patches
@pytest.mark.parametrize("in_hw", [(300, 420), (768, 768), (1024, 1024),
                                   (256, 256), (200, 200), (100, 137)])
def test_resize_bilinear_matches_jax(in_hw):
    img = np.random.RandomState(2).rand(*in_hw, 3).astype(np.float32)
    want = np.asarray(jsamp.resize_bilinear(jnp.asarray(img), (256, 256)))
    got = sampling.resize_bilinear(torch.from_numpy(img), (256, 256))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_crop_and_resize_matmul_matches_jax():
    rng = np.random.RandomState(3)
    img = rng.rand(300, 400, 3).astype(np.float32)
    boxes = np.array([[0, 0, 100, 100], [50, 20, 200, 200], [10, 10, 40, 40],
                      [100, 50, 300, 250], [390, 290, 10, 10]], np.float32)
    want = np.asarray(jsamp.crop_and_resize_matmul(
        jnp.asarray(img), jnp.asarray(boxes), 256))
    got = sampling.crop_and_resize_matmul(torch.from_numpy(img),
                                          torch.from_numpy(boxes), 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_grid_sample_matches_jax():
    rng = np.random.RandomState(4)
    img = rng.rand(30, 40, 2).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (5, 7, 2)).astype(np.float32)
    want = np.asarray(jsamp.grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    got = sampling.grid_sample(torch.from_numpy(img), torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # batched form: each image sampled through its own grid
    both = sampling.grid_sample(torch.from_numpy(np.stack([img, img[::-1]])),
                                torch.from_numpy(np.stack([grid, grid])))
    np.testing.assert_allclose(both[0].numpy(), want, atol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((256, 256), (768, 768)),
                                          ((64, 128), (300, 200)),
                                          ((256, 256), (200, 200)),
                                          ((64, 64), (200, 300))])
def test_field_resize_matches_pil(in_hw, out_hw):
    """The PIL-free host resize vs PIL 'F' mode BILINEAR."""
    rng = np.random.RandomState(5)
    field = rng.randn(*in_hw).astype(np.float32)
    want = np.array(PIL.Image.fromarray(field).resize(
        out_hw[::-1], resample=PIL.Image.BILINEAR))
    got = sampling.resize_pil_host(field, out_hw)
    assert got.dtype == np.float32 and got.shape == out_hw
    np.testing.assert_allclose(got, want, atol=1e-4)
    # per-channel on an (H, W, C) field
    stack = np.stack([field, -field], axis=-1)
    np.testing.assert_allclose(sampling.resize_pil_host(stack, out_hw)[..., 1],
                               -want, atol=1e-4)


def test_uint8_resize_within_one_level_of_pil():
    img = np.random.RandomState(6).randint(0, 255, (200, 300, 3), np.uint8)
    want = np.array(PIL.Image.fromarray(img).resize((300, 300),
                                                    PIL.Image.BILINEAR))
    got = sampling.resize_pil_host(img, (300, 300))
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
