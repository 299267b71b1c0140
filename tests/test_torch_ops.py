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


# ------------------------------------------------------- the windowed crops

#: float32 on [0, 1] images: the windowed product sums fewer terms in
#: another order; bfloat16 rounds operands and both results to bf16
_CROP_TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _windowed_case():
    rng = np.random.RandomState(8)
    img = rng.rand(300, 400, 3).astype(np.float32)
    boxes = np.array([[0, 0, 96, 96], [50, 20, 96, 96], [304, 204, 96, 96],
                      [117, 93, 96, 96]], np.float32)
    return img, boxes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crop_and_resize_windowed_matches_jax(dtype):
    img, boxes = _windowed_case()
    want = np.asarray(jsamp.crop_and_resize_windowed(
        jnp.asarray(img), jnp.asarray(boxes), 256, 96,
        compute_dtype=getattr(jnp, dtype)))
    got = sampling.crop_and_resize_windowed(
        torch.from_numpy(img), boxes, 256, 96,
        compute_dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == (4, 256, 256, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=_CROP_TOL[dtype])
    # and against the port's own full-image crop
    full = sampling.crop_and_resize_matmul(
        torch.from_numpy(img), torch.from_numpy(boxes), 256,
        compute_dtype=getattr(torch, dtype))
    np.testing.assert_allclose(got.numpy(), full.numpy(),
                               atol=_CROP_TOL[dtype])


def _indexed_case():
    rng = np.random.RandomState(9)
    imgs = rng.rand(3, 256, 320, 3).astype(np.float32)
    # sizes differ by box; the last two sit at the far edges, where the
    # window is moved back inside the image
    boxes = np.array([[0, 0, 64, 64], [40, 30, 100, 100], [200, 130, 120, 120],
                      [192, 128, 128, 128], [310, 246, 10, 10]], np.float32)
    idx = np.array([0, 2, 1, 2, 0], np.int32)
    return imgs, boxes, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crop_and_resize_window_indexed_matches_jax(dtype):
    imgs, boxes, idx = _indexed_case()
    want = np.asarray(jsamp.crop_and_resize_window_indexed(
        jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(idx), 256, 128,
        compute_dtype=getattr(jnp, dtype)))
    got = sampling.crop_and_resize_window_indexed(
        torch.from_numpy(imgs), boxes, idx, 256, 128,
        compute_dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == (5, 256, 256, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=_CROP_TOL[dtype])
    for g in range(len(boxes)):
        full = sampling.crop_and_resize_matmul(
            torch.from_numpy(imgs[idx[g]]), torch.from_numpy(boxes[g:g + 1]),
            256, compute_dtype=getattr(torch, dtype))
        np.testing.assert_allclose(got[g].numpy(), full[0].numpy(),
                                   atol=_CROP_TOL[dtype])


def test_windowed_crops_reject_misshapen_boxes():
    img, boxes = _windowed_case()
    with pytest.raises(ValueError):
        sampling.crop_and_resize_windowed(torch.from_numpy(img), boxes[0],
                                          64, 96)
    with pytest.raises(ValueError):
        sampling.crop_and_resize_window_indexed(
            torch.from_numpy(img)[None], boxes, np.zeros(3, np.int32), 64,
            128)


@pytest.mark.parametrize("box", [[-1, 0, 96, 96], [0, -2, 96, 96],
                                 [305, 0, 96, 96], [0, 205, 96, 96],
                                 [0, 0, 64, 64]])
def test_windowed_crop_raises_outside_the_image(box):
    """``dynamic_slice`` would move such a window back inside silently (and
    a box of another size would be read at the wrong scale)."""
    img, _ = _windowed_case()
    with pytest.raises(ValueError):
        sampling.crop_and_resize_windowed(
            torch.from_numpy(img), np.array([box], np.float32), 256, 96)


@pytest.mark.parametrize("box,idx,window", [
    ([-1, 0, 64, 64], 0, 128), ([300, 0, 64, 64], 0, 128),
    ([0, 200, 64, 64], 0, 128), ([0, 0, 130, 130], 0, 128),
    ([0, 0, 64, 64], 3, 128), ([0, 0, 64, 64], -1, 128),
    ([0, 0, 64, 64], 0, 320)])
def test_indexed_crop_raises_outside_the_stack(box, idx, window):
    imgs, _, _ = _indexed_case()
    with pytest.raises(ValueError):
        sampling.crop_and_resize_window_indexed(
            torch.from_numpy(imgs), np.array([box], np.float32),
            np.array([idx], np.int32), 256, window)
