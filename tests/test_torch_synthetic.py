"""The port's synthetic homography dataset against the JAX package's, and
the content tests of tests/test_synthetic.py on the port.

The textures are written to a temporary directory as PNG (read by both
packages through PIL) and as ``.npy`` (the port's PIL-free format). The
same (seed, index) draws the same random stream in both packages, and the
port's bilinear resize (``resize_pil_host``) is PIL's in integers, so every
array of a sample is equal bit for bit, pixels included."""

import os

import numpy as np
import PIL.Image
import pytest
import torch
from scipy.ndimage import map_coordinates

from cotr_tpu.data.synthetic import SyntheticHomographyDataset as JaxDataset
from cotr_tpu.data.synthetic import \
    make_procedural_texture as jax_procedural_texture
from cotr_tpu_torch.data import synthetic
from cotr_tpu_torch.data.dataset import normalize_canvas
from cotr_tpu_torch.data.synthetic import (SyntheticHomographyDataset,
                                           make_procedural_texture)
from cotr_tpu_torch.ops.canvas import canvas_from_crops_and_homographies
from cotr_tpu_torch.ops.sampling import resize_pil_host, resize_pil_u8_host
from cotr_tpu_torch.utils.constants import MAX_SIZE

#: the texture sizes: one square, two not, all with sides of 256 or more
_SIZES = [(512, 512), (300, 420), (640, 560)]


@pytest.fixture(scope="module")
def textures(tmp_path_factory):
    """{"png": [...], "npy": [...]}: the same three procedural textures."""
    root = tmp_path_factory.mktemp("textures")
    rng = np.random.RandomState(11)
    out = {"png": [], "npy": []}
    for i, (h, w) in enumerate(_SIZES):
        tex = jax_procedural_texture(rng, max(h, w))[:h, :w]
        png, npy = root / f"tex{i}.png", root / f"tex{i}.npy"
        PIL.Image.fromarray(tex).save(png)
        np.save(npy, tex)
        out["png"].append(str(png))
        out["npy"].append(str(npy))
    return out


def _port(textures, **kw):
    return SyntheticHomographyDataset(textures["npy"], **kw)


# ------------------------------------------------------------------ parity

#: every option of the dataset, in the settings the tools use and beyond
SETTINGS = {
    "image layout": dict(),
    "device_warp": dict(device_warp=True),
    "train twin": dict(device_warp=True, proc_textures=3, tex_aug=True),
    "zoom, rot, scale, photo": dict(zoom=True, zoom_prob=0.6, rot_deg=20.0,
                                    scale_range=(0.8, 1.25),
                                    photo_jitter=0.3),
    "zoom, photo, device_warp, one way": dict(
        zoom=True, photo_jitter=0.2, device_warp=True, bidirectional=False),
    "normalized, small crops": dict(raw_uint8=False, max_crop_side=300,
                                    max_corner_jitter=0.1, tex_aug=True),
}


@pytest.mark.parametrize("name", SETTINGS)
@pytest.mark.parametrize("reader", ["png", "npy"])
def test_samples_match_jax(textures, name, reader):
    kw = dict(length=64, num_kp=40, seed=3, **SETTINGS[name])
    jax_ds = JaxDataset(textures["png"], **kw)
    port_ds = SyntheticHomographyDataset(textures[reader], **kw)
    assert len(port_ds.images) == len(jax_ds.images)
    for got, want in zip(port_ds.images, jax_ds.images):
        np.testing.assert_array_equal(got, want, err_msg="texture")
    for index in (0, 1, 2, 5, 13, 21, 34, 63):
        want, got = jax_ds[index], port_ds[index]
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype and \
                got[key].shape == value.shape, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("seed,size", [(0, 512), (3, 256), (8, 300)])
def test_procedural_textures_match_jax(seed, size):
    got = make_procedural_texture(np.random.RandomState(seed), size)
    want = jax_procedural_texture(np.random.RandomState(seed), size)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_hw,out_hw", [((384, 384), (256, 256)),
                                          ((513, 300), (256, 256)),
                                          ((4, 4), (512, 512)),
                                          ((37, 90), (256, 71)),
                                          ((256, 256), (256, 256))])
def test_resize_pil_u8_equals_pil(in_hw, out_hw):
    """The banded resize is PIL's function: equal to PIL, and it is what
    resize_pil_host does to a uint8 image."""
    rng = np.random.RandomState(in_hw[0])
    img = rng.randint(0, 256, in_hw + (3,)).astype(np.uint8)
    want = np.asarray(PIL.Image.fromarray(img).resize(
        out_hw[::-1], PIL.Image.BILINEAR))
    got = resize_pil_u8_host(img, out_hw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(resize_pil_host(img, out_hw), want)
    plane = resize_pil_u8_host(img[..., 0], out_hw)
    np.testing.assert_array_equal(plane, got[..., 0])


def test_resize_pil_u8_takes_uint8_only():
    with pytest.raises(ValueError):
        resize_pil_u8_host(np.zeros((8, 8, 3), np.float32), (4, 4))


def test_npy_textures_are_checked(tmp_path):
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((300, 300, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        SyntheticHomographyDataset([str(bad)])
    small = tmp_path / "small.npy"
    np.save(small, np.zeros((200, 300, 3), np.uint8))
    with pytest.raises(ValueError, match="usable"):
        SyntheticHomographyDataset([str(small)])


# ------------------------------------------- tests/test_synthetic.py's cases

def _content_agreement(sample) -> np.ndarray:
    """|A(p) - B(H p)| of the grey canvas halves at every correspondence."""
    img = sample["image"]
    corrs = sample["corrs"] * np.array([512, 256, 512, 256])
    a_gray = img[:, :256].mean(-1)
    b_gray = img[:, 256:].mean(-1)
    va = map_coordinates(a_gray, [corrs[:, 1], corrs[:, 0]], order=1)
    vb = map_coordinates(b_gray, [corrs[:, 3], corrs[:, 2] - 256], order=1)
    return np.abs(va - vb)


def test_sample_shapes_and_ranges(textures):
    s = _port(textures, length=4, num_kp=25, seed=0)[1]
    assert s["image"].shape == (MAX_SIZE, 2 * MAX_SIZE, 3)
    assert s["image"].dtype == np.uint8
    assert s["queries"].shape == (50, 2)
    assert (s["queries"] >= 0).all() and (s["queries"] <= 1).all()
    assert (s["queries"][:25, 0] <= 0.5).all()
    assert (s["queries"][25:, 0] >= 0.5).all()


def test_deterministic_per_index(textures):
    ds = _port(textures, length=4, num_kp=10, seed=5)
    a, b = ds[2], ds[2]
    np.testing.assert_array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(a["queries"], b["queries"])


def test_correspondences_match_warp(textures):
    ds = _port(textures, length=4, num_kp=50, seed=2, max_corner_jitter=0.1,
               raw_uint8=False)
    assert (_content_agreement(ds[0]) < 0.35).mean() > 0.8


@pytest.mark.parametrize("photo_jitter,tol", [(0.0, 0.02), (0.3, 0.05)])
def test_device_warp_matches_host_warp(textures, photo_jitter, tol):
    """The crop layout warped by the port's device path gives the host
    path's canvas, with and without the photometric jitter."""
    kw = dict(length=8, num_kp=16, seed=7, photo_jitter=photo_jitter)
    host_ds = _port(textures, **kw)
    dev_ds = _port(textures, device_warp=True, **kw)
    for i in range(3):
        hs, dv = host_ds[i], dev_ds[i]
        np.testing.assert_allclose(hs["queries"], dv["queries"], atol=1e-6)
        np.testing.assert_allclose(hs["targets"], dv["targets"], atol=1e-6)
        photo = (torch.from_numpy(dv["photo"][None]) if photo_jitter
                 else None)
        canvas_dev = canvas_from_crops_and_homographies(
            torch.from_numpy(dv["crop"][None]),
            torch.from_numpy(dv["h_mat"][None]), photo)[0].numpy()
        canvas_host = normalize_canvas(hs["image"])
        err = np.abs(canvas_host - canvas_dev).max()
        assert err < tol, f"sample {i}: canvas mismatch {err}"


def test_zoom_mode_content_consistency(textures):
    kw = dict(length=24, num_kp=50, seed=2, max_corner_jitter=0.1,
              raw_uint8=False)
    ds, flat = _port(textures, zoom=True, **kw), _port(textures, **kw)
    changed = 0
    for idx in range(6):
        s = ds[idx]
        d = _content_agreement(s)
        assert np.median(d) < 0.2, (idx, np.median(d))
        assert (d < 0.35).mean() > 0.7, idx
        if not np.array_equal(s["image"], flat[idx]["image"]):
            changed += 1
    assert changed >= 4


def test_default_textures_exclude_eval_images(tmp_path, monkeypatch):
    """The default pool is the JAX package's glob without the held-out
    evaluation images."""
    rng = np.random.RandomState(4)
    names = ["a.jpg", "b.JPG", "c.png"] + list(
        SyntheticHomographyDataset.EVAL_TEXTURES)
    for name in names:
        PIL.Image.fromarray(rng.randint(0, 256, (260, 270, 3)).astype(
            np.uint8)).save(tmp_path / name)
    monkeypatch.setattr(synthetic, "SAMPLE_IMAGES_DIR", str(tmp_path))
    paths = synthetic.default_texture_paths()
    assert [os.path.basename(p) for p in paths] == ["a.jpg", "b.JPG"]
    assert len(SyntheticHomographyDataset(length=2).images) == 2
    monkeypatch.setattr(synthetic, "SAMPLE_IMAGES_DIR",
                        str(tmp_path / "absent"))
    with pytest.raises(ValueError, match="no texture"):
        SyntheticHomographyDataset(length=2)


def test_rot_scale_augmentation_content_consistency(textures):
    kw = dict(length=8, num_kp=50, seed=3, max_corner_jitter=0.05,
              raw_uint8=False)
    aug = _port(textures, rot_deg=20.0, scale_range=(0.8, 1.25), **kw)
    plain = _port(textures, **kw)
    changed = 0
    for idx in range(4):
        s = aug[idx]
        assert (_content_agreement(s) < 0.35).mean() > 0.75, idx
        if not np.array_equal(s["image"], plain[idx]["image"]):
            changed += 1
    assert changed >= 3


def test_procedural_textures_widen_pool_deterministically(textures):
    tex = make_procedural_texture(np.random.RandomState(3), size=256)
    assert tex.shape == (256, 256, 3) and tex.dtype == np.uint8
    assert np.abs(np.diff(tex.astype(np.float32), axis=0)).mean() > 1.0
    a = _port(textures, length=4, num_kp=16, seed=9, proc_textures=4)
    b = _port(textures, length=4, num_kp=16, seed=9, proc_textures=4)
    assert len(a.images) == len(b.images) == len(_SIZES) + 4
    for ia, ib in zip(a.images[-4:], b.images[-4:]):
        np.testing.assert_array_equal(ia, ib)
    assert a[0]["image"].shape == (MAX_SIZE, 2 * MAX_SIZE, 3)


def test_tex_aug_preserves_supervision_geometry(textures):
    kw = dict(length=6, num_kp=50, seed=2, max_corner_jitter=0.1,
              raw_uint8=False)
    ds = _port(textures, tex_aug=True, proc_textures=4, **kw)
    plain = _port(textures, **kw)
    changed = 0
    for i in range(4):
        s = ds[i]
        assert (_content_agreement(s) < 0.35).mean() > 0.8
        if not np.array_equal(s["image"], plain[i]["image"]):
            changed += 1
    assert changed >= 2


def test_procedural_textures_large_seed(textures):
    ds = _port(textures, length=2, num_kp=8, seed=777, proc_textures=2)
    assert ds[0]["image"].shape == (MAX_SIZE, 2 * MAX_SIZE, 3)
