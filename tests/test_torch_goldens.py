"""The golden and side-by-side twins (cotr_tpu_torch/tools/
{make_demo_goldens,make_side_by_side}.py) and the PNG reader they share
(cotr_tpu_torch/demos/demo_utils.read_png), against PIL and the JAX tools.

* ``read_png`` equals PIL's decode of every committed demo golden and
  side-by-side picture, and of PNG files written here with every row
  filter (None, Sub, Up, Average, Paeth) in each 8-bit colour type.
* The side-by-side composite equals the JAX tool's outside the label bar
  (the JAX tool draws the label there with PIL; the twin keeps the bar
  plain and writes the label into ``tEXt`` chunks).
* ``compare_to_golden`` (the rule of tests/test_demo_goldens.py) at both
  sides of each of its thresholds.
* ``make_demo_goldens`` runs a demo twin on the CPU with the arguments
  after ``--`` and writes what the demo writes when called directly."""

import os
import shutil
import struct
import sys
import zlib

import numpy as np
import PIL.Image
import pytest

from cotr_tpu_torch.demos import demo_wbs
from cotr_tpu_torch.demos.demo_utils import (read_png, read_png_chunks,
                                             write_png)
from cotr_tpu_torch.tools import make_demo_goldens, make_side_by_side
from tests.test_torch_common import smooth_image

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(_ROOT, "tests", "golden", "demos")
SIDE_BY_SIDE_DIR = os.path.join(_ROOT, "docs", "side_by_side")
COMMITTED = sorted(
    os.path.join(d, f) for d in (GOLDEN_DIR, SIDE_BY_SIDE_DIR)
    for f in os.listdir(d) if f.endswith(".png"))


@pytest.mark.parametrize("path", COMMITTED,
                         ids=[os.path.relpath(p, _ROOT) for p in COMMITTED])
def test_read_png_equals_pil_on_committed_pictures(path):
    np.testing.assert_array_equal(read_png(path),
                                  np.asarray(PIL.Image.open(path)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_filtered_png(path, img, color):
    """An 8-bit PNG whose row r uses filter r % 5."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp).astype(np.int32)
    out = []
    for r in range(h):
        x = rows[r]
        b = rows[r - 1] if r else np.zeros_like(x)
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][r % 5]
        out.append(bytes([r % 5]) + ((x - pred) & 255).astype(
            np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(out))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("color,channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_read_png_undoes_every_row_filter(tmp_path, color, channels):
    rng = np.random.RandomState(color)
    img = rng.randint(0, 256, (23, 17, channels)).astype(np.uint8)
    img[5:12] = smooth_image(rng, (7, 17))[..., :1]  # runs and gradients
    if channels == 1:
        img = img[..., 0]
    path = str(tmp_path / "filtered.png")
    _write_filtered_png(path, img, color)
    got = read_png(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, np.asarray(PIL.Image.open(path)))


def test_write_png_text_chunks_round_trip(tmp_path):
    img = smooth_image(np.random.RandomState(1), (9, 11))
    path = str(tmp_path / "t.png")
    write_png(path, img, text={"Label left": "a - b"})
    np.testing.assert_array_equal(read_png(path), img)
    assert (b"tEXt", b"Label left\0a - b") in read_png_chunks(path)
    assert PIL.Image.open(path).text == {"Label left": "a - b"}


def _jax_side_by_side():
    sys.path.insert(0, _ROOT)
    try:
        from tools import make_side_by_side as jax_tool
    finally:
        sys.path.remove(_ROOT)
    return jax_tool


def test_side_by_side_equals_the_jax_tools_outside_the_bar(tmp_path,
                                                          monkeypatch):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    ours.mkdir()
    ref.mkdir()
    shutil.copy(os.path.join(GOLDEN_DIR, "demo_single_pair.png"), ours)
    shutil.copy(os.path.join(GOLDEN_DIR, "demo_face.png"), ours)
    shutil.copy(os.path.join(GOLDEN_DIR, "demo_wbs.png"),
                ref / "sparse_output.png")
    grey = smooth_image(np.random.RandomState(2), (300, 500))[..., 0]
    PIL.Image.fromarray(grey).save(ref / "face_output.png")
    jax_tool = _jax_side_by_side()
    monkeypatch.setattr(jax_tool, "OURS", str(ours))
    monkeypatch.setattr(jax_tool, "REF", str(ref))
    monkeypatch.setattr(jax_tool, "OUT", str(tmp_path / "jax"))
    jax_tool.main()
    made = make_side_by_side.main(["--ours", str(ours), "--ref", str(ref),
                                   "--out", str(tmp_path / "port")])
    assert [os.path.basename(p) for p in made] == ["demo_single_pair.png",
                                                   "demo_face.png"]
    for path in made:
        want = np.asarray(PIL.Image.open(
            tmp_path / "jax" / os.path.basename(path)))
        got = read_png(path)
        assert got.shape == want.shape == (382, got.shape[1], 3)
        np.testing.assert_array_equal(got[22:], want[22:])
        gap = np.all(got == 255, axis=(0, 2))
        assert gap.sum() >= 8
        assert (got[:22][:, ~gap] == 24).all()
        title = os.path.basename(path)[:-len(".png")]
        labels = [d for k, d in read_png_chunks(path) if k == b"tEXt"]
        assert labels == [
            f"Label left\0{title} - ours (from-scratch flagship)".encode(),
            f"Label right\0{title} - reference (released checkpoint)"
            .encode()]


def test_compare_to_golden_thresholds():
    want = np.zeros((100, 100, 3), np.uint8)

    def with_off(n_off, level=41, base=0):
        got = np.full_like(want, base)
        got.reshape(-1, 3)[:n_off] = level
        return make_demo_goldens.compare_to_golden(got, want)

    # share of pixels off by more than 40: 199 of 10,000 passes, 200 not
    assert with_off(199)["ok"] and not with_off(200)["ok"]
    # a channel at exactly 40 is not off
    assert with_off(10_000, level=40)["frac_off"] == 0.0
    # mean deviation: 2.97 passes, 3.0 does not
    assert make_demo_goldens.compare_to_golden(
        np.full_like(want, 3) * (np.arange(100)[:, None, None] > 0), want
    )["ok"]
    assert not with_off(0, base=3)["ok"]
    assert with_off(0, base=3)["mean_dev"] == 3.0
    # other shapes fail; RGBA and grey compare as RGB
    assert not make_demo_goldens.compare_to_golden(want[:50], want)["ok"]
    rgba = np.concatenate([want, np.full((100, 100, 1), 7, np.uint8)], -1)
    assert make_demo_goldens.compare_to_golden(rgba, want[..., 0])["ok"]


def test_make_demo_goldens_runs_a_demo_with_passthrough_args(tmp_path,
                                                             monkeypatch):
    rng = np.random.RandomState(3)
    img = smooth_image(rng, (64, 64))
    np.save(tmp_path / "a.npy", img)
    np.save(tmp_path / "b.npy", img)
    np.savetxt(tmp_path / "pts.txt", [[20, 20, 20, 20], [40, 30, 40, 30],
                                      [30, 44, 30, 44]])
    demo_args = ["--img_a", "a.npy", "--img_b", "b.npy", "--pts", "pts.txt"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    written = make_demo_goldens.main(
        ["--weights", "none", "--dtype", "float32", "--only", "demo_wbs",
         "--out_dir", "goldens", "--", *demo_args], device="cpu")
    assert written == [str(tmp_path / "goldens" / "demo_wbs.png")]
    demo_wbs.main(demo_args + ["--load_weights_path", "none", "--dtype",
                               "float32", "--out", "direct.png"],
                  device="cpu")
    verdict = make_demo_goldens.compare_to_golden(read_png(written[0]),
                                                  read_png("direct.png"))
    assert verdict["ok"], verdict
    default = make_demo_goldens.parse_args(["--weights", "w"])[0].out_dir
    assert default.endswith(os.path.join("tests", "golden", "torch_demos"))
