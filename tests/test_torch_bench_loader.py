"""The loader bench's twin (cotr_tpu_torch/tools/bench_loader.py) against
tools/bench_loader.py.

* ``generate_scene`` with JPEG images and .h5 depths writes the JAX tool's
  files, file for file, on a 6-capture 48 x 64 scene: images, depths, the
  three COLMAP text files, the split files and ``dist_mat.npy``.
* Its default files (``.npy`` images, COLMAP ``.bin`` depths beside them)
  hold the same scene: the same depths, text files but for the names, and
  the same overlap matrix.
* ``main`` drives the dataset through ``PrefetchLoader`` in both layouts
  and reports the JAX tool's keys (the TPU step rate aside), with batches
  of the JAX tool's keys."""

import io
import json
import os
import sys

import numpy as np
import PIL.Image
import pytest

from cotr_tpu_torch.data.colmap import ColmapWithDepthAsciiReader
from cotr_tpu_torch.tools import bench_loader

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    sys.path.insert(0, _ROOT)
    try:
        from tools import bench_loader as jax_bench_loader
    finally:
        sys.path.remove(_ROOT)
    return jax_bench_loader


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            out[os.path.relpath(path, root)] = path
    return out


def test_generate_scene_jpg_h5_equals_the_jax_tools_files(tmp_path):
    import h5py

    _jax_tool().generate_scene(str(tmp_path / "jax"), 6, 48, 64, seed=3)
    bench_loader.generate_scene(str(tmp_path / "port"), 6, 48, 64, seed=3,
                                image_format="jpg", depth_format="h5")
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len(want) == 6 + 6 + 3 + 3 + 1
    for rel, path in want.items():
        if rel.endswith(".h5"):
            with h5py.File(path) as a, h5py.File(got[rel]) as b:
                assert list(a) == list(b) == ["depth"]
                np.testing.assert_array_equal(a["depth"][()],
                                              b["depth"][()])
                assert a["depth"].dtype == b["depth"].dtype
        else:
            with open(path, "rb") as a, open(got[rel], "rb") as b:
                assert a.read() == b.read(), rel


def test_default_files_hold_the_same_scene(tmp_path):
    bench_loader.generate_scene(str(tmp_path / "jpg"), 6, 48, 64, seed=3,
                                image_format="jpg", depth_format="h5")
    bench_loader.generate_scene(str(tmp_path / "npy"), 6, 48, 64, seed=3)
    jpg, npy = _files(tmp_path / "jpg"), _files(tmp_path / "npy")
    assert sum(r.endswith(".npy.geometric.bin") for r in npy) == 6
    for rel in ("0001/dense/sparse/images.txt",
                "0001/dense/sparse/cameras.txt",
                "0001/dense/sparse/points3D.txt", "train.json"):
        with open(jpg[rel]) as a, open(npy[rel]) as b:
            assert a.read().replace(".jpg", ".npy") == b.read()
    np.testing.assert_array_equal(
        np.load(jpg["0001/dense/dist_mat/dist_mat.npy"]),
        np.load(npy["0001/dense/dist_mat/dist_mat.npy"]))
    scenes = {}
    for name in ("jpg", "npy"):
        dense = tmp_path / name / "0001" / "dense"
        depth_dir = dense / ("depths" if name == "jpg" else "imgs")
        scenes[name] = ColmapWithDepthAsciiReader.read_sfm_scene(
            str(dense / "sparse"), str(dense / "imgs"), str(depth_dir),
            "no_crop")
    for a, b in zip(scenes["jpg"], scenes["npy"]):
        np.testing.assert_array_equal(a.depth_map, b.depth_map)
        # the .npy image is the one the JPEG file encodes
        buf = io.BytesIO()
        PIL.Image.fromarray(np.load(b.img_path)).save(buf, "JPEG",
                                                      quality=92)
        with open(a.img_path, "rb") as f:
            assert f.read() == buf.getvalue()


@pytest.mark.parametrize("device_synth", [False, True])
def test_main_reports_the_jax_tools_keys(tmp_path, capsys, monkeypatch,
                                         device_synth):
    argv = ["--captures", "9", "--height", "48", "--width", "64",
            "--batch_size", "2", "--batches", "3", "--workers", "2"]
    if device_synth:
        argv.append("--device_synth")
    monkeypatch.setattr(sys, "argv", ["bench_loader.py", *argv, "--root",
                                      str(tmp_path / "jax")])
    _jax_tool().main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = bench_loader.main(argv + ["--root", str(tmp_path / "port")])
    assert set(want) - set(got) == {"device_steps_per_s_stage1"}
    assert set(got) - set(want) == set()
    assert got["keys"] == want["keys"]
    assert got["batches_timed"] == 3 and got["samples_per_s"] > 0
    assert got["device_synth"] is device_synth
    rate = bench_loader.main(argv + ["--root", str(tmp_path / "port"),
                                     "--keep", "--device_steps_per_s", "3.1"])
    assert rate["device_steps_per_s"] == 3.1
