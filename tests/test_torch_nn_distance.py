"""The kNN overlap matrix's twin (cotr_tpu_torch/tools/
prepare_nn_distance_mat.py) against scripts/prepare_nn_distance_mat.py.

* Its torch path (float64, here on the CPU) against the JAX script's
  ``distance_between_two_caps`` for every cell of a small generated scene,
  to the card's gate: equal on all cells but at most one, and within 1e-4
  on all of them (the sums of the 3 x 4 products run in other orders).
* A pair built so that about 60 points hit each pixel they reach, their
  depths on both sides of the threshold: the last point in order wins, as
  numpy's assignment keeps it, and the other order gives another answer.
* ``--cells`` resumes: two invocations give the matrix one gives, and the
  numpy path (``--device cpu``, a process pool) agrees with the torch path.
* A cell that fails raises, where the JAX script writes 0.0."""

import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cotr_tpu.data.colmap import ColmapWithDepthAsciiReader as JaxReader
from cotr_tpu.geometry import projector as jax_projector
from cotr_tpu_torch.data.colmap import ColmapWithDepthAsciiReader
from cotr_tpu_torch.geometry.projector import splat_reprojections
from cotr_tpu_torch.tools import prepare_nn_distance_mat as twin
from cotr_tpu_torch.tools.generated_scene import make_scene

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the card's gate: about 80 pixels of a 768 x 1024 union
CELL_TOL = 1e-4


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_nn_distance_mat",
        os.path.join(_ROOT, "scripts", "prepare_nn_distance_mat.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The reader's arguments for a generated scene of 6 views of 48 x 64
    (.png images and .h5 depths, which both packages read)."""
    root = tmp_path_factory.mktemp("nn_scene")
    path = make_scene(str(root), views=6, height=48, width=64, val_views=2,
                      seed=2, image_format="png", depth_format="h5")
    with open(path) as f:
        raw = json.load(f)
    sdd = raw["scenes_name_list"][0]
    return (sdd["scene_dir"], sdd["image_dir"], sdd["depth_dir"],
            raw["valid_list_json"], "no_crop")


def _off_diagonal(n):
    return [(i, j) for i in range(n) for j in range(n) if i != j]


def _assert_gate(got: dict, want: dict):
    exact = sum(got[c] == want[c] for c in want)
    worst = max(abs(got[c] - want[c]) for c in want)
    assert exact >= len(want) - 1 and worst <= CELL_TOL, (exact, worst)


def test_torch_path_matches_the_jax_script_on_every_cell(scene, monkeypatch):
    jax_caps = JaxReader.read_sfm_scene_given_valid_list_path(
        *scene).captures
    caps = ColmapWithDepthAsciiReader.read_sfm_scene_given_valid_list_path(
        *scene).captures
    assert len(caps) == len(jax_caps) == 6
    script = _jax_script()
    cells = _off_diagonal(len(caps))
    want = {(i, j): script.distance_between_two_caps(jax_caps[i],
                                                     jax_caps[j])
            for i, j in cells}
    # 5 targets a source: a block of 4 and one of 1
    monkeypatch.setattr(twin, "TARGET_BLOCK", 4)
    got = twin.torch_cells(caps, cells, "cpu")
    _assert_gate(got, want)
    assert max(want.values()) > 0.3 and min(want.values()) < max(
        want.values())
    numpy_port = {(i, j): twin.distance_between_two_caps(caps[i], caps[j])
                  for i, j in cells}
    assert numpy_port == want


def _stub_capture(depth, k, jax_side: bool):
    """A capture at the world origin looking down +z."""
    pose = np.eye(4)
    cap = SimpleNamespace(
        depth_map=depth,
        pinhole_cam=SimpleNamespace(shape=depth.shape, intrinsic_mat=k),
        cam_pose=SimpleNamespace(world_to_camera=pose,
                                 camera_to_world=pose))
    if jax_side:
        cap.point_cloud_world = jax_projector.img_2d_to_pcd_3d(
            depth, k, motion=pose)
    return cap


def test_duplicate_hits_keep_the_last_point():
    h, w = 32, 48
    # rows alternate between depths 50 and 300; the target sees 300
    # everywhere, so a pixel agrees only when its last point is at 300
    depth = np.where(np.arange(h)[:, None] % 2 == 0, 50.0, 300.0) \
        * np.ones((1, w))
    depth = depth.astype(np.float32)
    k_src = np.array([[40.0, 0, 24.3], [0, 40.0, 16.1], [0, 0, 1]])
    k_dst = np.array([[40.0 / 7.7, 0, 24.3], [0, 40.0 / 7.7, 16.1],
                      [0, 0, 1]])
    target = np.full((h, w), 300.0, np.float32)
    script = _jax_script()
    want = script.distance_between_two_caps(
        _stub_capture(target, k_dst, True), _stub_capture(depth, k_src, True))
    caps = [_stub_capture(target, k_dst, False),
            _stub_capture(depth, k_src, False)]
    got = twin.torch_cells(caps, [(0, 1)], "cpu")[(0, 1)]
    assert got == want and 0 < want < 1

    # the splat itself equals numpy's, and the other order differs
    points = torch.from_numpy(jax_projector.img_2d_to_pcd_3d(
        depth, k_src, motion=np.eye(4)))
    proj = torch.from_numpy(k_dst @ np.eye(4)[:3])[None]
    forward = splat_reprojections(points, proj, (h, w))[0].numpy()
    ref = jax_projector.pcd_2d_to_img_2d(jax_projector.pcd_3d_to_pcd_2d(
        points.numpy(), k_dst, np.eye(4)[:3], (h, w), keep_z=True,
        crop=True, filter_neg=True, norm_coord=False), (h, w))[..., 0]
    np.testing.assert_array_equal(forward, ref)
    hits = np.count_nonzero(ref)
    assert points.shape[0] / hits > 40  # many points on each pixel hit
    backward = splat_reprojections(points.flip(0), proj, (h, w))[0].numpy()
    assert (backward != forward).sum() > hits // 4


def _argv(scene, out, *extra):
    return ["--scene_dir", scene[0], "--image_dir", scene[1],
            "--depth_dir", scene[2], "--valid_list", scene[3], "--out", out,
            "--num_cpus", "2", *extra]


def test_cells_resume_and_numpy_pool_matches_torch_path(scene, tmp_path):
    split = str(tmp_path / "split.npy")
    first = twin.main(_argv(scene, split, "--cells", "11"), device="cpu")
    assert (first < 0).sum() == 30 - 11
    done = twin.main(_argv(scene, split), device="cpu")
    whole = twin.main(_argv(scene, str(tmp_path / "whole.npy")),
                      device="cpu")
    np.testing.assert_array_equal(done, whole)
    np.testing.assert_array_equal(np.diag(whole), np.ones(6))
    assert whole.min() >= 0 and whole.dtype == np.float32
    # a complete matrix is left as it is
    np.testing.assert_array_equal(
        twin.main(_argv(scene, split), device="cpu"), whole)
    caps = ColmapWithDepthAsciiReader.read_sfm_scene_given_valid_list_path(
        *scene).captures
    got = twin.torch_cells(caps, _off_diagonal(6), "cpu")
    _assert_gate({c: np.float32(v) for c, v in got.items()},
                 {c: whole[c] for c in got})


def test_a_failing_cell_raises():
    class Broken:
        pinhole_cam = SimpleNamespace(shape=(8, 8), intrinsic_mat=np.eye(3))

        @property
        def depth_map(self):
            raise OSError("depth file unreadable")

        point_cloud_world = depth_map

    good = _stub_capture(np.ones((8, 8), np.float32), np.eye(3), True)
    assert _jax_script().distance_between_two_caps(good, Broken()) == 0.0
    with pytest.raises(OSError):
        twin.torch_cells([good, Broken()], [(0, 1)], "cpu")
    with pytest.raises(OSError):
        twin.distance_between_two_caps(good, Broken())
