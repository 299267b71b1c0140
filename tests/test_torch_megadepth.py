"""The port's MegaDepth data path (cotr_tpu_torch/data/{colmap,scenes,
megadepth,dataset}.py) against the JAX package's, on two generated COLMAP
scenes: the flat plane of tests/test_data_pipeline.py (.jpg images, .h5
depth) and a scene of tools/generated_scene.py with two rectangles in front
of a tilted plane (.png images, .h5 depth, so both packages read it), where
the occlusion check rejects real pixels.

Tolerances: both packages run the same numpy (and the same C++ loop) on the
same inputs and draw the same random streams, and the port resamples as
PIL does, so parsed scenes, kNN picks, correspondences and every array of a
sample for the same (seed, index) are equal."""

import dataclasses

import numpy as np
import pytest

from cotr_tpu.data import dataset as jds
from cotr_tpu.data import megadepth as jmd
from cotr_tpu.data.colmap import ColmapWithDepthAsciiReader as JaxReader
from cotr_tpu_torch.data import dataset as tds
from cotr_tpu_torch.data import megadepth as tmd
from cotr_tpu_torch.data.colmap import ColmapWithDepthAsciiReader
from cotr_tpu_torch.tools.generated_scene import make_scene

from tests.test_data_pipeline import synthetic_scene  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """A DataConfig (port's) of 12 generated 96 x 128 views, 6 of them the
    validation split. The kNN pool of 5 drops the query from its own pool
    (as MegaDepth's pool of 20 does among its hundreds of views): a view
    paired with itself projects every pixel onto itself, where whether
    floor() and the frame check keep it hinges on the last bit of float64
    rounding, which the port's C++, the JAX package's (built with
    -march=native, so with fused multiply-adds) and numpy each round their
    own way."""
    import json

    root = tmp_path_factory.mktemp("generated")
    with open(make_scene(str(root), views=12, height=96, width=128,
                         val_views=6, seed=3, image_format="png",
                         depth_format="h5")) as f:
        raw = json.load(f)
    return tmd.DataConfig(
        scenes_name_list=raw["scenes_name_list"],
        valid_list_json=raw["valid_list_json"], train_json=raw["train_json"],
        val_json=raw["val_json"], test_json=raw["val_json"], num_kp=24,
        pool_size=5)


def _scene(request, which):
    if which == "flat":
        return request.getfixturevalue("synthetic_scene")["cfg"]
    return request.getfixturevalue("generated")


def _as_jax(cfg, **changes):
    """The JAX package's DataConfig with the same fields. Its scene cache
    is keyed by the scene's directory alone, so it is emptied first: a
    scene read before with another crop must not be handed back."""
    jmd._SceneCache.scenes.clear()
    jmd._SceneCache.knn.clear()
    return jmd.DataConfig(**dict(dataclasses.asdict(cfg), **changes))


def _as_port(cfg, **changes):
    return tmd.DataConfig(**dict(dataclasses.asdict(cfg), **changes))


def _assert_samples_equal(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


# ----------------------------------------------------------------- scenes

@pytest.mark.parametrize("crop", ["no_crop", "crop_center_and_resize"])
@pytest.mark.parametrize("which", ["flat", "generated"])
def test_scene_reads_as_the_jax_package_reads_it(request, which, crop):
    cfg = _scene(request, which)
    sdd = cfg.scenes_name_list[0]
    args = (sdd["scene_dir"], sdd["image_dir"], sdd["depth_dir"],
            cfg.valid_list_json, crop)
    got = ColmapWithDepthAsciiReader.read_sfm_scene_given_valid_list_path(
        *args)
    want = JaxReader.read_sfm_scene_given_valid_list_path(*args)
    assert len(got) == len(want) >= 3
    assert got.img_path_to_index_dict == want.img_path_to_index_dict
    for g, w in zip(got.captures, want.captures):
        assert g.image_id == w.image_id and g.depth_path == w.depth_path
        np.testing.assert_array_equal(g.intrinsic_mat, w.intrinsic_mat)
        np.testing.assert_array_equal(g.cam_pose.world_to_camera,
                                      w.cam_pose.world_to_camera)
        np.testing.assert_array_equal(g.image, w.image)
        np.testing.assert_array_equal(g.depth_map, w.depth_map)
    if which == "flat" and crop == "no_crop":
        assert got[0].image.shape == (48, 64, 3)
        assert (got[0].depth_map == 3.0).all()


@pytest.mark.parametrize("which", ["flat", "generated"])
def test_covisibility_lookup_as_the_jax_package(request, which):
    cfg = _scene(request, which)
    sdd = cfg.scenes_name_list[0]
    args = (sdd["scene_dir"], sdd["image_dir"], sdd["depth_dir"], "no_crop")
    got = ColmapWithDepthAsciiReader.read_sfm_scene(*args, covisibility=True)
    want = JaxReader.read_sfm_scene(*args, covisibility=True)
    assert sorted(got.point_meta) == sorted(want.point_meta)
    for g, w in zip(got.captures, want.captures):
        np.testing.assert_array_equal(g.point3d_id, w.point3d_id)
        assert [c.image_id for c in got.get_covisible_caps(g)] == \
            [c.image_id for c in want.get_covisible_caps(w)]
    if which == "flat":
        by_id = {cap.image_id: cap for cap in got.captures}
        assert sorted(c.image_id for c in
                      got.get_covisible_caps(by_id[1])) == [1, 2, 3]


@pytest.mark.parametrize("which", ["flat", "generated"])
def test_knn_and_query_sampling_as_the_jax_package(request, which):
    """get_knn with and without a database mask, and the (query, neighbour)
    pairs MegadepthDataset draws from random.Random(seed), split by split."""
    import random

    cfg = _scene(request, which)
    for split in ("train", "val"):
        want = jmd.MegadepthDataset(_as_jax(cfg), split,
                                    rng=random.Random(5))
        got = tmd.MegadepthDataset(_as_port(cfg), split,
                                   rng=random.Random(5))
        assert got.num_queries == want.num_queries >= 1
        for sid, mask in want.scene_index_to_db_caps_mask.items():
            np.testing.assert_array_equal(
                got.scene_index_to_db_caps_mask[sid], mask)
        knn_g, knn_w = got.knn_engines[0], want.knn_engines[0]
        np.testing.assert_array_equal(knn_g.nn_index, knn_w.nn_index)
        for cap_g, cap_w in zip(got.scenes[0].captures,
                                want.scenes[0].captures):
            for k, mask in ((2, None), (20, None), (3, np.array([0, 2]))):
                assert [c.img_path for c in knn_g.get_knn(cap_g, k, mask)] \
                    == [c.img_path for c in knn_w.get_knn(cap_w, k, mask)]
        for i in list(range(got.num_queries)) * 2:
            (qg, ng), (qw, nw) = (got.get_query_with_knn(i),
                                  want.get_query_with_knn(i))
            assert qg.img_path == qw.img_path
            assert [c.img_path for c in ng] == [c.img_path for c in nw]


def test_scene_cache_keeps_crops_apart(generated):
    """The port caches a scene under its read options: a dataset with
    another crop_cam gets its own captures."""
    a = tmd.MegadepthDataset(_as_port(generated, crop_cam="no_crop"), "val")
    b = tmd.MegadepthDataset(
        _as_port(generated, crop_cam="crop_center_and_resize"), "val")
    assert a.scenes[0].captures[0].image.shape == (96, 128, 3)
    assert b.scenes[0].captures[0].image.shape == (256, 256, 3)


# ------------------------------------------------------- correspondences

@pytest.mark.parametrize("crop", ["no_crop", "crop_center_and_resize"])
def test_compute_corrs_both_impls_as_the_jax_package(generated, crop):
    """Native: equal to the JAX package's native path (float32 values);
    numpy: equal to its numpy path, the same rows in the same order; the
    reduced numpy draw from the same RandomState equal too."""
    from cotr_tpu.native import available

    cfg = _as_port(generated, crop_cam=crop)
    scene = tmd.MegadepthDataset(cfg, "train").scenes[0]
    jscene = jmd.MegadepthDataset(_as_jax(generated, crop_cam=crop),
                                  "train").scenes[0]
    rejected = 0
    for i, j in ((0, 1), (0, 5), (3, 9), (7, 2)):
        a, b, ja, jb = scene[i], scene[j], jscene[i], jscene[j]
        nat = tds.compute_corrs(a, b)
        num = tds.compute_corrs(a, b, impl="numpy")
        assert available()
        np.testing.assert_array_equal(nat, jds.compute_corrs(ja, jb))
        np.testing.assert_array_equal(nat, num.astype(np.float32))
        # the numpy path is the JAX package's where its library is absent
        want = jds.compute_corrs(ja, jb, reduced_size=10 ** 9,
                                 rng=np.random.RandomState(0))
        got = tds.compute_corrs(a, b, reduced_size=10 ** 9,
                                rng=np.random.RandomState(0))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.sort(got, axis=0),
                                      np.sort(num, axis=0))
        for size in (1, 100):
            np.testing.assert_array_equal(
                tds.compute_corrs(a, b, reduced_size=size,
                                  rng=np.random.RandomState(size)),
                jds.compute_corrs(ja, jb, reduced_size=size,
                                  rng=np.random.RandomState(size)))
        in_frame = np.count_nonzero(a.depth_map > 0)
        rejected += in_frame - len(nat)
    assert rejected > 0
    with pytest.raises(ValueError):
        tds.compute_corrs(a, b, reduced_size=5, impl="native")
    with pytest.raises(ValueError):
        tds.compute_corrs(a, b, impl="cuda")


def test_occlusion_check_rejects_pixels_of_the_generated_scene(generated):
    """In the generated scene some pixels that project inside the other
    view fail |z_proj - z_depth| < 0.5 (hidden by a rectangle)."""
    from cotr_tpu_torch.geometry.projector import (pcd_2d_to_pcd_3d,
                                                   pcd_3d_to_pcd_2d)

    scene = tmd.MegadepthDataset(_as_port(generated, crop_cam="no_crop"),
                                 "train").scenes[0]
    a, b = scene[0], scene[6]
    ys, xs = np.nonzero(a.depth_map > 0)
    world = pcd_2d_to_pcd_3d(np.stack([xs, ys], 1),
                             a.depth_map[ys, xs][:, None],
                             a.pinhole_cam.intrinsic_mat,
                             motion=a.cam_pose.camera_to_world)
    in_frame = pcd_3d_to_pcd_2d(world, b.pinhole_cam.intrinsic_mat,
                                b.cam_pose.world_to_camera[:3],
                                b.depth_map.shape, keep_z=True,
                                norm_coord=False)
    kept = tds.compute_corrs(a, b)
    assert 0 < len(kept) < 0.97 * len(in_frame)


# --------------------------------------------------------------- samples

#: (which scene, dataset options) of the sample parity cases
CASES = {
    "flat, host layout": ("flat", dict(), {}),
    "generated, host layout": ("generated", dict(), {}),
    "generated, one direction": ("generated", dict(bidirectional=False), {}),
    "generated, rotations": ("generated", dict(
        need_rotation=True, max_rotation=30.0, rotation_chance=0.7), {}),
    "flat, device_synth": ("flat", dict(), dict(device_synth=True)),
    "generated, device_synth": ("generated", dict(),
                                dict(device_synth=True)),
    "generated, device_synth, rotations": ("generated", dict(
        need_rotation=True, max_rotation=20.0, rotation_chance=1.0),
        dict(device_synth=True, cand_factor=3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cotr_dataset_samples_equal(request, case):
    """The same (seed, index) gives the same sample, every array equal,
    for several indices in turn (the random streams run on together)."""
    which, changes, kw = CASES[case]
    cfg = _scene(request, which)
    for seed in (0, 7):
        for split in ("train", "val"):
            got = tds.CotrDataset(_as_port(cfg, **changes), split, seed=seed,
                                  **kw)
            want = jds.CotrDataset(_as_jax(cfg, **changes), split,
                                   seed=seed, **kw)
            assert len(got) == len(want)
            for index in [0, len(want) - 1, 1 % len(want), 0]:
                _assert_samples_equal(got[index], want[index],
                                      f"{case} seed {seed} {split} {index}")


@pytest.mark.parametrize("changes", [dict(crop_cam="no_crop"),
                                     dict(crop_cam="crop_center",
                                          zoom_jitter=0.2, zoom_levels=4),
                                     dict(crop_cam="no_crop",
                                          need_rotation=True,
                                          max_rotation=15.0,
                                          rotation_chance=0.5)])
def test_cotr_zoom_dataset_samples_equal(generated, changes):
    for seed in (0, 3):
        got = tds.CotrZoomDataset(_as_port(generated, **changes), "train",
                                  seed=seed)
        want = jds.CotrZoomDataset(_as_jax(generated, **changes), "train",
                                   seed=seed)
        for index in (0, 4, 11, 4):
            _assert_samples_equal(got[index], want[index],
                                  f"zoom {changes} seed {seed} {index}")


def test_zoom_dataset_refuses_a_resized_crop(generated):
    with pytest.raises(ValueError):
        tds.CotrZoomDataset(_as_port(generated), "train")


def test_batch_iterator_equal(generated):
    got = list(tds.batch_iterator(tds.CotrDataset(_as_port(generated),
                                                  "train", seed=1), 4,
                                  seed=2))
    want = list(jds.batch_iterator(jds.CotrDataset(_as_jax(generated),
                                                   "train", seed=1), 4,
                                   seed=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_samples_equal(g, w, "batch")
