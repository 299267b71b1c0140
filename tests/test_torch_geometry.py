"""The port's camera geometry (cotr_tpu_torch/geometry) against the JAX
package's, its PIL-free resampling against PIL, its torch projections
against the JAX package's jnp ones, and its three native functions of the
MegaDepth data path against cotr_tpu.native and the port's numpy paths.

Tolerances: the numpy geometry is the same code on the same float64 (and
float32) inputs, so its results are equal; PIL's NEAREST resize, its
NEAREST rotation and its BILINEAR rotation of uint8 images are equal to
PIL's; the torch projections agree with the jnp ones to float32 rounding
(1e-5 relative)."""

import os
import textwrap

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from cotr_tpu import native as jax_native
from cotr_tpu.geometry import camera as jcam
from cotr_tpu.geometry import capture as jcap
from cotr_tpu.geometry import projector as jproj
from cotr_tpu.geometry import transforms as jtf
from cotr_tpu_torch import native
from cotr_tpu_torch.geometry import camera, capture, projector, transforms
from cotr_tpu_torch.tools.generated_scene import write_colmap_array


def _rotation_4x4(rng):
    m = np.identity(4)
    m[:3, :3] = ScipyRot.random(random_state=rng).as_matrix()
    return m


def _pose_pair(seed):
    rng = np.random.RandomState(seed)
    w2c = _rotation_4x4(rng)
    w2c[:3, 3] = rng.uniform(-5, 5, 3)
    return (jcam.CameraPose.from_world_to_camera(w2c),
            camera.CameraPose.from_world_to_camera(w2c))


# ----------------------------------------------- the cases of test_geometry

def test_quaternion_algebra_equal():
    rng = np.random.RandomState(0)
    for _ in range(25):
        m = _rotation_4x4(rng)
        q = transforms.quaternion_from_matrix(m)
        np.testing.assert_array_equal(q, jtf.quaternion_from_matrix(m))
        np.testing.assert_array_equal(transforms.quaternion_matrix(q),
                                      jtf.quaternion_matrix(q))
        np.testing.assert_allclose(transforms.quaternion_matrix(q), m,
                                   atol=1e-9)
        qi = transforms.quaternion_inverse(q)
        np.testing.assert_array_equal(qi, jtf.quaternion_inverse(q))
        np.testing.assert_array_equal(transforms.quaternion_multiply(q, qi),
                                      jtf.quaternion_multiply(q, qi))
    t = rng.randn(3)
    np.testing.assert_array_equal(transforms.translation_matrix(t),
                                  jtf.translation_matrix(t))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_camera_pose_properties_equal(seed):
    jp, tp = _pose_pair(seed)
    for name in ("world_to_camera", "camera_to_world", "world_to_camera_3x4",
                 "camera_center_in_world", "forward", "essential_matrix",
                 "pose_vector", "quaternion", "translation_vector"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)
    for deg in (0.0, 17.5, 360.0):
        np.testing.assert_array_equal(
            camera.rotate_camera_pose(tp, deg).world_to_camera,
            jcam.rotate_camera_pose(jp, deg).world_to_camera)
    np.testing.assert_array_equal(
        camera.inverse_camera_pose(tp).world_to_camera,
        jcam.inverse_camera_pose(jp).world_to_camera)
    unstable = camera.CameraPose.from_world_to_camera(
        tp.world_to_camera, unstable=True)
    np.testing.assert_array_equal(
        unstable.quaternion, jcam.CameraPose.from_world_to_camera(
            jp.world_to_camera, unstable=True).quaternion)


def test_crop_pinhole_camera_modes_equal():
    cam_t = camera.PinholeCamera(640, 480, 500.0, 600.0, 320.0, 240.0)
    cam_j = jcam.PinholeCamera(640, 480, 500.0, 600.0, 320.0, 240.0)
    crops = [("crop_center", "crop_center"),
             ("crop_center_and_resize", "crop_center_and_resize"),
             (capture.CropCamConfig(10, 20, 100, 100, 256, 256, 640, 480),
              jcap.CropCamConfig(10, 20, 100, 100, 256, 256, 640, 480))]
    for ct, cj in crops:
        np.testing.assert_array_equal(
            camera.crop_pinhole_camera(cam_t, ct).intrinsic_mat,
            jcam.crop_pinhole_camera(cam_j, cj).intrinsic_mat)


def test_projection_functions_equal():
    rng = np.random.RandomState(5)
    k = camera.PinholeCamera(640, 480, 500.0, 500.0, 320.0, 240.0
                             ).intrinsic_mat
    pts = rng.uniform(-1, 1, (300, 4))
    pts[:, 2] = rng.uniform(-1, 5, 300)  # some behind the camera
    ext = _rotation_4x4(rng)[:3] * 0.2 + np.eye(4)[:3]
    for kw in (dict(keep_z=True, crop=True, filter_neg=True,
                    norm_coord=False),
               dict(keep_z=False, crop=False, filter_neg=False,
                    norm_coord=True)):
        got = projector.pcd_3d_to_pcd_2d(pts, k, ext, (480, 640),
                                         return_index=True, **kw)
        want = jproj.pcd_3d_to_pcd_2d(pts, k, ext, (480, 640),
                                      return_index=True, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    xy = np.stack([rng.randint(0, 640, 200), rng.randint(0, 480, 200),
                   rng.rand(200)], 1).astype(np.float64)
    z = rng.uniform(-1, 4, (200, 1))
    motion = np.linalg.inv(_rotation_4x4(rng))
    for g, w in zip(
            projector.pcd_2d_to_pcd_3d(xy, z, k, motion, return_index=True),
            jproj.pcd_2d_to_pcd_3d(xy, z, k, motion, return_index=True)):
        np.testing.assert_array_equal(g, w)
    splat = np.concatenate([rng.uniform(0, 63, (50, 2)),
                            rng.uniform(1, 3, (50, 1)), rng.rand(50, 2)], 1)
    np.testing.assert_array_equal(
        projector.pcd_2d_to_img_2d(splat, (64, 64), has_z=True),
        jproj.pcd_2d_to_img_2d(splat, (64, 64), has_z=True))
    depth = rng.uniform(0, 5, (24, 32)) * (rng.rand(24, 32) > 0.3)
    np.testing.assert_array_equal(
        projector.img_2d_to_pcd_3d(depth, k, motion=motion),
        jproj.img_2d_to_pcd_3d(depth, k, motion=motion))


def test_torch_projections_match_jnp():
    """project_points / unproject_depth against the JAX package's jnp
    versions, float32: 1e-5 relative (the same sums, other orders)."""
    rng = np.random.RandomState(6)
    k = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    ext = (_rotation_4x4(rng)[:3] * 0.1 + np.eye(4)[:3]).astype(np.float32)
    pts = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    pts[:, 2] += 3
    got = projector.project_points(*map(torch.from_numpy, (pts, k, ext)))
    want = np.asarray(jproj.project_points_jnp(*map(jnp.asarray,
                                                     (pts, k, ext))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    depth = rng.uniform(1, 4, (12, 16)).astype(np.float32)
    depth[0, :3] = 0
    c2w = np.linalg.inv(_rotation_4x4(rng)).astype(np.float32)
    got = projector.unproject_depth(*map(torch.from_numpy, (depth, k, c2w)))
    want = np.asarray(jproj.unproject_depth_jnp(*map(jnp.asarray,
                                                      (depth, k, c2w))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_crop_center_max_and_pad_to_square_equal():
    img = np.arange(6 * 9 * 3).reshape(6, 9, 3)
    np.testing.assert_array_equal(capture.crop_center_max(img),
                                  jcap.crop_center_max(img))
    for div in (1, 4):
        got = capture.pad_to_square(img, div, return_starts=True)
        want = jcap.pad_to_square(img, div, return_starts=True)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


# ------------------------------------------------- resampling without PIL

def test_resize_nearest_equals_pil():
    """PIL's NEAREST, which steps its source position by the scale: equal
    for float32 depth and uint8 images, down and up, on 100 sizes (the
    product floor((i + 0.5) * in / out) differs from PIL at some)."""
    rng = np.random.RandomState(0)
    sizes = [((768, 768), (256, 256)), ((480, 480), (256, 256)),
             ((333, 333), (256, 256)), ((96, 96), (256, 256))]
    sizes += [(tuple(rng.randint(2, 900, 2)), tuple(rng.randint(1, 400, 2)))
              for _ in range(96)]
    for (ih, iw), (oh, ow) in sizes:
        for arr in (rng.rand(ih, iw).astype(np.float32),
                    rng.randint(0, 256, (ih, iw, 3)).astype(np.uint8)):
            want = np.array(PIL.Image.fromarray(arr).resize(
                (ow, oh), resample=PIL.Image.NEAREST))
            np.testing.assert_array_equal(
                capture.resize_nearest_host(arr, (oh, ow)), want,
                err_msg=f"{(ih, iw)} -> {(oh, ow)} {arr.dtype}")


@pytest.mark.parametrize("shape", [(48, 64), (64, 64), (101, 37)])
def test_rotate_image_equals_pil(shape):
    """``rotate_image`` against PIL's ``rotate(expand=False)``: NEAREST on
    float32 depth, BILINEAR on uint8 RGB, at random angles and PIL's
    special ones (0, 90, 180, 270, 360, negative): equal."""
    rng = np.random.RandomState(sum(shape))
    depth = rng.uniform(0, 10, shape).astype(np.float32)
    img = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    angles = [0.0, 90.0, 180.0, 270.0, 360.0, -90.0, 45.0, -12.5]
    angles += list(rng.uniform(-30, 30, 6))
    for a in angles:
        want = np.array(PIL.Image.fromarray(depth).rotate(
            a, resample=PIL.Image.NEAREST, expand=False))
        np.testing.assert_array_equal(
            capture.rotate_image(depth, a, nearest=True), want,
            err_msg=f"nearest {a}")
        want = np.array(PIL.Image.fromarray(img).rotate(
            a, resample=PIL.Image.BILINEAR, expand=False))
        np.testing.assert_array_equal(capture.rotate_image(img, a), want,
                                      err_msg=f"bilinear {a}")


def test_rotate_image_equals_the_jax_package():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (40, 56, 3)).astype(np.uint8)
    depth = rng.uniform(0, 3, (40, 56)).astype(np.float32)
    for a in (7.0, -21.3):
        np.testing.assert_array_equal(capture.rotate_image(img, a),
                                      jcap.rotate_image(img, a))
        np.testing.assert_array_equal(
            capture.rotate_image(depth, a, nearest=True),
            jcap.rotate_image(depth, a, nearest=True))


def test_read_colmap_array_round_trip(tmp_path):
    """A COLMAP .bin whose data holds a newline byte early: the port reads
    it back exactly (the JAX reader decodes that line as UTF-8)."""
    rng = np.random.RandomState(1)
    depth = rng.uniform(0, 20, (30, 41)).astype(np.float32)
    depth.flat[0] = np.frombuffer(b"\n\xb4\x00\x40", np.float32)[0]
    path = str(tmp_path / "d.geometric.bin")
    write_colmap_array(path, depth)
    np.testing.assert_array_equal(capture.read_colmap_array(path), depth)
    three = rng.rand(5, 7, 3).astype(np.float32)
    write_colmap_array(path, three)
    np.testing.assert_array_equal(capture.read_colmap_array(path), three)


def test_captured_depth_formats(tmp_path):
    """.npy and .bin depths read the same; 'dummy' takes the image's size
    from a .npy image; an unknown suffix raises."""
    depth = np.random.RandomState(3).uniform(1, 2, (12, 20)).astype(
        np.float32)
    np.save(tmp_path / "d.npy", depth)
    write_colmap_array(str(tmp_path / "d.bin"), depth)
    np.save(tmp_path / "img.npy", np.zeros((12, 20, 3), np.uint8))
    for name in ("d.npy", "d.bin"):
        got = capture.CapturedDepth(str(tmp_path / name), "no_crop").depth_map
        np.testing.assert_array_equal(got, depth)
    dummy = capture.CapturedDepth(str(tmp_path / "img.npy") + "dummy",
                                  "no_crop").depth_map
    assert dummy.shape == (12, 20) and not dummy.any()
    (tmp_path / "d.txt").write_text("x")
    with pytest.raises(ValueError):
        capture.CapturedDepth(str(tmp_path / "d.txt"), "no_crop").depth_map


# ------------------------------------------------------ native functions

def _captures(seed=0, h=48, w=64):
    """Two RGBD cameras over a depth map with holes, as tests/test_native
    builds them, in each package's classes."""
    rng = np.random.RandomState(seed)
    depth_a = rng.uniform(2.0, 4.0, (h, w)).astype(np.float32)
    depth_a[rng.rand(h, w) < 0.3] = 0.0
    depth_b = np.full((h, w), 3.0, np.float32)
    depth_b[: h // 3] = 2.0  # a nearer band: occludes some of a's pixels
    w2c = np.eye(4)
    w2c[:3, 3] = [0.2, -0.1, 0.05]
    out = []
    for cam_mod in (jcam, camera):
        cam = cam_mod.PinholeCamera(w, h, 60.0, 60.0, w / 2, h / 2)
        caps = []
        for depth, pose in ((depth_a, np.eye(4)), (depth_b, w2c)):
            cap = type("Cap", (), {})()
            cap.pinhole_cam = cam
            cap.cam_pose = cam_mod.CameraPose.from_world_to_camera(pose)
            cap.depth_map = depth
            cap.image = np.zeros((h, w, 3), np.uint8)
            caps.append(cap)
        out.append(caps)
    return out


def _synth_args(a, b):
    return (a.depth_map, np.linalg.inv(a.pinhole_cam.intrinsic_mat),
            a.cam_pose.camera_to_world,
            b.pinhole_cam.intrinsic_mat @ b.cam_pose.world_to_camera[0:3, :],
            b.depth_map)


@pytest.mark.parametrize("seed", [0, 1])
def test_native_synth_corrs_equals_jax_native_and_numpy(seed):
    """The port's C++ against cotr_tpu.native (equal) and against its own
    numpy path rounded to float32 (equal: the same rows in the same order,
    the C++ rounding its float64 results to float32)."""
    from cotr_tpu_torch.data.dataset import compute_corrs

    (ja, jb), (ta, tb) = _captures(seed)
    got = native.synth_corrs(*_synth_args(ta, tb))
    assert got.dtype == np.float32 and len(got) > 100
    if jax_native.available():
        np.testing.assert_array_equal(
            got, jax_native.synth_corrs(*_synth_args(ja, jb)))
    numpy_rows = compute_corrs(ta, tb, impl="numpy")
    np.testing.assert_array_equal(got, numpy_rows.astype(np.float32))
    np.testing.assert_array_equal(compute_corrs(ta, tb),
                                  got.astype(np.float64))
    # the occlusion band rejects some in-frame pixels
    assert len(got) < np.count_nonzero(ta.depth_map)
    capped = native.synth_corrs(*_synth_args(ta, tb), max_out=10)
    np.testing.assert_array_equal(capped, got[:10])


def test_native_count_valid_depth():
    rng = np.random.RandomState(4)
    depth = rng.uniform(-1, 1, (37, 53)).astype(np.float32)
    depth[0, 0] = np.nan
    assert native.count_valid_depth(depth) == np.count_nonzero(depth > 0)
    if jax_native.available():
        lib = jax_native._load()
        d = np.ascontiguousarray(depth)
        assert native.count_valid_depth(depth) == lib.count_valid_depth(
            d, *d.shape)


def test_native_parse_images_txt_equals_the_readers(tmp_path):
    """The C++ images.txt parser against the port's Python reader and
    cotr_tpu.native: the same ids, cameras, poses and names, a POINTS2D
    line longer than the C++ line buffer included."""
    from cotr_tpu_torch.data.colmap import read_images_meta

    long_points = " ".join(f"{i}.5 {i}.25 {i}" for i in range(2000))
    content = textwrap.dedent(f"""\
        # Image list with two lines of data per image:
        #   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME
        #   POINTS2D[] as (X, Y, POINT3D_ID)
        # Number of images: 3, mean observations per image: 1.5
        7 0.9689 0.0296 -0.2090 -0.1281 2.5 0.1 1.5 1 img_a.jpg
        {long_points}
        9 1.0 0.0 0.0 0.0 -1.0 0.0 0.25 2 sub/img_b.jpg
        1.0 2.0 -1 3.0 4.0 5
        11 0.5 0.5 0.5 0.5 3.0 2.0 1.0 1 img_c.png

        """)
    p = tmp_path / "images.txt"
    p.write_text(content)
    ids, cams, qt, names = native.parse_images_txt(str(p))
    assert list(ids) == [7, 9, 11] and list(cams) == [1, 2, 1]
    assert names == ["img_a.jpg", "sub/img_b.jpg", "img_c.png"]
    metas = read_images_meta(str(p), str(tmp_path), require_files=False)
    assert list(metas) == list(ids)
    for i, m in zip(ids, metas.values()):
        row = qt[list(ids).index(i)]
        np.testing.assert_array_equal(
            m.r.quaternion,
            camera.Rotation(row[:4].astype(np.float32)).quaternion)
        np.testing.assert_array_equal(m.t.translation_vector,
                                      row[4:].astype(np.float32))
        assert m.image_path == os.path.join(str(tmp_path), names[
            list(ids).index(i)])
    with pytest.raises(OSError):
        native.parse_images_txt(str(tmp_path / "missing.txt"))


def test_native_functions_check_their_arguments():
    with pytest.raises(ValueError):
        native.count_valid_depth(np.zeros((2, 3, 4), np.float32))
    with pytest.raises(ValueError):
        native.synth_corrs(np.ones((4, 4)), np.eye(4), np.eye(4),
                           np.eye(4)[:3], np.ones((4, 4)))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A source that does not compile raises; nothing falls back."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setitem(native.SOURCES, "broken", bad)
    with pytest.raises(RuntimeError):
        native.build_library("broken")
