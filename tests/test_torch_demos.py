"""The demo twins (cotr_tpu_torch/demos) against the JAX package's demos
(demos/*.py), both run whole through ``main`` on the CPU.

Each JAX demo is imported with ``demos/`` on ``sys.path`` and its seams
replaced: ``build_engine`` by a real JAX engine on the identity stub, the
picture writer by a recorder. The twin gets the port's engine on the same
stub. B equals A in content, which the stub needs, and the correspondences
the two hand to the picture writer agree to 1e-4 px (the stub's arithmetic
is exact, tests/test_torch_engine_stub.py). Then both are fed the same
correspondences by a fixed engine, and what they compute from them must
agree: the homography and overlay to 1e-3 on [0, 255] where the warp
samples inside the painting, the mutual-nearest-neighbour and RANSAC inlier
sets exactly, the triangulated points to 1e-6 relative and the densified
warp to 1e-3.
"""

import importlib
import os
import sys

import numpy as np
import PIL.Image
import pytest
import torch

from cotr_tpu.inference.engine import SparseEngine as JaxEngine
from cotr_tpu_torch.demos import (demo_face, demo_guided_matching,
                                  demo_homography, demo_reconstruction,
                                  demo_single_pair, demo_utils, demo_wbs)
from cotr_tpu_torch.inference.engine import SparseEngine

from tests.test_torch_common import (JaxIdentityRunner, TorchIdentityRunner,
                                     smooth_image)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = {"demo_single_pair": demo_single_pair, "demo_face": demo_face,
         "demo_homography": demo_homography,
         "demo_guided_matching": demo_guided_matching,
         "demo_reconstruction": demo_reconstruction, "demo_wbs": demo_wbs}
CORR_TOL = 1e-4


@pytest.fixture
def jax_demo(monkeypatch):
    """Import a JAX demo module by name, as its script imports it."""
    monkeypatch.syspath_prepend(os.path.join(_ROOT, "demos"))

    def load(name):
        return importlib.import_module(name)

    return load


class Recorder:
    """Stands in for ``save_corr_visualization``: keeps what it is given."""

    def __init__(self):
        self.calls = []

    def __call__(self, img_a, img_b, corrs, out_path, lines=True):
        self.calls.append((np.array(corrs), out_path))


def _jax_engine(args, mode="tile"):
    return JaxEngine(JaxIdentityRunner(), batch_size=args.batch_size,
                     mode=mode, task_bucket=8)


def _port_engine(args, mode="tile", device="cuda"):
    assert str(device) == "cpu"
    return SparseEngine(TorchIdentityRunner(), batch_size=args.batch_size,
                        mode=mode)


def _run_both(name, jax_demo, monkeypatch, tmp_path, argv, jax_engine=None,
              port_engine=None):
    """Run the JAX demo and its twin on the same arguments. Returns (JAX
    recorder, twin recorder, the twin's result)."""
    mod = jax_demo(name)
    twin = TWINS[name]
    rec_jax, rec_port = Recorder(), Recorder()
    monkeypatch.setattr(mod, "build_engine", jax_engine or _jax_engine)
    monkeypatch.setattr(mod, "save_corr_visualization", rec_jax)
    monkeypatch.setattr(twin, "build_engine", port_engine or _port_engine)
    monkeypatch.setattr(twin, "save_corr_visualization", rec_port)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [name + ".py", *argv("png")])
    mod.main()
    result = twin.main(argv("npy"), device="cpu")
    return rec_jax, rec_port, result


def _write_pair(tmp_path, hw, seed=0, name="img"):
    """One smooth image written as PNG (the JAX demos read it with imageio)
    and as .npy (the twin's input on the card). Returns the argv factory's
    image flags and the image."""
    img = smooth_image(np.random.RandomState(seed), hw)
    PIL.Image.fromarray(img).save(tmp_path / f"{name}.png")
    np.save(tmp_path / f"{name}.npy", img)
    return img


def _images(tmp_path, ext, a="img", b="img"):
    return ["--img_a", str(tmp_path / f"{a}.{ext}"),
            "--img_b", str(tmp_path / f"{b}.{ext}")]


def _assert_same_corrs(rec_jax, rec_port):
    assert len(rec_jax.calls) == len(rec_port.calls) == 1
    want, got = rec_jax.calls[0][0], rec_port.calls[0][0]
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, atol=CORR_TOL, rtol=0)
    assert rec_port.calls[0][1] == rec_jax.calls[0][1]


# ------------------------------------------------- the engine, stub on both

def test_single_pair_matches_jax(jax_demo, monkeypatch, tmp_path):
    _write_pair(tmp_path, (160, 160))
    rec_jax, rec_port, result = _run_both(
        "demo_single_pair", jax_demo, monkeypatch, tmp_path,
        lambda ext: [*_images(tmp_path, ext), "--max_corrs", "12"])
    _assert_same_corrs(rec_jax, rec_port)
    np.testing.assert_array_equal(result["corrs"], rec_port.calls[0][0])


def test_face_matches_jax(jax_demo, monkeypatch, tmp_path):
    _write_pair(tmp_path, (120, 176))
    rng = np.random.RandomState(2)
    landmarks = np.stack([rng.uniform(20, 150, 68), rng.uniform(15, 100, 68)],
                         axis=1)
    np.save(tmp_path / "landmarks.npy", landmarks[None])
    rec_jax, rec_port, result = _run_both(
        "demo_face", jax_demo, monkeypatch, tmp_path,
        lambda ext: [*_images(tmp_path, ext), "--landmarks",
                     str(tmp_path / "landmarks.npy")])
    _assert_same_corrs(rec_jax, rec_port)
    np.testing.assert_array_equal(result["landmarks"], landmarks)


def test_wbs_matches_jax(jax_demo, monkeypatch, tmp_path, capsys):
    _write_pair(tmp_path, (160, 160))
    rng = np.random.RandomState(3)
    pts = rng.uniform(20, 140, (10, 2))
    np.savetxt(tmp_path / "pts.txt", np.concatenate([pts, pts + 0.5], 1))
    rec_jax, rec_port, result = _run_both(
        "demo_wbs", jax_demo, monkeypatch, tmp_path,
        lambda ext: [*_images(tmp_path, ext), "--pts",
                     str(tmp_path / "pts.txt")])
    _assert_same_corrs(rec_jax, rec_port)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "mean error vs annotation" in ln]
    assert len(lines) == 2 and lines[0] == lines[1]
    np.testing.assert_allclose(result["err"], np.linalg.norm(
        result["corrs"][:, 2:] - (pts + 0.5), axis=1))


def test_homography_matches_jax(jax_demo, monkeypatch, tmp_path):
    """The annotated corners are those of the reference's photograph; both
    demos get the same four inside the small generated pair instead."""
    corners = np.array([[30, 25], [140, 20], [28, 95], [150, 100]],
                       np.float32)
    monkeypatch.setattr(jax_demo("demo_homography"), "ANNOTATED_CORNERS",
                        corners)
    monkeypatch.setattr(demo_homography, "ANNOTATED_CORNERS", corners)
    img = _write_pair(tmp_path, (120, 176))
    _write_pair(tmp_path, (40, 30), seed=5, name="rep")
    rec_jax, rec_port, result = _run_both(
        "demo_homography", jax_demo, monkeypatch, tmp_path,
        lambda ext: [*_images(tmp_path, ext), "--rep_img",
                     str(tmp_path / f"rep.{ext}"),
                     "--out", str(tmp_path / "overlay.png")])
    _assert_same_corrs(rec_jax, rec_port)
    assert rec_port.calls[0][1] == str(tmp_path / "overlay_corrs.png")
    assert result["overlay"].shape == img.shape


def test_reconstruction_matches_jax(jax_demo, monkeypatch, tmp_path):
    _write_pair(tmp_path, (160, 160))
    k = np.array([[150.0, 0, 80], [0, 150, 80], [0, 0, 1]])
    c2w_b = np.eye(4)
    c2w_b[:3, 3] = [0.3, 0.0, 0.05]
    np.save(tmp_path / "cam_a.npy", {"intrinsic": k, "c2w": np.eye(4)})
    np.save(tmp_path / "cam_b.npy",
            {"intrinsic": k, "W2C": np.linalg.inv(c2w_b)[:3]})
    rec_jax, rec_port, result = _run_both(
        "demo_reconstruction", jax_demo, monkeypatch, tmp_path,
        lambda ext: [*_images(tmp_path, ext), "--max_corrs", "12",
                     "--camera_a", str(tmp_path / "cam_a.npy"),
                     "--camera_b", str(tmp_path / "cam_b.npy"),
                     "--out_pcd", str(tmp_path / f"pcd_{ext}.npy")])
    _assert_same_corrs(rec_jax, rec_port)
    want, got = (np.load(tmp_path / f"pcd_{ext}.npy") for ext in ("png",
                                                                  "npy"))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(result["points"], got[:, :3])


def test_guided_matching_serial_branch_matches_jax(jax_demo, monkeypatch,
                                                   tmp_path):
    """``--faster_infer no``: two ``cotr_corr_multiscale`` calls, as the
    JAX demo takes them when its engine has no multi-pair method."""
    _write_pair(tmp_path, (160, 160))
    rng = np.random.RandomState(6)
    kpts_a = rng.uniform(10, 150, (40, 2))
    kpts_b = np.concatenate([kpts_a + rng.uniform(-0.3, 0.3, (40, 2)),
                             rng.uniform(10, 150, (10, 2))])
    np.save(tmp_path / "kpts_a.npy", kpts_a)
    np.save(tmp_path / "kpts_b.npy", kpts_b)
    rec_jax, rec_port, result = _run_both(
        "demo_guided_matching", jax_demo, monkeypatch, tmp_path,
        lambda ext: [*_images(tmp_path, ext),
                     "--kpts_a", str(tmp_path / "kpts_a.npy"),
                     "--kpts_b", str(tmp_path / "kpts_b.npy")])
    _assert_same_corrs(rec_jax, rec_port)
    assert len(result["mutual"]) >= 30


# ------------------------------------- the post-processing, the same corrs

class FixedEngine:
    """Answers each call with the next of ``answers``, whatever it is
    asked: both packages get the same correspondences."""

    def __init__(self, *answers):
        self.answers = list(answers)
        self.total_tasks = 0

    def _next(self, *args, **kwargs):
        return self.answers.pop(0)

    cotr_corr_multiscale = _next
    cotr_corr_multiscale_with_cycle_consistency = _next


def _fixed(*answers):
    """A ``build_engine`` for each package that hands out ``answers``."""
    def jax_build(args, mode="tile"):
        return FixedEngine(*answers)

    def port_build(args, mode="tile", device="cuda"):
        return FixedEngine(*answers)

    return dict(jax_engine=jax_build, port_engine=port_build)


def _two_view(n, outliers, rng):
    """Pixels of n points seen by two cameras 150 px from the principal
    point apart; the last ``outliers`` rows of B moved 30 to 80 px."""
    k = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]])
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                    rng.uniform(3, 6, n)], axis=1)
    t = np.array([0.5, 0.05, 0.0])
    pa = pts @ k.T
    pb = (pts + t) @ k.T
    pa, pb = pa[:, :2] / pa[:, 2:], pb[:, :2] / pb[:, 2:]
    if outliers:
        pb[n - outliers:] += rng.uniform(30, 80, (outliers, 2))
    return pa, pb, k, t, pts


def test_guided_matching_post_processing_matches_jax(jax_demo, monkeypatch,
                                                     tmp_path):
    rng = np.random.RandomState(7)
    pa, pb, *_ = _two_view(60, 12, rng)
    kpts_a = pa
    perm = rng.permutation(60)
    kpts_b = np.concatenate([pb[perm], rng.uniform(0, 320, (15, 2))])
    # transfers a -> b land near the true point; b -> a likewise, the
    # distractors anywhere
    corr_ab = np.concatenate([kpts_a, pb + rng.normal(0, 0.2, (60, 2))], 1)
    back = np.concatenate([pa[perm] + rng.normal(0, 0.2, (60, 2)),
                           rng.uniform(0, 320, (15, 2))])
    corr_ba = np.concatenate([kpts_b, back], 1)
    np.save(tmp_path / "kpts_a.npy", kpts_a)
    np.save(tmp_path / "kpts_b.npy", kpts_b)
    _write_pair(tmp_path, (240, 320))
    answers = [(corr_ab, np.arange(60)), (corr_ba, np.arange(75))]
    rec_jax, rec_port, result = _run_both(
        "demo_guided_matching", jax_demo, monkeypatch, tmp_path,
        lambda ext: [*_images(tmp_path, ext),
                     "--kpts_a", str(tmp_path / "kpts_a.npy"),
                     "--kpts_b", str(tmp_path / "kpts_b.npy")],
        **_fixed(*answers))
    assert len(result["mutual"]) == 60
    inliers = result["inliers"]
    # the last 12 are the outliers: one may fall near its epipolar line
    assert inliers[:48].all() and inliers[48:].sum() <= 2
    np.testing.assert_array_equal(rec_port.calls[0][0], rec_jax.calls[0][0])


def test_reconstruction_post_processing_matches_jax(jax_demo, monkeypatch,
                                                    tmp_path):
    rng = np.random.RandomState(8)
    pa, pb, k, t, pts = _two_view(50, 0, rng)
    c2w_b = np.eye(4)
    c2w_b[:3, 3] = -t
    np.save(tmp_path / "cam_a.npy", {"intrinsic": k, "c2w": np.eye(4)})
    np.save(tmp_path / "cam_b.npy",
            {"intrinsic": k, "extrinsic": np.linalg.inv(c2w_b)})
    _write_pair(tmp_path, (240, 320))
    corrs = np.concatenate([pa, pb], 1)
    _, _, result = _run_both(
        "demo_reconstruction", jax_demo, monkeypatch, tmp_path,
        lambda ext: [*_images(tmp_path, ext),
                     "--camera_a", str(tmp_path / "cam_a.npy"),
                     "--camera_b", str(tmp_path / "cam_b.npy"),
                     "--out_pcd", str(tmp_path / f"pcd_{ext}.npy")],
        **_fixed(corrs))
    want, got = (np.load(tmp_path / f"pcd_{ext}.npy") for ext in ("png",
                                                                  "npy"))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(result["points"], pts, atol=1e-6)


def test_densify_matches_jax(jax_demo, monkeypatch, tmp_path):
    """``--densify``: the Delaunay flow of corrs along a known affine map,
    and B sampled at it, float32, against the JAX demo's samples."""
    import cotr_tpu.ops.sampling as jax_sampling

    img = _write_pair(tmp_path, (96, 128))
    rng = np.random.RandomState(9)
    src = np.stack([rng.uniform(0, 127, 40), rng.uniform(0, 95, 40)], 1)
    src = np.concatenate([src, [[0, 0], [127, 0], [0, 95], [127, 95]]])
    dst = src @ np.array([[0.97, 0.05], [-0.04, 0.99]]).T + [2.5, -1.5]
    samples = []
    real = jax_sampling._gather_bilinear

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        samples.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax_sampling, "_gather_bilinear", recorded)
    _, _, result = _run_both(
        "demo_single_pair", jax_demo, monkeypatch, tmp_path,
        lambda ext: [*_images(tmp_path, ext), "--densify"],
        **_fixed(np.concatenate([src, dst], 1)))
    assert len(samples) == 1
    assert (tmp_path / "dense_output.png").exists()
    np.testing.assert_allclose(result["warped"], samples[0], atol=1e-3)
    inside = result["dense"].any(axis=-1)
    assert inside.mean() > 0.9 and img.shape[:2] == inside.shape
    written = np.array(PIL.Image.open(tmp_path / "dense_output.png"))
    np.testing.assert_array_equal(
        written, np.clip(result["warped"], 0, 255).astype(np.uint8))


def test_homography_post_processing_matches_jax(jax_demo, monkeypatch,
                                                tmp_path):
    import cotr_tpu.ops.geometry_cv as jax_cv

    _write_pair(tmp_path, (120, 160))
    _write_pair(tmp_path, (50, 40), seed=1, name="rep")
    corners = np.array([[20.0, 15], [130, 22], [18, 100], [140, 95]])
    corrs = np.concatenate([demo_homography.ANNOTATED_CORNERS, corners], 1)
    warps = []
    real = jax_cv.warp_perspective

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        warps.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax_cv, "warp_perspective", recorded)
    _, _, result = _run_both(
        "demo_homography", jax_demo, monkeypatch, tmp_path,
        lambda ext: [*_images(tmp_path, ext), "--rep_img",
                     str(tmp_path / f"rep.{ext}"),
                     "--out", str(tmp_path / f"overlay_{ext}.png")],
        **_fixed(corrs))
    warped, vmask = warps
    inside = vmask[..., 0] >= 1.0 - 1e-6
    assert inside.mean() > 0.3
    np.testing.assert_allclose(result["warped"][inside], warped[inside],
                               atol=1e-3)
    ours = np.array(PIL.Image.open(tmp_path / "overlay_npy.png"))
    theirs = np.array(PIL.Image.open(tmp_path / "overlay_png.png"))
    np.testing.assert_array_equal(ours, result["overlay"])
    assert np.abs(ours.astype(int) - theirs)[inside].max() <= 1
    np.testing.assert_array_equal(ours[vmask[..., 0] == 0],
                                  theirs[vmask[..., 0] == 0])


# ------------------------------------------------------ the bilinear gather

@pytest.mark.parametrize("zero_outside", [True, False])
def test_gather_bilinear_matches_jax(zero_outside):
    """The densify warp's sampler at the same coordinates, some outside the
    image, on a noise image in [0, 255]."""
    from cotr_tpu.ops.sampling import _gather_bilinear
    from cotr_tpu_torch.ops.sampling import gather_bilinear

    rng = np.random.RandomState(11)
    img = rng.uniform(0, 255, (50, 64, 3)).astype(np.float32)
    x = rng.uniform(-4, 68, (30, 40)).astype(np.float32)
    y = rng.uniform(-4, 54, (30, 40)).astype(np.float32)
    want = np.asarray(_gather_bilinear(img, x, y, zero_outside=zero_outside))
    got = gather_bilinear(torch.from_numpy(img), torch.from_numpy(x),
                          torch.from_numpy(y), zero_outside=zero_outside)
    assert (want == 0).any() == zero_outside
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


# ------------------------------------------------------- flags and pictures

_COMMON = {"load_weights_path", "dtype", "max_corrs", "batch_size",
           "faster_infer", "safe_area", "out"}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_flags_and_defaults_are_the_jax_demos(name, jax_demo, monkeypatch):
    mod = jax_demo(name)
    seen = {}

    class Stop(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen["args"] = _real_parse(self, args, namespace)
        raise Stop

    import argparse

    _real_parse = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(sys, "argv", [name + ".py"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Stop):
        mod.main()
    monkeypatch.undo()
    want = vars(seen["args"])
    got = vars(TWINS[name].parse_args([]))
    if name == "demo_reconstruction":
        want["max_corrs"] = 2048  # the JAX demo raises it after parsing
    assert _COMMON <= set(got)
    assert got == want


def test_default_weights_are_the_flagship_when_present():
    import argparse

    ap = argparse.ArgumentParser()
    demo_utils.add_common_args(ap)
    flagship = os.path.join(_ROOT, "checkpoints", "flagship.npz")
    assert demo_utils.FLAGSHIP == flagship
    assert ap.parse_args([]).load_weights_path == (
        flagship if os.path.exists(flagship) else None)


def test_an_absent_default_input_names_the_file(tmp_path):
    missing = str(tmp_path / "absent.npy")
    with pytest.raises(FileNotFoundError, match="absent.npy"):
        demo_utils.load_image(missing)
    assert demo_utils.SAMPLE_DIR.endswith(os.path.join("reference",
                                                       "sample_data"))


def test_random_weights_with_none(capsys):
    from types import SimpleNamespace

    from cotr_tpu_torch.inference.engine import FasterSparseEngine

    args = SimpleNamespace(load_weights_path="none", dtype="float32",
                           batch_size=8, faster_infer="yes", safe_area=0.5)
    engines = [demo_utils.build_engine(args, "tile", device="cpu")
               for _ in range(2)]
    assert isinstance(engines[0], FasterSparseEngine)
    assert "random initialization" in capsys.readouterr().out
    a, b = (e.runner.model.state_dict() for e in engines)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("shape", [(7, 9, 3), (5, 11)])
def test_png_round_trip(tmp_path, shape):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    demo_utils.write_png(path, img)
    with PIL.Image.open(path) as im:
        assert im.mode == ("RGB" if len(shape) == 3 else "L")
        np.testing.assert_array_equal(np.array(im), img)


def test_correspondence_picture(tmp_path):
    img_a = np.full((30, 40, 3), 50, np.uint8)
    img_b = np.full((24, 20, 3), 100, np.uint8)
    corrs = np.array([[5.0, 6, 10, 12], [30, 20, 2, 3]])
    path = str(tmp_path / "c.png")
    demo_utils.save_corr_visualization(img_a, img_b, corrs, path)
    pic = np.array(PIL.Image.open(path))
    assert pic.shape == (30, 60, 3)
    for x, y in [(5, 6), (30, 20), (50, 12), (42, 3)]:
        np.testing.assert_array_equal(pic[y, x], demo_utils.POINT_RGB)
    # a point halfway along the first line is blended towards the line's
    # colour; a pixel below B (which is shorter) stays black
    mid = pic[9, 27]
    assert mid[1] > 150 and mid[0] < 100
    np.testing.assert_array_equal(pic[28, 55], [0, 0, 0])
    bare = demo_utils.draw_correspondences(img_a, img_b, corrs, lines=False)
    np.testing.assert_array_equal(bare[:, :40], img_a)


#: the demos and the new tools, imported with JAX, the JAX package, PIL,
#: imageio and h5py blocked: the card's machine has none of them
_NEW_MODULES = ["cotr_tpu_torch.demos", "cotr_tpu_torch.demos.demo_utils",
                *(f"cotr_tpu_torch.demos.{name}" for name in sorted(TWINS)),
                "cotr_tpu_torch.tools.convert_checkpoint",
                "cotr_tpu_torch.tools.publish_flagship",
                "cotr_tpu_torch.tools.eval_suite",
                "cotr_tpu_torch.tools.diagnose_tail"]

_PICTURE_PROBE = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "cotr_tpu", "PIL", "imageio",
                                  "matplotlib"):
            raise ImportError("blocked for this test: " + name)
sys.meta_path.insert(0, Block())
import os, tempfile
import numpy as np
from cotr_tpu_torch.demos import demo_utils
d = tempfile.mkdtemp()
img = np.random.RandomState(0).randint(0, 256, (20, 30, 3)).astype(np.uint8)
np.save(os.path.join(d, "a.npy"), img)
back = demo_utils.load_image(os.path.join(d, "a.npy"))
demo_utils.save_corr_visualization(back, back, np.array([[1.0, 2, 3, 4]]),
                                   os.path.join(d, "c.png"))
print("picture", os.path.getsize(os.path.join(d, "c.png")) > 0)
"""


def test_new_modules_import_with_jax_and_image_libs_blocked():
    from tests.test_torch_imports import _run_blocked

    proc = _run_blocked(",".join(_NEW_MODULES), "--no-image-libs")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for module in _NEW_MODULES:
        assert f"imported {module}" in proc.stdout


def test_pictures_need_no_image_library():
    import subprocess

    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    site_dirs = [p for p in sys.path if p.endswith("-packages")]
    env["PYTHONPATH"] = os.pathsep.join([_ROOT] + site_dirs)
    proc = subprocess.run([sys.executable, "-S", "-c", _PICTURE_PROBE],
                          env=env, cwd=_ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "picture True" in proc.stdout
