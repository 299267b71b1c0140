"""The twins of tools/train_synthetic.py and tools/eval_synthetic_pair.py
on the CPU, and the small utilities they use (utils/misc, PhaseTimer,
zoom_ladder) against the JAX package's."""

import io
import os
import random
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from cotr_tpu.utils import misc as jax_misc
from cotr_tpu.utils.constants import zoom_ladder as jax_zoom_ladder
from cotr_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
from cotr_tpu_torch.inference.engine import FasterSparseEngine
from cotr_tpu_torch.ops.geometry_cv import apply_homography
from cotr_tpu_torch.tools import eval_synthetic_pair as eval_twin
from cotr_tpu_torch.tools import train_synthetic as train_twin
from cotr_tpu_torch.utils import misc
from cotr_tpu_torch.utils.constants import zoom_ladder
from cotr_tpu_torch.utils.profiling import PhaseTimer

from tests.test_torch_common import (TorchIdentityRunner,  # noqa: F401
                                     few_torch_threads, smooth_image)

# ------------------------------------------------------------- utilities


def test_fix_randomness_seeds_what_the_jax_package_seeds_and_torch():
    jax_misc.fix_randomness(5)
    want = (random.random(), np.random.rand())
    misc.fix_randomness(5)
    assert (random.random(), np.random.rand()) == want
    first = torch.rand(3)
    misc.fix_randomness(5)
    random.random(), np.random.rand()
    assert torch.equal(torch.rand(3), first)


@pytest.mark.parametrize("value", [None, [1.0, 2.0], [1.0, float("nan")]])
def test_has_nan_matches_jax(value):
    arr = None if value is None else np.array(value)
    assert misc.has_nan(arr) == jax_misc.has_nan(arr)
    if arr is not None:
        assert misc.has_nan(torch.tensor(arr)) == jax_misc.has_nan(arr)


def test_print_notification_and_confirm_match_jax(monkeypatch):
    outs = []
    for mod in (misc, jax_misc):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.print_notification(["a", "b"], "NOTE")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    answers = iter(["maybe", "Y"])
    monkeypatch.setattr("builtins.input", lambda prompt: next(answers))
    assert misc.confirm()


def test_phase_timer_reports_as_the_jax_one():
    timers = [PhaseTimer(), JaxPhaseTimer()]
    for t in timers:
        for name in ("a", "b", "a"):
            with t.phase(name):
                pass
        t.totals["a"], t.totals["b"] = 0.25, 0.5
    assert timers[0].report() == timers[1].report()
    assert timers[0].counts == {"a": 2, "b": 1}


@pytest.mark.parametrize("depth", [1, 2, 4, 6])
def test_zoom_ladder_matches_jax(depth):
    assert zoom_ladder(depth) == jax_zoom_ladder(depth)


def test_zoom_ladder_rejects_depth_zero():
    with pytest.raises(ValueError):
        zoom_ladder(0)


# ------------------------------------------------------------ train twin

def _textures(tmp_path, n=2):
    rng = np.random.RandomState(8)
    paths = []
    for i in range(n):
        path = tmp_path / f"tex{i}.npy"
        np.save(path, smooth_image(rng, (288, 320), cells=(24, 30)))
        paths.append(str(path))
    return paths


def _argv(tmp_path, steps, *extra):
    return ["--steps", str(steps), "--batch_size", "2", "--enc_layers", "1",
            "--dec_layers", "1", "--num_kp", "8", "--epoch_len", "6",
            "--workers", "2", "--valid_iter", "2", "--lr_backbone", "0",
            "--dtype", "float32", "--proc_textures", "1", "--tex_aug",
            "--textures", str(tmp_path / "tex*.npy"),
            "--out", str(tmp_path / "run"), *extra]


def test_train_twin_trains_checkpoints_and_resumes(tmp_path,
                                                   few_torch_threads):
    """Two steps from the real loader with a validation and the rolling
    checkpoint at step 2, then a resumed run (warm-started from the first
    run's final checkpoint, which the resume then overrides) to step 3."""
    _textures(tmp_path)
    first = train_twin.main(_argv(tmp_path, 2), device="cpu")
    ckpt_dir = tmp_path / "run" / "checkpoints"
    assert first["step"] == 2
    assert {"checkpoint.pt", "final.pt"} <= set(os.listdir(ckpt_dir))
    assert np.isfinite(first["before_px"] + first["after_px"]).all()

    saved = torch.load(ckpt_dir / "checkpoint.pt", weights_only=True)
    assert saved["step"] == 2
    second = train_twin.main(
        _argv(tmp_path, 3, "--resume", "--init_weights",
              str(ckpt_dir / "final.pt")), device="cpu")
    assert second["step"] == 3
    assert torch.load(ckpt_dir / "final.pt", weights_only=True)["step"] == 3


def test_train_twin_defaults_are_the_jax_tools():
    args = train_twin.parse_args([])
    assert (args.dtype, args.lr_backbone, args.dropout, args.device_warp,
            args.workers, args.steps, args.batch_size, args.valid_iter,
            args.lr_schedule, args.textures) == (
        "bfloat16", 1e-4, 0.0, True, 8, 2000, 24, 0, "constant", None)
    assert train_twin.parse_args(["--device_warp", "no"]).device_warp is False


def test_train_twin_datasets(tmp_path):
    paths = _textures(tmp_path)
    args = train_twin.parse_args(_argv(tmp_path, 2))
    assert train_twin.texture_paths(args.textures) == paths
    train_ds, val_ds = train_twin.build_datasets(args)
    assert (train_ds.seed, val_ds.seed) == (1, 777)
    assert len(val_ds) == 4 * args.batch_size
    assert len(train_ds.images) == len(paths) + 1
    assert set(train_ds[0]) == {"crop", "h_mat", "corrs", "queries",
                                "targets"}
    with pytest.raises(ValueError, match="nothing matches"):
        train_twin.texture_paths([str(tmp_path / "none*.npy")])


# ------------------------------------------------------------- eval twin

class IdentityRunner(TorchIdentityRunner):
    """Every query maps to itself on the other half, whatever the crops
    hold: the engine then answers every query with its own position."""

    def _decode(self, canvas, queries):
        q = self.as_tensor(queries)
        x = torch.where(q[..., 0] < 0.5, q[..., 0] + 0.5, q[..., 0] - 0.5)
        return torch.stack([x, q[..., 1]], -1)


def _engine():
    return FasterSparseEngine(IdentityRunner(), mode="tile", max_load=256)


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_twin_epe_is_the_warps_displacement(seed):
    img_a = smooth_image(np.random.RandomState(3), (160, 160))
    grid, jitter = 6, 0.15
    epe = eval_twin.eval_seed(_engine(), img_a, seed, jitter, grid,
                              zoom_ladder(3))
    h_mat, img_b = eval_twin.warp_for_seed(img_a, seed, jitter, "cpu")
    lin = np.linspace(16.0, 144.0, grid)
    gx, gy = np.meshgrid(lin, lin)
    queries = np.stack([gx.ravel(), gy.ravel()], axis=1)
    gt = apply_homography(h_mat, queries)
    ok = ((gt >= 0) & (gt <= 159)).all(axis=1)
    want = np.linalg.norm(gt[ok] - queries[ok], axis=1)
    np.testing.assert_allclose(epe, want, atol=1e-4, rtol=0)
    got_q, got_gt = eval_twin.query_grid(160, grid, h_mat)
    np.testing.assert_array_equal(got_q, queries[ok])
    np.testing.assert_array_equal(got_gt, gt[ok])
    assert img_b.dtype == np.uint8 and img_b.shape == img_a.shape


def test_eval_twin_warp_matches_the_jax_warp():
    """warp_for_seed draws the JAX tool's corners and warps with the port's
    warp_perspective: equal to the JAX package's warp of the same image
    and homography but for the last bit of a few pixels."""
    from cotr_tpu.ops.geometry_cv import warp_perspective

    img_a = smooth_image(np.random.RandomState(4), (96, 96))
    h_mat, img_b = eval_twin.warp_for_seed(img_a, 2, 0.15, "cpu")
    want = np.asarray(warp_perspective(img_a.astype(np.float32), h_mat,
                                       (96, 96))).astype(np.uint8)
    assert (img_b == want).mean() > 0.999
    assert np.abs(img_b.astype(int) - want).max() <= 1


def test_eval_twin_summary_and_overlay():
    img_a = smooth_image(np.random.RandomState(5), (128, 128))
    engine = _engine()
    stats = eval_twin.evaluate(engine, img_a, [0, 3], grid=5,
                               zoom_ins=zoom_ladder(2), image_name="gen")
    assert set(stats) == {"image", "side", "queries", "zoom_depth", "seeds",
                          "epe_mean_px", "epe_median_px", "epe_p90_px",
                          "epe_p95_px", "pck@1px", "pck@3px", "pck@5px",
                          "per_seed"}
    assert stats["side"] == 128 and stats["seeds"] == [0, 3]
    assert set(stats["per_seed"]) == {"0", "3"}
    rep = smooth_image(np.random.RandomState(6), (40, 60))
    overlay, corner_err = eval_twin.paint_overlay(engine, img_a, rep, 0,
                                                  0.15, zoom_ladder(2))
    h_mat, img_b = eval_twin.warp_for_seed(img_a, 0, 0.15, "cpu")
    region = np.array([[32.0, 32], [96, 32], [32, 96], [96, 96]])
    want = np.linalg.norm(apply_homography(h_mat, region) - region, axis=1)
    np.testing.assert_allclose(corner_err, want, atol=1e-4)
    assert overlay.shape == (128, 128, 3) and overlay.dtype == np.uint8
    assert (overlay != img_b).any()


def test_summarize_rounds_as_the_jax_tool():
    epe = np.array([0.5, 0.9, 2.0, 4.0, 7.123456])
    assert eval_twin.summarize(epe) == {
        "epe_mean_px": 2.9, "epe_median_px": 2.0, "epe_p90_px": 5.87,
        "epe_p95_px": 6.5, "pck@1px": 0.4, "pck@3px": 0.6, "pck@5px": 0.8}


def test_center_crop():
    img = np.arange(6 * 8 * 3).reshape(6, 8, 3).astype(np.uint8)
    crop = eval_twin.center_crop(img, 512)
    np.testing.assert_array_equal(crop, img[:, 1:7])
