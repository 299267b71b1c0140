"""The twins of tools/eval_suite.py and tools/diagnose_tail.py against the
JAX tools, both run whole on the CPU with their engine swapped for a stub
that answers each query with itself: the EPE is then the warp's own
displacement, as in test_eval_twin_epe_is_the_warps_displacement.

The JAX tools read the reference's four real images; here they read
generated PNGs in their place (one smaller than ``--side``, to exercise the
resize, one larger), and the twins the same files through ``--textures``.
The textures must be equal bit for bit, the query grids exactly, the warped
images to one grey level (the packages' warps differ in the last bit of a
few samples) and the written JSONs to their rounding. diagnose_tail's stub
draws its zoom histories and filter verdicts from one seeded numpy stream,
so both tools classify the same rows.
"""

import contextlib
import importlib
import io
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import PIL.Image
import pytest
import torch

import cotr_tpu.inference.engine as jax_engine_mod
import cotr_tpu.models.checkpoint_io as jax_io
from cotr_tpu.data.synthetic import \
    make_procedural_texture as jax_procedural
from cotr_tpu.ops.geometry_cv import apply_homography as jax_apply
from cotr_tpu.ops.geometry_cv import homography_from_4pts as jax_h4
from cotr_tpu_torch.tools import diagnose_tail, eval_suite
from cotr_tpu_torch.tools import eval_synthetic_pair as eval_twin

from tests.test_torch_common import smooth_image

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 64


class IdentityEngine:
    """Answers every query with itself and keeps what it was given. With
    ``diagnostics`` it fills ``last_diag`` from its own seeded stream: a
    seed row and one row per zoom level around each query, and the filters'
    verdicts."""

    def __init__(self, *args, **kwargs):
        self.runner = SimpleNamespace(device=torch.device("cpu"))
        self.calls = []
        self.collect_diagnostics = False
        self.last_diag = None
        self.stream = np.random.RandomState(0)
        IdentityEngine.instances.append(self)

    def cotr_corr_multiscale(self, img_a, img_b, zoom_ins, converge_iters,
                             max_corrs, queries_a, force, cycle_select):
        q = np.asarray(queries_a, np.float64)
        self.calls.append(dict(img_a=np.array(img_a), img_b=np.array(img_b),
                               queries=q.copy(), zooms=list(zoom_ins)))
        if self.collect_diagnostics:
            spread = np.array([25.0] + [8.0 / (i + 1)
                                        for i in range(len(zoom_ins))])
            hist = q[None] + self.stream.standard_cauchy(
                (len(spread),) + q.shape) * spread[:, None, None]
            self.last_diag = {
                "history": hist,
                "kept_by_filters": self.stream.rand(len(q)) < 0.8,
                "selected": hist[-1] + self.stream.normal(0, 1, q.shape)}
        return np.concatenate([q, q], axis=1)


IdentityEngine.instances = []


@pytest.fixture
def textures(tmp_path):
    """Two generated PNGs: 48 x 56 (below the side: cropped to 48 and
    resized) and 80 x 96 (cropped to the side)."""
    paths = []
    for i, hw in enumerate([(48, 56), (80, 96)]):
        path = tmp_path / f"real_{i}.png"
        PIL.Image.fromarray(smooth_image(np.random.RandomState(i), hw)).save(
            path)
        paths.append(str(path))
    return paths


@pytest.fixture
def jax_tools(monkeypatch, textures):
    """The JAX tools imported as modules, their real images replaced by
    the generated ones and their engine and weights by the stub."""
    monkeypatch.syspath_prepend(_ROOT)
    suite = importlib.import_module("tools.eval_suite")
    tail = importlib.import_module("tools.diagnose_tail")
    for mod in (suite, tail):
        monkeypatch.setattr(mod, "REAL_EVAL_IMAGES", tuple(textures))
    monkeypatch.setattr(jax_engine_mod, "FasterSparseEngine", IdentityEngine)
    monkeypatch.setattr(jax_engine_mod, "SparseEngine", IdentityEngine)
    monkeypatch.setattr(jax_io, "load_params", lambda path, cfg: {})
    IdentityEngine.instances = []
    return suite, tail


def _run_jax(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["tool.py", *argv])
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main()
    return IdentityEngine.instances.pop()


def _run_port(mod, argv, monkeypatch):
    monkeypatch.setattr(mod, "build_engine",
                        lambda *args, **kwargs: _engine(mod, kwargs))
    with contextlib.redirect_stdout(io.StringIO()):
        result = mod.main(argv, device="cpu")
    return result, IdentityEngine.instances.pop()


def _engine(mod, kwargs):
    engine = IdentityEngine()
    engine.collect_diagnostics = mod is diagnose_tail
    return engine


def _assert_same_calls(port, jax):
    assert len(port.calls) == len(jax.calls) > 0
    for got, want in zip(port.calls, jax.calls):
        np.testing.assert_array_equal(got["img_a"], want["img_a"])
        np.testing.assert_array_equal(got["queries"], want["queries"])
        assert got["zooms"] == want["zooms"]
        diff = np.abs(got["img_b"].astype(int) - want["img_b"])
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99


def _argv(tmp_path, which, *extra):
    return ["--ckpt", str(tmp_path / "w.npz"), "--side", str(SIDE),
            "--grid", "5", "--seeds", "0,1", "--proc", "1",
            "--out", str(tmp_path / which), *extra]


def test_eval_suite_matches_the_jax_tool(jax_tools, textures, tmp_path,
                                         monkeypatch):
    suite, _ = jax_tools
    jax_engine = _run_jax(suite, _argv(tmp_path, "jax", "--bootstrap", "50"),
                          monkeypatch)
    stats, port_engine = _run_port(eval_suite, _argv(
        tmp_path, "port", "--bootstrap", "50", "--textures", *textures),
        monkeypatch)
    _assert_same_calls(port_engine, jax_engine)
    assert len(port_engine.calls) == 3 * 2  # 2 images + 1 procedural, 2 seeds
    with open(tmp_path / "jax" / "eval_suite.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "eval_suite.json") as f:
        got = json.load(f)
    assert got == stats
    assert got == want
    assert got["textures"] == ["real_0.png", "real_1.png", "proc_eval_0"]
    assert got["pooled"]["epe_median_px"] > 0.5  # the warp's displacement


def test_eval_suite_epe_is_the_warps_displacement(textures, monkeypatch,
                                                  tmp_path):
    """Each cell's EPE against the JAX package's homography and ground
    truth for the same seed, computed here as the JAX tool computes them."""
    epes = []
    real = eval_twin.eval_seed

    def recorded(*args, **kwargs):
        epes.append(real(*args, **kwargs))
        return epes[-1]

    monkeypatch.setattr(eval_twin, "eval_seed", recorded)
    _, engine = _run_port(eval_suite, _argv(
        tmp_path, "port", "--bootstrap", "10", "--textures", *textures),
        monkeypatch)
    for call, epe, seed in zip(engine.calls, epes, [0, 1] * 3):
        rng = np.random.RandomState(seed)
        s = float(SIDE - 1)
        corners = np.array([[0.0, 0], [s, 0], [s, s], [0, s]])
        h_mat = jax_h4(corners, corners + rng.uniform(-0.15, 0.15, (4, 2))
                       * s)
        lin = np.linspace(SIDE * 0.1, SIDE * 0.9, 5)
        gx, gy = np.meshgrid(lin, lin)
        queries = np.stack([gx.ravel(), gy.ravel()], axis=1)
        gt = jax_apply(h_mat, queries)
        ok = ((gt >= 0) & (gt <= SIDE - 1)).all(axis=1)
        np.testing.assert_array_equal(call["queries"], queries[ok])
        np.testing.assert_allclose(
            epe, np.linalg.norm(gt[ok] - queries[ok], axis=1), atol=1e-9)


def test_eval_suite_textures_equal_the_jax_tools(textures):
    """PIL's BILINEAR resize of the small image and the procedural stream,
    bit for bit."""
    got = eval_suite.load_textures(textures, SIDE, 2)
    small = np.array(PIL.Image.open(textures[0]).convert("RGB"))[:, 4:52]
    want_small = np.array(PIL.Image.fromarray(small).resize(
        (SIDE, SIDE), PIL.Image.BILINEAR))
    np.testing.assert_array_equal(got["real_0.png"], want_small)
    big = np.array(PIL.Image.open(textures[1]).convert("RGB"))
    np.testing.assert_array_equal(got["real_1.png"], big[8:72, 16:80])
    for i in range(2):
        rng = np.random.RandomState(
            (eval_suite.PROC_EVAL_SEED_BASE + i) % 2 ** 32)
        np.testing.assert_array_equal(got[f"proc_eval_{i}"],
                                      jax_procedural(rng, size=SIDE))


@pytest.mark.parametrize("extra", [[], ["--cycle_select"],
                                   ["--engine", "base", "--tail_px", "3"]])
def test_diagnose_tail_matches_the_jax_tool(jax_tools, textures, tmp_path,
                                           monkeypatch, extra):
    _, tail = jax_tools
    jax_engine = _run_jax(tail, _argv(tmp_path, "jax", *extra), monkeypatch)
    report, port_engine = _run_port(diagnose_tail, _argv(
        tmp_path, "port", "--textures", *textures, *extra), monkeypatch)
    _assert_same_calls(port_engine, jax_engine)
    with open(tmp_path / "jax" / "diagnose_tail.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "diagnose_tail.json") as f:
        got = json.load(f)
    assert got == report
    assert got == want
    assert len(got["classes"]) >= 3


def test_suite_flags_and_defaults_are_the_jax_tools(jax_tools, monkeypatch):
    """Each twin parses as its JAX tool does, ``--textures`` the one
    addition."""
    import argparse

    seen = []

    class Stop(Exception):
        pass

    real_parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen.append(vars(real_parse(self, args, namespace)))
        raise Stop

    for mod, twin in zip(jax_tools, (eval_suite, diagnose_tail)):
        for argv in (["--ckpt", "c"],
                     ["--ckpt", "c", "--cycle_select", "rescue"]):
            monkeypatch.setattr(sys, "argv", ["tool.py", *argv])
            monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                                capture)
            with pytest.raises(Stop):
                mod.main()
            monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                                real_parse)
            got = vars(twin.parse_args(argv))
            assert got.pop("textures") is None
            assert got == seen.pop()
