"""The triage twins (cotr_tpu_torch/tools/triage_{dense,multipair,guided}.py)
against the JAX tools (tools/triage_*.py), each run whole on the identity
stub of tests/test_torch_common.py at a small size.

* triage_dense: the same report keys; the phase split names the port's own
  phases, timed inside a dense_flow call after each trial (the field
  resize and merge run on the device, where the JAX tool times PIL's
  resize and the merge on the host).
* triage_multipair: the same report keys and the same cost-centre call
  counts as the JAX tool at seed strides 1 and 4; the dispatch count equals
  the engine's own ``dispatch_count`` for the same calls.
* triage_guided: the same summary keys; the speedup over the reference's
  79 s is null on inputs other than the reference's.

The JAX tools set a compilation cache of their own and take their options
from ``sys.argv``; both are patched here."""

import json
import os
import sys

import jax
import numpy as np
import pytest

import cotr_tpu
import cotr_tpu.inference.runner as jax_runner_mod
import cotr_tpu.models.checkpoint_io as jax_ckpt_mod
import cotr_tpu.utils.profiling as jax_profiling
from cotr_tpu_torch.inference import dense
from cotr_tpu_torch.inference.engine import FasterSparseEngine
from cotr_tpu_torch.tools import triage_dense, triage_guided, triage_multipair
from cotr_tpu_torch.utils import profiling
from tests.test_torch_common import (JaxIdentityRunner, TorchIdentityRunner,
                                     smooth_image)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """The JAX tool's module, imported from tools/."""
    sys.path.insert(0, _ROOT)
    try:
        return __import__(f"tools.{name}", fromlist=["main"])
    finally:
        sys.path.remove(_ROOT)


@pytest.fixture
def jax_on_stub(monkeypatch):
    """The JAX tools' model, weights and runner replaced by the identity
    stub; their cache settings dropped."""
    monkeypatch.setattr(cotr_tpu, "build_model", lambda cfg: None)
    monkeypatch.setattr(jax_ckpt_mod, "load_params", lambda *a, **k: {})
    monkeypatch.setattr(jax_runner_mod, "ModelRunner",
                        lambda model, params: JaxIdentityRunner())
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)


def _run_jax(monkeypatch, capsys, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    _jax_tool(name).main()
    return capsys.readouterr().out


def test_triage_dense_reports_the_jax_tools_keys(monkeypatch, capsys,
                                                 jax_on_stub):
    argv = ["--trials", "3", "--side", "64"]
    want = json.loads(_run_jax(monkeypatch, capsys, "triage_dense", argv))
    monkeypatch.setattr(triage_dense, "flagship_runner",
                        lambda ckpt, dtype, device: TorchIdentityRunner())
    calls = []
    flow = dense.dense_flow
    monkeypatch.setattr(dense, "dense_flow",
                        lambda *a, **k: calls.append(1) or flow(*a, **k))
    got = triage_dense.main(argv, device="cpu")
    # the warm call, then each trial followed by a split call
    assert len(calls) == 1 + 2 * 3
    assert set(got) == set(want)
    assert got["trials"] == 3 and len(got["wall_s_all"]) == 3
    assert got["q_s_median"] > 0
    # the port's phases: the dense field is not fetched whole; the fields
    # are mapped, resized and merged on the device, and the merged ones
    # fetched
    assert set(want["phase_split_one_call_s"]) == {
        "canvas_build_upload", "device_pass", "fetch",
        "host_resize_per_side", "merge_per_side"}
    split = got["phase_split_one_call_s"]
    assert set(split) == {"canvas_build_upload", "device_pass",
                          "map_resize_merge_on_device", "fetch", "call_wall"}
    assert all(v >= 0 for v in split.values())
    assert split["call_wall"] >= split["device_pass"]
    # the split wrapped dense_flow's stages for its calls and put them back
    assert dense._frames_on_device.__name__ == "_frames_on_device"


@pytest.mark.parametrize("stride", [1, 4])
def test_triage_multipair_counts_the_jax_tools_calls(monkeypatch, capsys,
                                                     jax_on_stub, tmp_path,
                                                     stride):
    argv = ["--pairs", "3", "--queries", "8", "--side", "64", "--trials",
            "2", "--seed_stride", str(stride)]
    _run_jax(monkeypatch, capsys, "triage_multipair",
             argv + ["--out", str(tmp_path / "jax.json")])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    engines = []

    def stub_engine(args, device):
        engines.append(FasterSparseEngine(TorchIdentityRunner(), mode="tile",
                                          seed_stride=args.seed_stride))
        return engines[-1]

    monkeypatch.setattr(triage_multipair, "build_engine", stub_engine)
    got = triage_multipair.main(argv + ["--out", str(tmp_path / "t.json")],
                                device="cpu")
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == got
    assert set(got) == set(want)
    assert set(got["cost_centers_s_per_trial"]) == \
        set(want["cost_centers_s_per_trial"])
    assert got["calls_per_trial"] == want["calls_per_trial"]
    # every trial (and the warm call) dispatches the same work
    assert engines[0]._stepper.dispatch_count == \
        3 * got["calls_per_trial"]["dispatch_enqueue_s_calls"]
    assert got["calls_per_trial"]["dense_seed_s_calls"] == 1
    assert got["seed_stride"] == stride


def test_triage_guided_reports_the_jax_tools_keys(monkeypatch, capsys,
                                                  jax_on_stub, tmp_path):
    import PIL.Image

    rng = np.random.RandomState(4)
    img_a, img_b = smooth_image(rng, (96, 128)), smooth_image(rng, (96, 128))
    kpts = [np.stack([rng.uniform(8, 120, 12), rng.uniform(8, 88, 12)],
                     1).astype(np.float32) for _ in range(2)]
    by_stem = {"21526113_4379776807": (img_a, kpts[0]),
               "21126421_4537535153": (img_b, kpts[1])}
    probes = iter(np.linspace(1.0, 2.0, 200))
    real_load = np.load

    def fake_load(path, *a, **k):
        stem = os.path.basename(str(path)).split(".")[0]
        if str(path).endswith(".disk.kpts.npy") and stem in by_stem:
            return by_stem[stem][1]
        return real_load(path, *a, **k)

    monkeypatch.setattr(PIL.Image, "open", lambda path: PIL.Image.fromarray(
        by_stem[os.path.basename(path).split(".")[0]][0]))
    monkeypatch.setattr(np, "load", fake_load)
    monkeypatch.setattr(jax_profiling, "chained_op_time",
                        lambda fn, *a, iters: float(next(probes)))
    _run_jax(monkeypatch, capsys, "triage_guided",
             ["--rounds", "3", "--out", str(tmp_path / "jax.json")])
    monkeypatch.setattr(np, "load", real_load)
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)

    paths = []
    for name, array in [("a.npy", img_a), ("b.npy", img_b),
                        ("ka.npy", kpts[0]), ("kb.npy", kpts[1])]:
        paths.append(str(tmp_path / name))
        np.save(paths[-1], array)
    monkeypatch.setattr(triage_dense, "flagship_runner",
                        lambda ckpt, dtype, device: TorchIdentityRunner())
    monkeypatch.setattr(profiling, "chained_op_time",
                        lambda fn, *a, iters: float(next(probes)))
    got = triage_guided.main(
        ["--rounds", "3", "--out", str(tmp_path / "t.json"),
         "--img_a", paths[0], "--img_b", paths[1], "--kpts_a", paths[2],
         "--kpts_b", paths[3]], device="cpu")
    assert set(got) == set(want)
    assert set(got["multipair"]) == set(want["multipair"])
    assert set(got["rounds"][0]) == set(want["rounds"][0])
    assert len(got["rounds"]) == 3
    assert want["multipair"]["speedup_vs_ref_79s"] is not None
    assert got["multipair"]["speedup_vs_ref_79s"] is None
    assert "null" in got["reading"]
    assert got["corr_probe_vs_multipair"] is not None
