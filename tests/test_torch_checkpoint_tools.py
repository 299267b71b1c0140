"""The twins of tools/convert_checkpoint.py and tools/publish_flagship.py on
the CPU, against the JAX package's loaders and tool.

convert: the flagship written in the reference's ``.pth.tar`` layout and
converted; the JAX package reads the ``.npz`` it writes as it reads the
``.pth.tar``, exactly, and ``--verify`` (the port's forward from both
files) passes. publish: the JAX tool and the twin on the same weight file
write equal arrays and equal provenance but for the source path.
"""

import contextlib
import io
import json
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from cotr_tpu import COTRConfig as JaxConfig
from cotr_tpu.models import checkpoint_io as jax_io
from cotr_tpu.models.torch_convert import \
    load_torch_checkpoint as jax_load_torch
from cotr_tpu_torch.config import COTRConfig
from cotr_tpu_torch.models import checkpoint_io as port_io
from cotr_tpu_torch.models.torch_convert import port_to_torch_state_dict
from cotr_tpu_torch.tools import convert_checkpoint, publish_flagship

from tests.test_torch_common import small_models

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(_ROOT, "checkpoints", "flagship.npz")


@pytest.fixture(scope="module")
def flagship_pth(tmp_path_factory):
    """The flagship in the reference trainer's ``.pth.tar`` wrapper."""
    path = tmp_path_factory.mktemp("pth") / "checkpoint.pth.tar"
    state = port_io.load_params(FLAGSHIP, COTRConfig())
    torch.save({"model_state_dict": port_to_torch_state_dict(
        state, COTRConfig()), "iteration": 0}, path)
    return str(path)


@pytest.fixture(scope="module")
def converted(flagship_pth, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("npz") / "converted.npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = convert_checkpoint.main(
            ["--torch", flagship_pth, "--out", out, "--verify"],
            device="cpu")
    return out, result, buf.getvalue()


def test_convert_writes_what_the_jax_package_reads_from_the_pth(
        flagship_pth, converted):
    out, result, _ = converted
    want = jax_io._flatten(jax.device_get(
        jax_load_torch(flagship_pth, JaxConfig())))
    got = jax_io._flatten(jax.device_get(jax_io.load_params(out,
                                                            JaxConfig())))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)
    assert result["parameters"] == sum(np.asarray(v).size
                                       for v in want.values())


def test_convert_stores_float32_and_verify_passes(flagship_pth, converted):
    out, result, printed = converted
    with np.load(out) as data:
        assert json.loads(str(data["__bf16_keys__"])) == []
        assert all(data[k].dtype == np.float32 for k in data.files
                   if k != "__bf16_keys__")
    assert result["max_abs_dev"] == 0.0
    np.testing.assert_array_equal(result["from_pth"], result["from_npz"])
    assert result["from_pth"].shape == (1, 8, 2)
    assert np.isfinite(result["from_pth"]).all()
    assert f"converted {result['parameters']:,} parameters" in printed
    assert "max deviation of the forward from the .npz: 0.000e+00" in printed


def test_convert_verify_raises_when_the_npz_differs(flagship_pth, tmp_path,
                                                   monkeypatch):
    """A writer that moves one weight must fail the check, not pass it."""
    real = port_io.save_params_npz

    def lossy(model, path, dtype="float32"):
        state = {k: v.clone() for k, v in model.state_dict().items()}
        state["corr_embed.fc2.bias"] += 1e-3
        real(state, path, dtype=dtype)

    monkeypatch.setattr(convert_checkpoint, "save_params_npz", lossy)
    with pytest.raises(AssertionError, match="differs"):
        convert_checkpoint.main(["--torch", flagship_pth, "--out",
                                 str(tmp_path / "x.npz"), "--verify"],
                                device="cpu")


def test_convert_flags_are_the_jax_tools():
    args = convert_checkpoint.parse_args(["--torch", "a", "--out", "b"])
    assert vars(args) == {"torch_path": "a", "out": "b", "verify": False}
    with pytest.raises(SystemExit):
        convert_checkpoint.parse_args(["--out", "b"])


# ------------------------------------------------------------ publish

@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A training run's layout: params.json two levels above the weights,
    and two eval JSONs."""
    root = tmp_path_factory.mktemp("run")
    (root / "checkpoints").mkdir()
    _, _, tmodel = small_models()
    port_io.save_params_npz(tmodel, str(root / "checkpoints" / "final.npz"),
                            dtype="float32")
    with open(root / "params.json", "w") as f:
        json.dump({"model": {"enc_layers": 2}, "train": {"seed": 1}}, f)
    for name in ("a", "b"):
        with open(root / f"eval_{name}.json", "w") as f:
            json.dump({"image": f"{name}.jpg", "epe_median_px": 1.5}, f)
    return root


def _publish_argv(root, out):
    return ["--ckpt", str(root / "checkpoints" / "final.npz"),
            "--eval_json", str(root / "eval_a.json"),
            "--eval_json", str(root / "eval_b.json"),
            "--eval_json", str(root / "absent.json"),
            "--note", "two steps", "--out", str(out)]


def test_publish_matches_the_jax_tool(run_dir, tmp_path, monkeypatch):
    port_out, jax_out = tmp_path / "port" / "w.npz", tmp_path / "jax" / "w.npz"
    meta = publish_flagship.main(_publish_argv(run_dir, port_out))
    monkeypatch.setattr(sys, "argv", ["publish_flagship.py",
                                      *_publish_argv(run_dir, jax_out)])
    with contextlib.redirect_stdout(io.StringIO()):
        runpy.run_path(os.path.join(_ROOT, "tools", "publish_flagship.py"),
                       run_name="__main__")
    with np.load(port_out) as ours, np.load(jax_out) as theirs:
        assert set(ours.files) == set(theirs.files)
        assert set(json.loads(str(ours["__bf16_keys__"]))) == set(
            json.loads(str(theirs["__bf16_keys__"])))
        for k in ours.files:
            if k != "__bf16_keys__":
                np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    with open(tmp_path / "port" / "w.json") as f:
        port_meta = json.load(f)
    with open(tmp_path / "jax" / "w.json") as f:
        jax_meta = json.load(f)
    assert port_meta == meta
    assert port_meta.pop("source") == jax_meta.pop("source")
    assert port_meta == jax_meta
    assert set(port_meta["eval"]) == {"a.jpg", "b.jpg"}
    assert port_meta["training"]["train"]["seed"] == 1


def test_publish_reads_a_trainer_checkpoint(tmp_path):
    """A port ``Trainer`` ``.pt`` as the JAX tool reads an Orbax payload;
    the weights round to bfloat16 and read back through ``load_params``."""
    from cotr_tpu_torch.training.trainer import Trainer

    _, _, tmodel = small_models()
    ckpt = tmp_path / "run" / "checkpoints"
    ckpt.mkdir(parents=True)
    torch.save({"version": Trainer.CKPT_VERSION, "step": 3,
                "params": tmodel.state_dict(), "opt_state": {}},
               ckpt / "checkpoint.pt")
    out = tmp_path / "flagship.npz"
    meta = publish_flagship.main(["--ckpt", str(ckpt / "checkpoint.pt"),
                                  "--out", str(out)])
    assert meta["format"] == "npz-bf16" and "training" not in meta
    got = port_io.load_params(str(out))
    for k, v in tmodel.state_dict().items():
        torch.testing.assert_close(got[k], v.float(), rtol=2.0 ** -8,
                                   atol=0)


def test_publish_defaults_are_the_jax_tools():
    args = publish_flagship.parse_args(["--ckpt", "c"])
    assert (args.out, args.eval_json, args.note) == (
        "checkpoints/flagship.npz", None, None)
