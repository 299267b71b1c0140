"""tools/train_synthetic.py and its twin in the port, run end to end on the
same textures, weights and seeds: the held-out errors each prints before
and after a few steps agree.

The pieces (dataset, loader, train step, Trainer) have parity tests of
their own; this one holds where they meet: the held-out batch, the canvas
the held-out forward sees against the one the steps train on, the model's
mode after training, the loaders' order and the optimizer's first steps."""

import contextlib
import io
import os
import re
import runpy
from types import SimpleNamespace

import numpy as np
import PIL.Image
import pytest
import torch

from cotr_tpu.data import synthetic as jax_synthetic
from cotr_tpu_torch.config import COTRConfig
from cotr_tpu_torch.models.cotr import build_model, init_weights
from cotr_tpu_torch.models.torch_convert import port_to_torch_state_dict
from cotr_tpu_torch.tools import train_synthetic as train_twin

from tests.test_torch_common import smooth_image

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the tools' model at their full width (hidden 256, 8 heads) with one
#: encoder and one decoder layer
LAYERS = dict(enc_layers=1, dec_layers=1)
STEPS = 2
_HELD_OUT = re.compile(r"held-out corr error (BEFORE|AFTER):\s+mean "
                       r"([0-9.]+)px median ([0-9.]+)px")


def _argv(tmp_path, name):
    return ["--steps", str(STEPS), "--batch_size", "2", "--enc_layers", "1",
            "--dec_layers", "1", "--num_kp", "8", "--epoch_len", "8",
            "--workers", "2", "--dtype", "float32", "--proc_textures", "1",
            "--tex_aug", "--init_weights", str(tmp_path / "init.pth.tar"),
            "--out", str(tmp_path / name)]


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """{"jax": ..., "port": ...}: each tool's (mean, median) held-out error
    before and after, in px, as the JAX tool prints them (one decimal)."""
    tmp_path = tmp_path_factory.mktemp("twins")
    rng = np.random.RandomState(21)
    textures = []
    for i, hw in enumerate([(300, 320), (288, 300)]):
        path = tmp_path / f"tex{i}.png"
        PIL.Image.fromarray(smooth_image(rng, hw, cells=(24, 30))).save(path)
        textures.append(str(path))
    cfg = COTRConfig(**LAYERS)
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(5))
    torch.save({"model_state_dict": port_to_torch_state_dict(model, cfg)},
               tmp_path / "init.pth.tar")

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port = train_twin.main(_argv(tmp_path, "port") + [
            "--textures", *textures], device="cpu")
    finally:
        torch.set_num_threads(threads)

    # the JAX tool reads its default texture glob: point it at the same
    # files, as .jpg globbing would find them
    fake_glob = SimpleNamespace(
        glob=lambda pattern: textures if pattern.endswith("*.jpg") else [])
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("sys.argv", ["train_synthetic.py", *_argv(tmp_path, "jax")])
        mp.setattr(jax_synthetic, "glob", fake_glob)
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(_ROOT, "tools", "train_synthetic.py"),
                           run_name="__main__")
    out = buf.getvalue()
    printed = {m[0]: (float(m[1]), float(m[2]))
               for m in _HELD_OUT.findall(out)}
    assert set(printed) == {"BEFORE", "AFTER"}, out
    return dict(jax=(printed["BEFORE"], printed["AFTER"]),
                port=(port["before_px"], port["after_px"]))


@pytest.mark.parametrize("when", ["before", "after"])
def test_train_twin_heldout_error_matches_the_jax_tool(both_runs, when):
    """Before training, the same weights on the same held-out batch: equal
    but for the JAX tool's rounding to 0.1 px. After two steps of Adam at
    the tools' rate: within 0.2% besides (float32 rounding in the two
    packages' gradients, which Adam's first steps scale up to the rate)."""
    i = ("before", "after").index(when)
    want = np.array(both_runs["jax"][i])
    got = np.array(both_runs["port"][i])
    tol = 0.051 if when == "before" else 0.051 + 0.002 * want
    assert (np.abs(got - want) <= tol).all(), (when, got, want)


def test_train_twin_moves_the_heldout_error_as_the_jax_tool_does(both_runs):
    """The steps change the held-out error, in the same direction in both
    tools."""
    (jb, ja), (pb, pa) = both_runs["jax"], both_runs["port"]
    assert np.sign(ja[0] - jb[0]) == np.sign(pa[0] - pb[0]) != 0
    assert abs(ja[0] - jb[0]) > 0.5
