"""The port's TensorBoard helpers against cotr_tpu/training/tb.py, and the
Trainer's TensorBoard branch. ``draw_corrs`` is integer rasterisation of
float32 arithmetic on both sides: equal."""

import os

import numpy as np
import pytest

from cotr_tpu.training import tb as jax_tb
from cotr_tpu_torch.config import COTRConfig, TrainConfig
from cotr_tpu_torch.models.cotr import build_model
from cotr_tpu_torch.training import tb as port_tb
from cotr_tpu_torch.training.trainer import Trainer

from tests.test_torch_common import few_torch_threads  # noqa: F401
from tests.test_torch_trainer import TINY, _loader

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def test_draw_corrs_equals_jax():
    rng = np.random.RandomState(51)
    canvases = rng.uniform(-2, 2, (2, 256, 512, 3)).astype(np.float32)
    corrs = rng.uniform(0.02, 0.98, (2, 5, 4))
    want = jax_tb.draw_corrs(canvases, corrs, color=(0, 255, 0))
    got = port_tb.draw_corrs(canvases, corrs, color=(0, 255, 0))
    assert got.dtype == np.uint8 and got.shape == (2, 256, 512, 3)
    np.testing.assert_array_equal(got, want)
    x0, y0 = corrs[0, 0, :2]
    assert (got[0, int(y0 * 256), int(x0 * 512)] == [0, 255, 0]).all()


def test_datapack_accumulates():
    pack = port_tb.TensorboardDatapack()
    pack.set_iteration(7)
    pack.set_training(False)
    pack.add_scalar({"a": 1.0})
    pack.add_scalar({"b": 2.0})
    pack.add_histogram({"h": np.zeros(4)})
    pack.add_image({"i": np.zeros((2, 2, 3), np.uint8)})
    pack.add_text({"t": "x"})
    assert pack.iteration == 7 and pack.training is False
    assert set(pack.scalar) == {"a", "b"} and set(pack.histogram) == {"h"}
    assert set(pack.image) == {"i"} and pack.text == {"t": "x"}


def test_pusher_and_trainer_write_event_files(tmp_path):
    pytest.importorskip("tensorboardX")
    pack = port_tb.TensorboardDatapack()
    pack.add_scalar({"loss/x": 0.5})
    pack.add_image({"img": np.zeros((4, 4, 3), np.uint8)})
    pusher = port_tb.TensorboardPusher(str(tmp_path / "pushed"))
    pusher.push_to_tensorboard(pack)
    pusher.writer.close()
    assert any(f.startswith("events") for f in
               os.listdir(tmp_path / "pushed"))

    cfg = COTRConfig(**TINY)
    train_cfg = TrainConfig(batch_size=2, max_iter=2, valid_iter=2, tb_iter=1)
    trainer = Trainer(build_model(cfg), cfg, train_cfg, _loader(), _loader(),
                      out_dir=str(tmp_path / "run"), use_tensorboard=True,
                      device="cpu")
    trainer.initialize(seed=0)
    trainer.train()  # scalars and histograms each step, renderings at 2
    trainer._tb.close()
    events = [f for f in os.listdir(tmp_path / "run" / "tb")
              if f.startswith("events")]
    assert events
    size = os.path.getsize(tmp_path / "run" / "tb" / events[0])
    assert size > 100_000  # two 256 x 512 renderings went in
