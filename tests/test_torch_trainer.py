"""The port's Trainer on the CPU: a stub loader of two batches, a tiny
``max_iter`` and ``valid_iter``; checkpoints, resume, the version gate and
``params.json``. The resumed run must equal the unbroken one bit for bit:
the same code on the same machine, with each step's dropout generator seeded
from (seed, step)."""

import os

import numpy as np
import pytest
import torch

from cotr_tpu_torch.config import (COTRConfig, TrainConfig,
                                   check_params_json, compact_name)
from cotr_tpu_torch.models.cotr import build_model
from cotr_tpu_torch.training.trainer import KEEP_KEYS, Trainer

from tests.test_torch_common import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

#: the smallest full-structure model, with dropout so that the generator
#: matters for the resume
TINY = dict(enc_layers=1, dec_layers=1, hidden_dim=64, nheads=2, dropout=0.1)


def _loader():
    rng = np.random.RandomState(41)
    batches = []
    for _ in range(2):
        batches.append(dict(
            image=rng.randint(0, 256, (2, 256, 512, 3)).astype(np.uint8),
            queries=rng.uniform(0.05, 0.45, (2, 4, 2)).astype(np.float32),
            targets=rng.uniform(0.55, 0.95, (2, 4, 2)).astype(np.float32),
            pair_name=["a", "b"]))  # a key the steps do not consume
    return lambda: iter(batches)


def _trainer(out_dir, max_iter, **kw):
    cfg = COTRConfig(**TINY)
    train_cfg = TrainConfig(batch_size=2, max_iter=max_iter, valid_iter=2,
                            lr_backbone=1e-5, **kw)
    trainer = Trainer(build_model(cfg), cfg, train_cfg, _loader(), _loader(),
                      out_dir=str(out_dir), use_tensorboard=False,
                      device="cpu")
    trainer.initialize(seed=0)
    return trainer


def _snapshot(trainer):
    opt = trainer.state.optimizer
    return dict(
        step=trainer.state.step,
        params={k: v.clone() for k, v in
                trainer.state.model.state_dict().items()},
        mu={k: v.clone() for k, v in opt.mu.items()},
        nu={k: v.clone() for k, v in opt.nu.items()},
        counters=[int(opt.count), int(opt.notfinite_count),
                  int(opt.total_notfinite), bool(opt.last_finite)])


def _assert_same(a, b):
    assert a["step"] == b["step"] and a["counters"] == b["counters"]
    for kind in ("params", "mu", "nu"):
        assert set(a[kind]) == set(b[kind])
        for k, v in a[kind].items():
            assert torch.equal(v, b[kind][k]), (kind, k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An unbroken run of 4 steps; a run of 3 steps (checkpoint at 2) that a
    fresh trainer resumes to 4."""
    unbroken = _trainer(tmp_path_factory.mktemp("unbroken"), 4)
    unbroken.train()
    broken_dir = tmp_path_factory.mktemp("broken")
    first = _trainer(broken_dir, 3)
    first.train()
    return unbroken, first, broken_dir


def test_steps_counted_and_rolling_checkpoint_written(runs):
    unbroken, first, broken_dir = runs
    assert unbroken.state.step == 4 and first.state.step == 3
    assert int(unbroken.state.optimizer.count) == 4
    assert os.path.exists(broken_dir / "checkpoints" / "checkpoint.pt")
    payload = torch.load(broken_dir / "checkpoints" / "checkpoint.pt",
                         weights_only=True)
    assert set(payload) == {"version", "step", "params", "opt_state"}
    assert payload["version"] == Trainer.CKPT_VERSION
    assert payload["step"] == 2  # saved at the validation of step 2
    assert all(not v.is_cuda for v in payload["params"].values())


def test_load_checkpoint_restores_step_parameters_moments_and_counters(
        runs, tmp_path):
    _, first, _ = runs
    trainer = _trainer(tmp_path, 3)
    # a non-finite step on the way, so the skip's counters are not all zero
    batch = dict(next(iter(_loader()())))
    batch["queries"] = np.full_like(batch["queries"], np.nan)
    for b in (next(iter(_loader()())), batch):
        trainer.state, metrics = trainer._train_step(
            trainer.state, trainer._batch(b), None)
    assert not np.isfinite(float(metrics["loss"]))
    want = _snapshot(trainer)
    assert want["counters"] == [1, 1, 1, False] and want["step"] == 2
    trainer.save_checkpoint("probe")

    fresh = _trainer(tmp_path, 3)
    assert fresh.load_checkpoint("missing") is False
    assert fresh.load_checkpoint("probe") is True
    _assert_same(_snapshot(fresh), want)


def test_resumed_run_equals_unbroken_run_bit_for_bit(runs):
    unbroken, _, broken_dir = runs
    resumed = _trainer(broken_dir, 4)
    resumed.train(resume=True)  # from the checkpoint at step 2
    _assert_same(_snapshot(resumed), _snapshot(unbroken))


def test_archive_checkpoint_every_ten_validations(tmp_path):
    cfg = COTRConfig(**TINY)
    train_cfg = TrainConfig(batch_size=2, max_iter=10, valid_iter=1)
    trainer = Trainer(build_model(cfg), cfg, train_cfg, _loader(), None,
                      out_dir=str(tmp_path), use_tensorboard=False,
                      device="cpu")
    trainer.initialize(seed=1)
    # the steps themselves are not what this test is about
    trainer._train_step = lambda state, batch, gen: (
        state._replace(step=state.step + 1),
        {"loss": torch.zeros(()), "cycle_loss": torch.zeros(())})
    assert np.isnan(trainer.validate())
    trainer.train()
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "checkpoint.pt", "ckpt_10.pt"]


def test_another_version_raises(runs, tmp_path):
    _, first, _ = runs
    trainer = _trainer(tmp_path, 3)
    trainer.save_checkpoint()
    path = tmp_path / "checkpoints" / "checkpoint.pt"
    payload = torch.load(path, weights_only=True)
    payload["version"] = Trainer.CKPT_VERSION + 1
    torch.save(payload, path)
    with pytest.raises(ValueError, match="layout version"):
        trainer.load_checkpoint()


def test_params_json_written_and_checked(tmp_path):
    trainer = _trainer(tmp_path, 3)
    path = os.path.join(tmp_path, "params.json")
    assert check_params_json(path, trainer.model_cfg, trainer.cfg) is True
    other = TrainConfig(batch_size=2, max_iter=3, valid_iter=2,
                        lr_backbone=1e-5, learning_rate=3e-4)
    assert check_params_json(path, trainer.model_cfg, other) is False
    assert compact_name(trainer.model_cfg, trainer.cfg) == (
        "model:cotr_resnet50_layer3_64_dset:megadepth_bs:2_pe:lin_sine"
        "_lrbackbone:1e-05")


def test_train_before_initialize_raises(tmp_path):
    cfg = COTRConfig(**TINY)
    trainer = Trainer(build_model(cfg), cfg, TrainConfig(), _loader(),
                      out_dir=str(tmp_path), use_tensorboard=False,
                      device="cpu")
    with pytest.raises(RuntimeError, match="initialize"):
        trainer.train()
    assert "image" in KEEP_KEYS and "pair_name" not in KEEP_KEYS
