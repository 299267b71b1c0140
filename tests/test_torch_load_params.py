"""models/checkpoint_io.load_params: the dispatch by file kind of the JAX
package's ``load_params``, giving a state_dict for the port's model."""

import os

import jax
import numpy as np
import pytest
import torch

from cotr_tpu import COTRConfig as JaxConfig
from cotr_tpu.models.checkpoint_io import _flatten
from cotr_tpu.models.checkpoint_io import load_params as jax_load_params
from cotr_tpu_torch.config import COTRConfig, TrainConfig
from cotr_tpu_torch.models.checkpoint_io import (load_model, load_params,
                                                 params_from_flax)
from cotr_tpu_torch.models.cotr import build_model, init_weights
from cotr_tpu_torch.models.torch_convert import port_to_torch_state_dict
from cotr_tpu_torch.training.trainer import Trainer

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(_ROOT, "checkpoints", "flagship.npz")
TINY = dict(enc_layers=1, dec_layers=1, hidden_dim=64, nheads=2,
            dropout=0.0)


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], v), k


def test_flagship_npz_equals_the_jax_loader_carried_across():
    want = params_from_flax(_flatten(jax.device_get(
        jax_load_params(FLAGSHIP, JaxConfig()))))
    got = load_params(FLAGSHIP, COTRConfig())
    _assert_same_state(got, want)
    assert set(got) == set(build_model(COTRConfig()).state_dict())


def test_reference_pth_equals_the_jax_loader_carried_across(tmp_path):
    model = build_model(COTRConfig(**TINY))
    init_weights(model, torch.Generator().manual_seed(3))
    path = str(tmp_path / "checkpoint.pth.tar")
    torch.save({"model_state_dict": port_to_torch_state_dict(
        model, COTRConfig(**TINY))}, path)
    got = load_params(path, COTRConfig(**TINY))
    _assert_same_state(got, model.state_dict())
    want = params_from_flax(_flatten(jax.device_get(
        jax_load_params(path, JaxConfig(**TINY)))))
    _assert_same_state(got, want)


@pytest.fixture
def trainer_checkpoint(tmp_path):
    cfg = COTRConfig(**TINY)
    trainer = Trainer(build_model(cfg), cfg, TrainConfig(batch_size=2),
                      lambda: [], out_dir=str(tmp_path / "run"),
                      use_tensorboard=False, device="cpu")
    trainer.initialize(seed=4)
    trainer.save_checkpoint()
    return trainer, trainer._path("checkpoint")


def test_trainer_payload_round_trips(trainer_checkpoint):
    trainer, path = trainer_checkpoint
    want = trainer.state.model.state_dict()
    _assert_same_state(load_params(path, trainer.model_cfg), want)
    model = load_model(path, trainer.model_cfg, device="cpu")
    _assert_same_state(model.state_dict(), want)


def test_trainer_payload_of_another_version_raises(trainer_checkpoint,
                                                   tmp_path):
    _, path = trainer_checkpoint
    payload = torch.load(path, weights_only=True)
    payload["version"] = Trainer.CKPT_VERSION + 1
    stale = str(tmp_path / "stale.pt")
    torch.save(payload, stale)
    with pytest.raises(ValueError, match="layout version"):
        load_params(stale)
    bare = str(tmp_path / "bare.pt")
    torch.save(payload["params"], bare)
    with pytest.raises(ValueError, match="layout version -1"):
        load_params(bare)


def test_orbax_directory_and_unknown_files_raise(tmp_path):
    orbax_dir = tmp_path / "checkpoints" / "final"
    orbax_dir.mkdir(parents=True)
    with pytest.raises(ValueError, match=r"\.npz"):
        load_params(str(orbax_dir))
    other = tmp_path / "weights.bin"
    other.write_bytes(b"\0")
    with pytest.raises(ValueError, match="unrecognized"):
        load_params(str(other))


def test_load_model_checks_the_config(tmp_path):
    with pytest.raises(KeyError, match="do not match"):
        load_model(FLAGSHIP, COTRConfig(**TINY), device="cpu")
