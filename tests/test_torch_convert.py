"""Weights across formats: reference-layout torch checkpoints into the port
and back, the port's state_dict into Flax's layout and back, and the port's
``.npz`` read by both packages. Renamings, transposes and one split: every
comparison is exact, but for the bfloat16 ``.npz`` (rounding to bfloat16,
2**-8 relative)."""

import json

import jax
import numpy as np
import pytest
import torch

from cotr_tpu import COTRConfig as JaxConfig
from cotr_tpu.models import checkpoint_io as jax_io
from cotr_tpu.models.torch_convert import flax_to_torch_state_dict
from cotr_tpu_torch.config import COTRConfig
from cotr_tpu_torch.models import checkpoint_io as port_io
from cotr_tpu_torch.models import torch_convert

from tests.test_torch_common import SMALL, small_models


@pytest.fixture(scope="module")
def weights():
    _, variables, tmodel = small_models()
    variables = jax.device_get(variables)
    reference = {k: torch.from_numpy(np.array(v)) for k, v in
                 flax_to_torch_state_dict(variables, JaxConfig(**SMALL))
                 .items()}
    want = port_io.params_from_flax(jax_io._flatten(variables))
    return variables, reference, want, tmodel


def _assert_equal_states(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_torch_checkpoint_equals_params_from_flax(weights, tmp_path,
                                                       wrapped):
    _, reference, want, _ = weights
    path = str(tmp_path / "checkpoint.pth.tar")
    torch.save({"model_state_dict": reference, "iteration": 3}
               if wrapped else reference, path)
    model = torch_convert.load_torch_checkpoint(path, COTRConfig(**SMALL),
                                                device="cpu")
    assert not model.training
    _assert_equal_states(model.state_dict(), want)


def test_module_prefix_and_stray_decoder_keys_are_accepted(weights):
    _, reference, want, _ = weights
    state = {"module." + k: v for k, v in reference.items()}
    state["module.transformer.decoder.layers.0.norm1.weight"] = torch.ones(64)
    state["module.transformer.decoder.layers.0.self_attn.in_proj_bias"] = \
        torch.zeros(192)
    got = torch_convert.torch_state_dict_to_port(state, COTRConfig(**SMALL))
    _assert_equal_states(got, want)


def test_a_missing_key_raises(weights):
    _, reference, _, _ = weights
    state = dict(reference)
    del state["transformer.encoder.layers.1.self_attn.in_proj_weight"]
    with pytest.raises(KeyError, match="in_proj_weight"):
        torch_convert.torch_state_dict_to_port(state, COTRConfig(**SMALL))


def test_port_to_torch_state_dict_inverts(weights):
    _, reference, want, tmodel = weights
    cfg = COTRConfig(**SMALL)
    for source in (tmodel, want):
        back = torch_convert.port_to_torch_state_dict(source, cfg)
        _assert_equal_states(back, reference)
    packed = back["transformer.decoder.layers.1.multihead_attn.in_proj_weight"]
    assert packed.shape == (192, 64)


def test_params_to_flax_inverts_params_from_flax(weights):
    variables, _, want, _ = weights
    flat = jax_io._flatten(variables)
    back = port_io.params_to_flax(want)
    assert list(back) == list(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_params_npz_is_read_by_both_packages(weights, tmp_path, dtype):
    variables, _, want, tmodel = weights
    path = str(tmp_path / "weights.npz")
    port_io.save_params_npz(tmodel, path, dtype=dtype)
    flat = jax_io._flatten(variables)

    def check(got):
        assert set(got) == set(flat)
        for k, v in flat.items():
            if dtype == "float32":
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], v, rtol=2.0 ** -8, atol=0,
                                           err_msg=k)

    check(jax_io._flatten(jax.device_get(
        jax_io.load_params(path, JaxConfig(**SMALL)))))
    check(port_io.load_flagship(path))
    model = port_io.load_model(path, COTRConfig(**SMALL), device="cpu")
    if dtype == "float32":
        _assert_equal_states(model.state_dict(), want)


def test_bfloat16_npz_equals_the_jax_writer(weights, tmp_path):
    """Both writers round to nearest even: the stored bit patterns agree."""
    variables, _, _, tmodel = weights
    ours, theirs = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    port_io.save_params_npz(tmodel.state_dict(), ours)
    jax_io.save_params_npz(variables, theirs)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            if k == "__bf16_keys__":  # a JSON list, in each writer's order
                assert sorted(json.loads(str(a[k]))) == \
                    sorted(json.loads(str(b[k])))
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
