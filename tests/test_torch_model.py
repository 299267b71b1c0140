"""The port's model vs the JAX package's on the same weights and inputs, and
the flagship weights carried across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cotr_tpu.models.checkpoint_io import _flatten, load_params
from cotr_tpu.models.resnet import StemConv
from cotr_tpu_torch.config import COTRConfig
from cotr_tpu_torch.models.checkpoint_io import (load_flagship, load_model,
                                                 load_state)
from cotr_tpu_torch.models.cotr import build_model
from tests.test_torch_common import random_canvas, small_models

FLAGSHIP = "checkpoints/flagship.npz"


@pytest.fixture(scope="module")
def models():
    return small_models()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(99)
    canvas = random_canvas(rng, 2)
    queries = rng.uniform(0.02, 0.98, (2, 5, 2)).astype(np.float32)
    return canvas, queries


def test_plain_stem_conv_equals_space_to_depth_stem():
    """The TPU's 4x4/s1 space-to-depth stem equals the plain 7x7/s2 conv
    over the same stored kernel."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 48, 3).astype(np.float32)
    stem = StemConv(64)
    variables = stem.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(stem.apply(variables, jnp.asarray(x)))
    kernel = np.asarray(variables["params"]["kernel"])  # (7, 7, 3, 64)
    got = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                   stride=2, padding=3).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_forward_matches_jax(models, inputs):
    jmodel, variables, tmodel = models
    canvas, queries = inputs
    want = np.asarray(jax.jit(jmodel.apply)(variables, canvas, queries))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(canvas), torch.from_numpy(queries))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_encode_matches_jax(models, inputs):
    jmodel, variables, tmodel = models
    canvas, _ = inputs
    want = np.asarray(jax.jit(
        lambda v, c: jmodel.apply(v, c, method="encode"))(variables, canvas))
    with torch.inference_mode():
        got = tmodel.encode(torch.from_numpy(canvas))
    assert got.shape == (2, 512, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_flagship_loads_bit_for_bit():
    """load_flagship (numpy alone) equals the JAX package's loader bit for
    bit, and the full-width model takes every key, with none left over."""
    flat = load_flagship(FLAGSHIP)
    ref = _flatten(jax.device_get(load_params(FLAGSHIP, None)))
    assert sorted(flat) == sorted(ref) and len(flat) == 417
    for k, v in ref.items():
        np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)
    model = load_model(FLAGSHIP, COTRConfig(), device="cpu")
    state = model.state_dict()
    np.testing.assert_array_equal(
        state["transformer.enc5.self_attn.q_proj.weight"].numpy(),
        flat["params/transformer/enc5/self_attn/q_proj/kernel"].T)


def test_loading_refuses_missing_and_extra_keys():
    flat = load_flagship(FLAGSHIP)
    missing = dict(flat)
    missing.pop("params/corr_embed/fc2/bias")
    with pytest.raises(KeyError):
        load_state(build_model(COTRConfig()), missing)
    # a 5-layer model leaves the 6th layers' weights over
    with pytest.raises(KeyError):
        load_state(build_model(COTRConfig(enc_layers=5)), flat)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        load_model(FLAGSHIP, COTRConfig())


def test_decode_chunked_pads_and_discards(models):
    """Chunked decode (pad to a multiple of the chunk, discard the padding)
    equals one decode over all queries."""
    from cotr_tpu_torch.inference.runner import ModelRunner

    _, _, tmodel = models
    runner = ModelRunner(tmodel, device="cpu", decode_chunk=7)
    rng = np.random.RandomState(5)
    memory = torch.from_numpy(rng.randn(2, 512, 64).astype(np.float32))
    queries = rng.uniform(0, 1, (2, 17, 2)).astype(np.float32)
    got = runner.decode_chunked(memory, queries)
    want = runner.decode(memory, queries)
    assert got.shape == (2, 17, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_bfloat16_model_runs_close_to_float32(models, inputs):
    """A bfloat16 config casts the float32 weights at use; the head stays
    float32. bf16 keeps ~3 significant digits through 2+2 layers."""
    _, variables, tmodel = models
    bf16 = build_model(COTRConfig(dtype="bfloat16", enc_layers=2,
                                  dec_layers=2, hidden_dim=64, nheads=2))
    bf16.load_state_dict(tmodel.state_dict())
    canvas, queries = inputs
    with torch.inference_mode():
        mem = bf16.encode(torch.from_numpy(canvas[:1]))
        out = bf16.decode(mem, torch.from_numpy(queries[:1]))
        ref = tmodel(torch.from_numpy(canvas[:1]),
                     torch.from_numpy(queries[:1]))
    assert mem.dtype == torch.bfloat16 and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=5e-2)
