"""Shared set-up for the port's parity tests (cotr_tpu_torch vs cotr_tpu),
plus a check that the two packages' small models carry the same weights.

Inputs are made with numpy from a seed; JAX parameters come from a PRNGKey
and are carried across with ``params_from_flax``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cotr_tpu import COTRConfig as JaxConfig
from cotr_tpu import build_model as jax_build_model
from cotr_tpu.models.checkpoint_io import _flatten
from cotr_tpu_torch.config import COTRConfig
from cotr_tpu_torch.models.checkpoint_io import load_state
from cotr_tpu_torch.models.cotr import build_model

#: small but full-structure model: ResNet-50 to layer3, 2+2 layers,
#: hidden 64 with 2 heads (head dim 32, as in the flagship)
SMALL = dict(enc_layers=2, dec_layers=2, hidden_dim=64, nheads=2,
             dropout=0.0)


def small_models(seed: int = 7):
    """(jax_model, jax_variables, port_model) sharing one set of weights."""
    jmodel = jax_build_model(JaxConfig(**SMALL))
    canvas = jnp.zeros((1, 256, 512, 3), jnp.float32)
    queries = jnp.zeros((1, 2, 2), jnp.float32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), canvas,
                                     queries)
    tmodel = build_model(COTRConfig(**SMALL))
    load_state(tmodel, _flatten(jax.device_get(variables)))
    return jmodel, variables, tmodel


def random_canvas(rng, b: int) -> np.ndarray:
    return rng.uniform(-1, 1, (b, 256, 512, 3)).astype(np.float32)


def smooth_image(rng, shape_hw, cells=(10, 15)) -> np.ndarray:
    """Smooth uint8 RGB image: a random coarse grid upsampled bilinearly."""
    small = rng.rand(*cells, 3)
    h, w = shape_hw
    ys = np.linspace(0, cells[0] - 1, h)
    xs = np.linspace(0, cells[1] - 1, w)
    y0 = np.minimum(ys.astype(int), cells[0] - 2)
    x0 = np.minimum(xs.astype(int), cells[1] - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    top = small[y0][:, x0] * (1 - fx) + small[y0][:, x0 + 1] * fx
    bot = small[y0 + 1][:, x0] * (1 - fx) + small[y0 + 1][:, x0 + 1] * fx
    return ((top * (1 - fy) + bot * fy) * 255).astype(np.uint8)


def _identity_decode(canvas, queries, xp, where, mean_abs):
    """The identity stub of tests/test_engine_modes.py: identity across the
    canvas halves when both halves hold the same content, else -1."""
    left, right = canvas[:, :, :256], canvas[:, :, 256:]
    same = mean_abs(left - right) < 0.5
    qx, qy = queries[..., 0], queries[..., 1]
    pred = xp.stack([where(qx < 0.5, qx + 0.5, qx - 0.5), qy], -1)
    return where(same[:, None, None], pred, xp.full_like(pred, -1.0))


class TorchIdentityRunner:
    """ModelRunner-shaped identity stub for the port (CPU). ``model`` has
    the ``encode`` / ``decode`` pair the squad stepper calls."""

    device = torch.device("cpu")
    decode_chunk = 16384

    def __init__(self):
        self.model = SimpleNamespace(cfg=None, encode=self.encode,
                                     decode=self._decode)

    def as_tensor(self, x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, dtype=torch.float32)

    def _decode(self, canvas, queries):
        return _identity_decode(
            self.as_tensor(canvas), self.as_tensor(queries), torch,
            torch.where, lambda d: d.abs().mean(dim=(1, 2, 3)))

    def encode(self, canvas):
        return self.as_tensor(canvas)

    def decode_chunked(self, memory, queries):
        return self._decode(memory, queries)

    def forward(self, canvas, queries):
        return self._decode(canvas, queries)


class JaxIdentityModel:
    """Flax-like .apply with the same identity stub (jit-traceable)."""

    cfg = None

    def apply(self, variables, *args, method=None):
        if method == "encode":
            return args[0]
        return _identity_decode(
            args[0], args[1], jnp, jnp.where,
            lambda d: jnp.mean(jnp.abs(d), axis=(1, 2, 3)))


class JaxIdentityRunner:
    def __init__(self):
        self.model = JaxIdentityModel()
        self.params = {}
        self.decode_chunk = 16384

    def encode(self, canvas):
        return jnp.asarray(canvas)

    def decode_chunked(self, memory, queries):
        return self.model.apply({}, memory, jnp.asarray(queries))

    def forward(self, canvas, queries):
        return self.model.apply({}, jnp.asarray(canvas),
                                jnp.asarray(queries))


def test_small_models_share_weights():
    """Every JAX parameter lands in the port's state_dict under the layout
    rules (HWIO -> OIHW, (in, out) -> (out, in), scale -> weight)."""
    _, variables, tmodel = small_models()
    state = tmodel.state_dict()
    flat = _flatten(jax.device_get(variables))
    assert len(flat) == len(state)
    k = np.asarray(flat["params/backbone/body/conv1/kernel"])
    np.testing.assert_array_equal(
        state["backbone.body.conv1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    d = np.asarray(flat["params/transformer/dec1/ffn/linear1/kernel"])
    np.testing.assert_array_equal(
        state["transformer.dec1.ffn.linear1.weight"].numpy(), d.T)
    s = np.asarray(flat["params/transformer/decoder_norm/scale"])
    np.testing.assert_array_equal(
        state["transformer.decoder_norm.weight"].numpy(), s)
