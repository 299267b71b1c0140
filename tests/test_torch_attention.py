"""The port's attention (ops/attention.py) vs the JAX package's Pallas
kernel run in interpret mode. The CUDA kernel itself is held against the
plain version on a card in tests/test_torch_attention_kernel.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cotr_tpu.ops.pallas_attention import flash_cross_attention as jax_attn
from cotr_tpu_torch.ops import attention

# f32: both sides compute exact fp32 products (reduction order differs);
# bf16: probabilities round to bf16 before the PV product on both sides, and
# outputs round to bf16 (ulp 2**-8 near 1)
_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(lq, b=2, h=4, hd=32, s=512, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, lq, h, hd).astype(np.float32),
            rng.randn(b, s, h, hd).astype(np.float32),
            rng.randn(b, s, h, hd).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq", [512, 600, 1])
def test_plain_matches_pallas_interpret(lq, dtype):
    q, k, v = _inputs(lq)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    want = jax_attn(jnp.asarray(q, jd), jnp.asarray(k, jd),
                    jnp.asarray(v, jd), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = attention.flash_cross_attention(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)))
    assert got.dtype == td and got.shape == (2, lq, 4, 32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=_TOL[dtype])


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs the plain version and launches nothing."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3))
    before = attention.launches
    out = attention.flash_cross_attention(q, k, v)
    assert attention.launches == before
    torch.testing.assert_close(
        out, attention.flash_cross_attention_plain(q, k, v), rtol=0, atol=0)


def test_plain_rejects_mismatched_shapes():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4))
    with pytest.raises(ValueError):
        attention.flash_cross_attention(q, k[:, :, :2], v)
