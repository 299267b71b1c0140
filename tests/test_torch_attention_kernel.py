"""The hand-written CUDA attention kernel vs its plain version, on a card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_kernel.py

(``--noconftest``: tests/conftest.py configures JAX.) Without a card every
test skips.
"""

import numpy as np
import pytest
import torch

from cotr_tpu_torch.ops import attention

# f32: exact fp32 products on both sides, reduction order differs;
# bf16: probabilities and outputs round to bf16 (ulp 2**-8 near 1)
_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(b, lq, h=8, hd=32, s=512, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, lq, h, hd).astype(np.float32),
            rng.randn(b, s, h, hd).astype(np.float32),
            rng.randn(b, s, h, hd).astype(np.float32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,lq", [(2, 512), (4, 8192), (256, 1), (2, 600)])
def test_kernel_matches_plain(card, b, lq, dtype):
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(card, td) for x in _inputs(b, lq))
    before = attention.launches
    got = attention.flash_cross_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention.flash_cross_attention_plain(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=_TOL[dtype])


@pytest.mark.cuda
def test_kernel_reads_strided_inputs(card):
    """q, k, v as views of wider projections (non-contiguous heads)."""
    q, k, v = (torch.from_numpy(x).to(card) for x in _inputs(2, 100))
    wide = torch.cat([q, q], dim=-1)[..., :32]  # row stride 2*hd
    got = attention.flash_cross_attention(wide, k, v)
    want = attention.flash_cross_attention_plain(q, k, v)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v = (torch.from_numpy(x).to(card) for x in _inputs(1, 4, hd=16))
    with pytest.raises(ValueError):
        attention.flash_cross_attention(q, k, v)  # head dim 16
    q, k, v = (torch.from_numpy(x).to(card, torch.float16)
               for x in _inputs(1, 4))
    with pytest.raises(ValueError):
        attention.flash_cross_attention(q, k, v)  # float16
