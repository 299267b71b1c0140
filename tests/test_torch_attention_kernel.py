"""The hand-written CUDA attention kernels vs their plain version, on a card.

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

# f32: the plain version and the row kernel compute exact fp32 products in
# different orders of summation; the tile kernel splits every operand into
# two TF32 pieces and sums three tensor-core products, which drops the
# 2**-22 tail of each product (lo*lo and the rounding of lo), and takes
# exp2 from the special-function unit (2 ulp);
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
@pytest.mark.parametrize("b,lq", [(2, 512), (256, 512), (4, 8192), (256, 1),
                                  (2, 600),
                                  # the squad engine's: encoder, both member
                                  # paddings (257 leaves a tile of one row),
                                  # the small group
                                  (128, 512), (128, 64), (128, 257), (8, 64)])
def test_kernel_matches_plain(card, b, lq, dtype):
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(card, td) for x in _inputs(b, lq))
    before = attention.launches
    attention.shape_counts.clear()
    got = attention.flash_cross_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert dict(attention.shape_counts) == {(b, lq, 512, dtype): 1}
    want = attention.flash_cross_attention_plain(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [128, 520])
@pytest.mark.parametrize("lq", [2, 3, 4, 15, 16, 17, 64, 65])
def test_both_sides_of_the_threshold(card, lq, s, dtype):
    """The row kernel up to ROW_MAX_LQ rows, the tile kernel above, at key
    counts that are and are not whole key tiles."""
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(card, td)
               for x in _inputs(3, lq, s=s, seed=lq + s))
    got = attention.flash_cross_attention(q, k, v)
    torch.cuda.synchronize()
    want = attention.flash_cross_attention_plain(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_rows", [64, 128])
@pytest.mark.parametrize("lq", [1, 600])
def test_tile_heights_agree(card, lq, tile_rows, dtype):
    """An explicit height asks for the tile kernel, for one row too."""
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(card, td) for x in _inputs(2, lq))
    got = attention.flash_cross_attention(q, k, v, tile_rows=tile_rows)
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
    q, k, v = (torch.from_numpy(x).to(card) for x in _inputs(1, 64))
    with pytest.raises(ValueError):
        attention.flash_cross_attention(q, k, v, tile_rows=32)  # not built
    with pytest.raises(ValueError, match="16-byte"):
        attention.flash_cross_attention(
            torch.cat([q, q], -1)[..., 2:34], k, v)  # rows off 16 bytes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq,s", [(2, 9000), (40, 1729), (70, 50), (33, 3000)])
def test_any_number_of_keys(card, lq, s, dtype):
    """Past the row kernel's limit the tile kernel serves few rows too, and
    its key count need not be a whole tile."""
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(card, td)
               for x in _inputs(2, lq, s=s, seed=s))
    got = attention.flash_cross_attention(q, k, v)
    torch.cuda.synchronize()
    want = attention.flash_cross_attention_plain(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=_TOL[dtype])
