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
    counts = dict(attention.shape_counts)
    out = attention.flash_cross_attention(q, k, v)
    assert attention.launches == before
    assert dict(attention.shape_counts) == counts
    torch.testing.assert_close(
        out, attention.flash_cross_attention_plain(q, k, v), rtol=0, atol=0)


def test_plain_rejects_mismatched_shapes():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4))
    with pytest.raises(ValueError):
        attention.flash_cross_attention(q, k[:, :, :2], v)


# the float32 tile kernel's split-TF32 products, emulated on the CPU: the
# pieces hi and lo carry 21 of fp32's 24 mantissa bits between them and the
# dropped lo*lo term is 2**-22 of a product, so the result stays as close to
# exact fp32 products as their own summation order does
@pytest.mark.parametrize("lq", [512, 600])
def test_split_tf32_emulation_matches_plain(lq):
    q, k, v = (torch.from_numpy(x) for x in _inputs(lq))
    got = attention.flash_cross_attention_split_tf32_emulated(q, k, v)
    want = attention.flash_cross_attention_plain(q, k, v)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=_TOL["float32"])


@pytest.mark.parametrize("lq", [512, 600])
def test_split_tf32_emulation_matches_pallas_interpret(lq):
    q, k, v = _inputs(lq)
    want = np.asarray(jax_attn(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), interpret=True))
    got = attention.flash_cross_attention_split_tf32_emulated(
        *(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=_TOL["float32"])


def test_one_tf32_product_alone_misses_the_gate():
    """Why the split is there: hi*hi alone is three digits, not seven."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(512))
    hi = [attention._round_tf32(x) for x in (q, k, v)]
    err = (attention.flash_cross_attention_plain(*hi)
           - attention.flash_cross_attention_plain(q, k, v)).abs().max()
    assert err > 10 * _TOL["float32"]


def test_split_tf32_emulation_is_float32_only():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(4))
    with pytest.raises(ValueError):
        attention.flash_cross_attention_split_tf32_emulated(q, k, v)


def test_round_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([1.0, 1.0 + 0.25 * ulp, 1.0 + 0.5 * ulp,
                      1.0 + 0.75 * ulp, -1.0 - 0.5 * ulp, -1.0 - 0.25 * ulp,
                      0.0, 3.0e-3], dtype=torch.float32)
    got = attention._round_tf32(x)
    want = torch.tensor([1.0, 1.0, 1.0 + ulp, 1.0 + ulp, -1.0 - ulp, -1.0,
                         0.0, 0.0], dtype=torch.float32)
    assert torch.equal(got[:7], want[:7])
    assert abs(got[7].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    hi, lo = attention._split_tf32(x)
    assert (x - (hi + lo)).abs().max() <= 2.0 ** -22 * 1.5


_MANY_KEYS = 100_000  # beyond the row kernel's shared memory


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [128, 512, 520, _MANY_KEYS])
@pytest.mark.parametrize("lq", [1, 2, 3, 4, 15, 16, 17, 64, 65, 600])
def test_dispatch_rule(lq, s, dtype):
    """Few rows go to the row kernel as long as it can hold their logits;
    everything else to the tile kernel, which takes any S."""
    td = getattr(torch, dtype)
    few = lq <= attention.ROW_MAX_LQ and s <= attention.ROW_MAX_KEYS
    assert attention.choose_kernel(lq, s, td) == ("row" if few else "tile")
    assert attention.TILE_ROWS[td] in (64, 128)


@pytest.mark.parametrize("lq,s,dtype", [(1, 512, torch.float16),
                                        (64, 512, torch.float64),
                                        (0, 512, torch.float32),
                                        (64, 0, torch.float32)])
def test_dispatch_refuses(lq, s, dtype):
    with pytest.raises(ValueError):
        attention.choose_kernel(lq, s, dtype)


def test_dispatch_thresholds():
    f32 = torch.float32
    assert attention.ROW_MAX_LQ == 3
    assert attention.choose_kernel(1, 512, f32) == "row"  # refinement decode
    assert attention.choose_kernel(3, attention.ROW_MAX_KEYS, f32) == "row"
    assert attention.choose_kernel(1, attention.ROW_MAX_KEYS + 1, f32) \
        == "tile"
    assert attention.choose_kernel(4, 1, f32) == "tile"


# the bfloat16 tile kernel's order of operations (keys in chunks of 512, a
# warpgroup's slice of 256, one exp a logit up to 512 keys, two passes
# beyond), emulated on the CPU. Gate: the kernel's 2e-2. Measured: within
# 2**-10 of the plain version and of the Pallas kernel at every case below,
# one bf16 ulp of an output in [0.25, 0.5) where a probability rounded the
# other way; held to 2**-9
_BF16_EMULATED_TOL = 2.0 ** -9


def _bf16_case(lq, s):
    # the many-key case at one batch row and two heads keeps its logits small
    b, h = (1, 2) if s > 1000 else (2, 4)
    return _inputs(lq, b=b, h=h, s=s, seed=lq + s)


@pytest.mark.parametrize("s", [512, 520, 9000])
@pytest.mark.parametrize("lq", [512, 600, 65])
def test_bf16_emulation_matches_plain(lq, s):
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _bf16_case(lq, s))
    got = attention.flash_cross_attention_bf16_emulated(q, k, v)
    want = attention.flash_cross_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _TOL["bfloat16"]
    assert err <= _BF16_EMULATED_TOL


@pytest.mark.parametrize("s", [512, 520, 9000])
@pytest.mark.parametrize("lq", [512, 600, 65])
def test_bf16_emulation_matches_pallas_interpret(lq, s):
    q, k, v = _bf16_case(lq, s)
    want = jax_attn(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                    interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = attention.flash_cross_attention_bf16_emulated(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= _TOL["bfloat16"]
    assert err <= _BF16_EMULATED_TOL


def test_bf16_emulation_is_bfloat16_only():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4))
    with pytest.raises(ValueError):
        attention.flash_cross_attention_bf16_emulated(q, k, v)


# the float32 tile kernel's order of operations (chunks of 64 keys, an
# online softmax rescaled chunk by chunk, one sequence of chunks or the even
# and odd chunks merged, three split-TF32 products in two sums), emulated on
# the CPU. Gate: the kernel's 1e-5. Measured: within 7.8e-07 of the plain
# version and 6.5e-07 of the Pallas kernel at every case below; held to
# 2e-06
_F32_EMULATED_TOL = 2e-6


@pytest.mark.parametrize("tile_rows", [64, 128])
@pytest.mark.parametrize("s", [512, 520, 1729])
@pytest.mark.parametrize("lq", [512, 600, 65])
def test_f32_emulation_matches_plain(lq, s, tile_rows):
    q, k, v = (torch.from_numpy(x)
               for x in _inputs(lq, s=s, seed=lq + s))
    got = attention.flash_cross_attention_f32_emulated(q, k, v,
                                                       tile_rows=tile_rows)
    want = attention.flash_cross_attention_plain(q, k, v)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= _TOL["float32"]
    assert err <= _F32_EMULATED_TOL


@pytest.mark.parametrize("tile_rows", [64, 128])
@pytest.mark.parametrize("s", [512, 520, 1729])
@pytest.mark.parametrize("lq", [600, 65])
def test_f32_emulation_matches_pallas_interpret(lq, s, tile_rows):
    q, k, v = _inputs(lq, s=s, seed=lq + s)
    want = np.asarray(jax_attn(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), interpret=True))
    got = attention.flash_cross_attention_f32_emulated(
        *(torch.from_numpy(x) for x in (q, k, v)), tile_rows=tile_rows)
    err = np.abs(got.numpy() - want).max()
    assert err <= _TOL["float32"]
    assert err <= _F32_EMULATED_TOL


def test_f32_emulation_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4))
    with pytest.raises(ValueError):
        attention.flash_cross_attention_f32_emulated(
            *(x.to(torch.bfloat16) for x in (q, k, v)))
    with pytest.raises(ValueError):
        attention.flash_cross_attention_f32_emulated(q, k, v, tile_rows=32)


def test_f32_emulation_key_chunks():
    """One chunk (S up to 64, the second warpgroup's sequence empty at 64
    rows a step) and a last chunk of one key give the plain result too."""
    for s in (1, 64, 65):
        q, k, v = (torch.from_numpy(x) for x in _inputs(70, s=s, seed=s))
        want = attention.flash_cross_attention_plain(q, k, v)
        for tile_rows in (64, 128):
            got = attention.flash_cross_attention_f32_emulated(
                q, k, v, tile_rows=tile_rows)
            assert (got - want).abs().max().item() <= _F32_EMULATED_TOL
