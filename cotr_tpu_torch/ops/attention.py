"""Attention: the hand-written Hopper kernels, their plain version, and the
differentiable einsum path.

Counterpart of ``cotr_tpu/ops/pallas_attention.py`` (``flash_cross_attention``
over the Pallas body ``_attn_kernel``) and of the einsum branch of
``cotr_tpu/models/transformer.py``. Every forward-only attention of the model
without mask or dropout goes through :func:`flash_cross_attention`: the
encoder self-attention (Lq = S = 512), the dense decode (Lq = 8,192 per
chunk), the refinement decode (Lq = 1) and the evaluation step. A forward
that needs a gradient, a key-padding mask or dropout takes
:func:`einsum_attention`; ``MultiHeadAttention.forward`` chooses.

* On a CUDA tensor it launches one of the kernels of ``csrc/attention.cu``,
  built with ``nvcc`` for ``sm_90a`` into ``build/`` at first use and bound
  with ctypes. :func:`choose_kernel` picks by Lq: the row kernel (threads
  split the keys of one query row) up to ``ROW_MAX_LQ`` rows, the tile
  kernel above, both products on the tensor cores (wgmma): in bfloat16
  with a head's K and V in shared memory and one exponential a logit, in
  float32 as three split-TF32 products a logit, with K and V streamed
  through shared memory in chunks of ``F32_CHUNK_KEYS`` keys and an online
  softmax. A shape, dtype or layout none takes raises; nothing falls
  back.
* On a CPU tensor it runs :func:`flash_cross_attention_plain`, the same
  arithmetic written with einsum and softmax.

* :func:`einsum_attention` is plain PyTorch on either device. It is not the
  kernels' plain version: its logits are formed in the compute dtype, as the
  JAX package's einsum branch forms them, where the kernels keep them fp32.

``launches`` counts kernel launches and ``shape_counts`` counts them by
shape, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import math
import threading
from typing import Optional

import torch

from cotr_tpu_torch import native
from cotr_tpu_torch.ops.dropout import dropout

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 32  # d_model / nheads of every COTR configuration in use

#: the row kernel serves Lq up to this, the tile kernel above it. On the
#: H100 at a batch of 256 the two cross at Lq = 4 in float32 and at Lq = 2 in
#: bfloat16: a block of the tile kernel spends the same time on 1 row as on
#: 64, the row kernel's time grows with every row
ROW_MAX_LQ = 3
#: most keys the row kernel takes (its logits stay under 48 KB a block);
#: beyond, the tile kernel serves few rows too, the rest of its tile masked
ROW_MAX_KEYS = 8192
#: query rows a block of the tile kernel takes at a time, by dtype: what was
#: faster on the H100 at the large main-path shapes (PERF.md). One or two
#: wgmma tiles of 64 rows; in float32 at 64 the block's two computing
#: warpgroups share a tile's keys
TILE_ROWS = {torch.float32: 128, torch.bfloat16: 128}
_TILE_ROWS_BUILT = (64, 128)
#: keys a chunk of the float32 tile kernel: the unit of its ring in shared
#: memory, of its online softmax and of each p v chain on the tensor cores
F32_CHUNK_KEYS = 64
#: keys a block of the bfloat16 tile kernel holds in shared memory (S up to
#: this: one exponential a logit; beyond, two passes over chunks of this
#: many), keys of them each of its two warpgroups holds, and the half of
#: those whose q k^T it takes at a time
BF16_BLOCK_KEYS = 512
BF16_WARPGROUP_KEYS = 256
BF16_HALF_KEYS = 128

#: kernel launches since the last reset (set it to 0 to start a count)
launches = 0
#: launches by (B, Lq, S, dtype name) since the last ``shape_counts.clear()``
shape_counts: collections.Counter = collections.Counter()

_lib = None
_lib_lock = threading.Lock()


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build_cuda_library("attention")))
            fn = lib.cotr_flash_attention
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                              ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, L, H, hd)")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, hd):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")


def flash_cross_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: fp32 logits of the scaled
    queries, fp32 softmax, probabilities cast to v's dtype, fp32 PV product,
    output in q's dtype (``_attn_kernel``, pallas_attention.py:34-45)."""
    _check(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_padding_mask: Optional[torch.Tensor] = None,
                     dropout_p: float = 0.0, training: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """q (B, Lq, H, hd); k, v (B, S, H, hd) -> (B, Lq, H, hd), differentiable.

    Logits of the scaled queries in the compute dtype; ``key_padding_mask``
    (B, S), True for a padded key, filled with the dtype's most negative
    finite value (a row masked whole comes out uniform, not NaN); softmax in
    float32, cast back; dropout on the probabilities; product with v."""
    _check(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                    torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    probs = dropout(probs, dropout_p, training, generator)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits), to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x: torch.Tensor) -> tuple:
    hi = _round_tf32(x)
    return hi, _round_tf32(x - hi)


def _split_tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor,
                        apart: bool = False) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the float32 tile kernel forms it: each
    operand split into TF32 pieces ``hi`` and ``lo``, and ``lo*hi + hi*lo +
    hi*hi`` summed in fp32; ``apart``: ``lo*hi + hi*hi`` and ``hi*lo`` summed
    apart, then added."""
    (a_hi, a_lo), (b_hi, b_lo) = _split_tf32(a), _split_tf32(b)
    if apart:
        return ((torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_hi))
                + torch.einsum(eq, a_hi, b_lo))
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def flash_cross_attention_split_tf32_emulated(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The float32 tile kernel's products in plain PyTorch, for tests: each
    operand of q k^T and of p v is split into TF32 pieces ``hi`` and ``lo``,
    and ``lo*hi + hi*lo + hi*hi`` is summed in fp32; the softmax is the
    plain one. Nothing on any path calls it."""
    _check(q, k, v)
    if q.dtype != torch.float32:
        raise ValueError("the split-TF32 products are the float32 path")
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _split_tf32_product("bqhd,bkhd->bhqk", q * scale, k)
    probs = torch.softmax(logits, dim=-1)
    return _split_tf32_product("bhqk,bkhd->bqhd", probs, v)


def flash_cross_attention_f32_emulated(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        tile_rows: int = 128) -> torch.Tensor:
    """The float32 tile kernel's order of operations in plain PyTorch, for
    tests; nothing on any path calls it.

    Logits of the scaled queries as three split-TF32 products (lo*hi +
    hi*lo + hi*hi in one sum; p v's as lo*hi + hi*hi and hi*lo apart); the
    keys in chunks of ``F32_CHUNK_KEYS`` (past S: logit -inf, value 0),
    taken in one sequence (``tile_rows`` 128) or in two, the even and the
    odd chunks (``tile_rows`` 64, one a warpgroup). A sequence keeps each
    row's running maximum m, sum l and output o: at each chunk m rises to
    the chunk's, a = 2^((old m - m) c) with c = log2(e), e = 2^fma(logit,
    c, -m c) (one exponential a logit), l = fma(l, a, sum e) and o = fma(o,
    a, the chunk's split-TF32 product of e and v). One sequence ends as o *
    (1 / l); two meet as (o_0 f_0 + o_1 f_1) * (1 / (l_0 f_0 + l_1 f_1))
    with f_w = 2^((m_w - max m) c)."""
    _check(q, k, v)
    if q.dtype != torch.float32:
        raise ValueError("the emulation is of the float32 tile kernel")
    if tile_rows not in _TILE_ROWS_BUILT:
        raise ValueError(f"no tile kernel of {tile_rows} rows a block")
    b, lq, h, hd = q.shape
    s = k.shape[1]
    dev = q.device
    c = torch.tensor(math.log2(math.e), dtype=torch.float32, device=dev)
    chunks = -(-s // F32_CHUNK_KEYS)
    pad = chunks * F32_CHUNK_KEYS - s
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    x = torch.nn.functional.pad(
        _split_tf32_product("bqhd,bkhd->bhqk", q * scale.to(dev), k),
        (0, pad), value=-math.inf).view(b, h, lq, chunks, F32_CHUNK_KEYS)
    vs = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).view(
        b, chunks, F32_CHUNK_KEYS, h, hd)

    def fma(a, b_, c_):  # rounded once
        return (a.double() * b_.double() + c_.double()).float()

    states = []
    for seq in ([range(chunks)] if tile_rows == 128
                else [range(0, chunks, 2), range(1, chunks, 2)]):
        m = torch.full((b, h, lq), -math.inf, device=dev)
        l = torch.zeros((b, h, lq), device=dev)
        o = torch.zeros((b, h, lq, hd), device=dev)
        for ch in seq:
            m_new = torch.maximum(m, x[:, :, :, ch].amax(-1))
            a = torch.exp2((m - m_new) * c)
            e = torch.exp2(fma(x[:, :, :, ch], c, -(m_new * c)[..., None]))
            l = fma(l, a, e.sum(-1))
            o = fma(o, a[..., None], _split_tf32_product(
                "bhqk,bkhd->bhqd", e, vs[:, ch], apart=True))
            m = m_new
        states.append((m, l, o))
    if len(states) == 1:
        m, l, o = states[0]
        out = o * (1.0 / l)[..., None]
    else:
        (m0, l0, o0), (m1, l1, o1) = states
        mx = torch.maximum(m0, m1)
        f0, f1 = torch.exp2((m0 - mx) * c), torch.exp2((m1 - mx) * c)
        inv = 1.0 / (l0 * f0 + l1 * f1)
        out = (o0 * f0[..., None] + o1 * f1[..., None]) * inv[..., None]
    return out.permute(0, 2, 1, 3).contiguous()


def flash_cross_attention_bf16_emulated(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The bfloat16 tile kernel's order of operations in plain PyTorch, for
    tests; nothing on any path calls it.

    fp32 logits of the unscaled bf16 inputs; exponents ``fma(logit, c, -m *
    c)`` with c = scale * log2(e), through exp2. Up to ``BF16_BLOCK_KEYS``
    keys (one exp a logit): the keys in four halves of ``BF16_HALF_KEYS``,
    two a warpgroup, each half's exps against its own maximum m_h (0 where
    all its keys are past S) and their sum l_h; then the row's maximum m,
    g_h = 2^((m_h - m) c), the sum (l_0 g_0 + l_1 g_1) + (l_2 g_2 + l_3 g_3)
    and each half's probabilities ``e * (g_h * (1 / sum))``. Beyond: keys in
    chunks of ``BF16_BLOCK_KEYS``, each in slices of ``BF16_WARPGROUP_KEYS``,
    one a warpgroup; each warpgroup's maximum and sum over its slices of
    every chunk, the sum rescaled as the maximum grows, then combined; the
    exps taken again against the row's maximum, the probabilities ``e * (1 /
    sum)``. The probabilities rounded to bf16, each slice's product with v
    summed in fp32, the two warpgroups' outputs added, the result rounded to
    bf16."""
    _check(q, k, v)
    if q.dtype != torch.bfloat16:
        raise ValueError("the emulation is of the bfloat16 tile kernel")
    b, lq, h, hd = q.shape
    s = k.shape[1]
    dev = q.device
    c = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32, device=dev)
         * torch.tensor(math.log2(math.e), dtype=torch.float32, device=dev))
    chunks = -(-s // BF16_BLOCK_KEYS)
    wgs = BF16_BLOCK_KEYS // BF16_WARPGROUP_KEYS
    pad = chunks * BF16_BLOCK_KEYS - s
    # keys past S: logit -inf, value 0
    x = torch.nn.functional.pad(
        torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()), (0, pad),
        value=-math.inf).view(b, h, lq, chunks, wgs, BF16_WARPGROUP_KEYS)
    vs = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad)).view(
        b, chunks, wgs, BF16_WARPGROUP_KEYS, h, hd)

    def exp2(logits, m):  # 2^fma(logit, c, -m c), the fma rounded once
        mc = (m * c).double()
        return torch.exp2((logits.double() * c.double() - mc).float())

    if chunks == 1:
        halves = BF16_WARPGROUP_KEYS // BF16_HALF_KEYS
        xh = x.view(b, h, lq, wgs * halves, BF16_HALF_KEYS)
        m_h = xh.amax(-1)
        e = exp2(xh, torch.where(m_h == -math.inf, 0.0, m_h)[..., None])
        g = torch.exp2((m_h - m_h.amax(-1, keepdim=True)) * c)
        lg = e.sum(-1) * g
        total = (lg[..., 0] + lg[..., 1]) + (lg[..., 2] + lg[..., 3])
        factor = g * (1.0 / total)[..., None]
        p = (e * factor[..., None]).to(torch.bfloat16).float().view(x.shape)
    else:
        m_w = torch.full((b, h, lq, wgs), -math.inf, device=dev)
        l_w = torch.zeros((b, h, lq, wgs), device=dev)
        for ch in range(chunks):
            m_new = torch.maximum(m_w, x[:, :, :, ch].amax(-1))
            l_w = (l_w * torch.exp2((m_w - m_new) * c)
                   + exp2(x[:, :, :, ch], m_new[..., None]).sum(-1))
            m_w = m_new
        m_all = m_w.amax(-1)
        total = torch.zeros((b, h, lq), device=dev)
        for w in range(wgs):
            total = total + l_w[..., w] * torch.exp2(
                (m_w[..., w] - m_all) * c)
        e = exp2(x, m_all[..., None, None, None])
        inv = 1.0 / total
        p = (e * inv[..., None, None, None]).to(torch.bfloat16).float()
    o_w = torch.zeros((b, h, lq, wgs, hd), device=dev)
    for ch in range(chunks):
        o_w = o_w + torch.einsum("bhqwk,bwkhd->bhqwd", p[:, :, :, ch],
                                 vs[:, ch])
    out = o_w[..., 0, :]
    for w in range(1, wgs):
        out = out + o_w[..., w, :]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def choose_kernel(lq: int, s: int, dtype: torch.dtype) -> str:
    """Which kernel serves Lq query rows over S keys: ``"row"`` or
    ``"tile"``. Raises ValueError for what neither takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"attention kernels take float32 or bfloat16, "
                         f"got {dtype}")
    if lq < 1 or s < 1:
        raise ValueError(f"empty attention: Lq {lq}, S {s}")
    if lq <= ROW_MAX_LQ and s <= ROW_MAX_KEYS:
        return "row"
    return "tile"


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            tile_rows: int | None = None) -> torch.Tensor:
    global launches
    _check(q, k, v)
    b, lq, h, hd = q.shape
    s = k.shape[1]
    if hd != _HEAD_DIM:
        raise ValueError(f"attention kernels take head dim {_HEAD_DIM}, "
                         f"got {hd}")
    kernel = choose_kernel(lq, s, q.dtype)
    if tile_rows is None:
        tile_rows = 0 if kernel == "row" else TILE_ROWS[q.dtype]
    elif tile_rows not in _TILE_ROWS_BUILT:
        raise ValueError(f"no tile kernel of {tile_rows} rows a block")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension of q, k, v must be contiguous")
    vec = 16 // q.element_size()
    if any(t.data_ptr() % 16 or any(n % vec for n in t.stride()[:3])
           for t in (q, k, v)):
        raise ValueError("q, k, v must allow 16-byte loads: data pointers "
                         "aligned to 16 bytes, strides multiples of "
                         f"{vec} elements")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # like the TPU kernel, these have no backward
        raise RuntimeError("the attention kernels are forward-only: call "
                           "einsum_attention where a gradient is wanted, or "
                           "run them under torch.no_grad() or "
                           "inference_mode()")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().cotr_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, lq, s, h, hd, _DTYPES[q.dtype], strides,
            1.0 / math.sqrt(hd), tile_rows, stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    launches += 1
    shape_counts[(b, lq, s, str(q.dtype).removeprefix("torch."))] += 1
    return out


def flash_cross_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          tile_rows: int | None = None) -> torch.Tensor:
    """q (B, Lq, H, hd); k, v (B, S, H, hd) -> (B, Lq, H, hd).

    CUDA tensors go to a kernel (or raise); CPU tensors to the plain
    version. ``tile_rows`` (64 or 128) asks for the tile kernel with that
    many query rows a block whatever Lq is, for timing one choice against
    the other."""
    if q.is_cuda:
        return _launch(q, k, v, tile_rows)
    if q.device.type == "cpu":
        return flash_cross_attention_plain(q, k, v)
    raise ValueError(f"no attention path for device {q.device}")
