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

* On a CUDA tensor it launches one of the two kernels of
  ``csrc/attention.cu``, built with ``nvcc`` for ``sm_90a`` into ``build/``
  at first use and bound with ctypes. :func:`choose_kernel` picks by Lq: the
  row kernel (threads split the keys of one query row) up to
  ``ROW_MAX_LQ`` rows, the tile kernel (both products on the tensor cores,
  logits and probabilities kept in registers) above. A shape, dtype or
  layout neither takes raises; nothing falls back.
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
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from cotr_tpu_torch.ops.dropout import dropout

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "attention.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
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
#: query rows a block of the tile kernel (16 a warp) by dtype: what was
#: faster on the H100 at the large main-path shapes, by about a tenth in
#: bfloat16 and by nothing in float32 (PERF.md)
TILE_ROWS = {torch.float32: 64, torch.bfloat16: 128}
_TILE_ROWS_BUILT = (64, 128)

#: kernel launches since the last reset (set it to 0 to start a count)
launches = 0
#: launches by (B, Lq, S, dtype name) since the last ``shape_counts.clear()``
shape_counts: collections.Counter = collections.Counter()

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "attention kernel cannot be built")


def build_library() -> Path:
    """Compile ``csrc/attention.cu`` for sm_90a into ``build/`` unless a
    library built from the same source is already there. Returns its path."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    out = _BUILD_DIR / f"libcotr_attention_{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
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


def flash_cross_attention_split_tf32_emulated(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The float32 tile kernel's products in plain PyTorch, for tests: each
    operand of q k^T and of p v is split into TF32 pieces ``hi`` and ``lo``,
    and ``lo*hi + hi*lo + hi*hi`` is summed in fp32. Nothing on any path
    calls it."""
    _check(q, k, v)
    if q.dtype != torch.float32:
        raise ValueError("the split-TF32 products are the float32 path")

    def product(eq, a, b):
        (a_hi, a_lo), (b_hi, b_lo) = _split_tf32(a), _split_tf32(b)
        return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
                + torch.einsum(eq, a_hi, b_hi))

    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = product("bqhd,bkhd->bhqk", q * scale, k)
    probs = torch.softmax(logits, dim=-1)
    return product("bhqk,bkhd->bqhd", probs, v)


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
