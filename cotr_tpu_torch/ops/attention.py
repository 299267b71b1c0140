"""Fused cross-attention: the hand-written Hopper kernel and its plain version.

Counterpart of ``cotr_tpu/ops/pallas_attention.py`` (``flash_cross_attention``
over the Pallas body ``_attn_kernel``). Every attention of the model goes
through :func:`flash_cross_attention`: the encoder self-attention (Lq = S =
512), the dense decode (Lq = 8,192 per chunk) and the refinement decode
(Lq = 1).

* On a CUDA tensor it launches ``csrc/attention.cu``, built with ``nvcc`` for
  ``sm_90a`` into ``build/`` at first use and bound with ctypes. A shape,
  dtype or layout the kernel does not take raises; nothing falls back.
* On a CPU tensor it runs :func:`flash_cross_attention_plain`, the same
  arithmetic written with einsum and softmax.

``launches`` counts kernel launches, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "attention.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 32  # d_model / nheads of every COTR configuration in use

#: kernel launches since the last reset (set it to 0 to start a count)
launches = 0

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
                              ctypes.c_void_p])
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global launches
    _check(q, k, v)
    b, lq, h, hd = q.shape
    s = k.shape[1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if hd != _HEAD_DIM:
        raise ValueError(f"attention kernel takes head dim {_HEAD_DIM}, "
                         f"got {hd}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension of q, k, v must be contiguous")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} beyond the launch grid")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # like the TPU kernel, this one has no backward
        raise RuntimeError("the attention kernel is forward-only; run it "
                           "under torch.no_grad() or inference_mode()")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().cotr_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, lq, s, h, hd, _DTYPES[q.dtype], strides,
            1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def flash_cross_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """q (B, Lq, H, hd); k, v (B, S, H, hd) -> (B, Lq, H, hd).

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version."""
    if q.is_cuda:
        return _launch(q, k, v)
    if q.device.type == "cpu":
        return flash_cross_attention_plain(q, k, v)
    raise ValueError(f"no attention path for device {q.device}")
