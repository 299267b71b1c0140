"""Encoder-decoder transformer for correspondence regression (counterpart of
cotr_tpu/models/transformer.py), inference only.

Kept from the JAX package:

* post-norm residual blocks with a ReLU FFN;
* positional embeddings added to Q and K at every layer, never to V;
* a decoder with cross-attention only (no query self-attention), whose
  target starts at zero: every query is independent;
* a final LayerNorm on the decoder output.

Layout is batch-major (B, L, D). Every attention goes through
``ops.attention.flash_cross_attention``: the hand-written kernel on the card,
its plain version on the CPU. The port serves; the dropout and key-padding
mask of the training path come with the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cotr_tpu_torch.models.layers import LayerNorm, Linear
from cotr_tpu_torch.ops.attention import flash_cross_attention


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, nheads: int):
        super().__init__()
        self.nheads = nheads
        self.q_proj = Linear(d_model, d_model)
        self.k_proj = Linear(d_model, d_model)
        self.v_proj = Linear(d_model, d_model)
        self.out_proj = Linear(d_model, d_model)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        b, lq, d = q.shape
        lk = k.shape[1]
        h = self.nheads
        qp = self.q_proj(q).reshape(b, lq, h, d // h)
        kp = self.k_proj(k).reshape(b, lk, h, d // h)
        vp = self.v_proj(v).reshape(b, lk, h, d // h)
        out = flash_cross_attention(qp, kp, vp)
        return self.out_proj(out.reshape(b, lq, d))


class FFN(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.relu(self.linear1(x)))


class EncoderLayer(nn.Module):
    """Self-attention layer; Q = K = src + pos, V = src."""

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nheads)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, dim_feedforward)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        qk = src + pos
        src = self.norm1(src + self.self_attn(qk, qk, src))
        return self.norm2(src + self.ffn(src))


class DecoderLayer(nn.Module):
    """Cross-attention-only decoder layer (norm names norm2/norm3 as in the
    reference, whose norm1 belonged to the removed self-attention)."""

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int):
        super().__init__()
        self.cross_attn = MultiHeadAttention(d_model, nheads)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, dim_feedforward)
        self.norm3 = LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                query_pos: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        attn = self.cross_attn(tgt + query_pos, memory + pos, memory)
        tgt = self.norm2(tgt + attn)
        return self.norm3(tgt + self.ffn(tgt))


class Transformer(nn.Module):
    """Encoder over the canvas tokens + decoder over independent queries.

    Layers are named ``enc{i}`` / ``dec{i}`` as in the JAX package so the
    weights carry across by name."""

    def __init__(self, d_model: int = 256, nheads: int = 8,
                 enc_layers: int = 6, dec_layers: int = 6,
                 dim_feedforward: int = 1024):
        super().__init__()
        self.enc_layers = enc_layers
        self.dec_layers = dec_layers
        for i in range(enc_layers):
            self.add_module(f"enc{i}",
                            EncoderLayer(d_model, nheads, dim_feedforward))
        for i in range(dec_layers):
            self.add_module(f"dec{i}",
                            DecoderLayer(d_model, nheads, dim_feedforward))
        self.decoder_norm = LayerNorm(d_model, eps=1e-5)

    def encode(self, src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        mem = src
        for i in range(self.enc_layers):
            mem = getattr(self, f"enc{i}")(mem, pos)
        return mem

    def decode(self, memory: torch.Tensor, pos: torch.Tensor,
               query_embed: torch.Tensor) -> torch.Tensor:
        """Returns the normed last decoder state (B, Q, d)."""
        tgt = torch.zeros_like(query_embed)
        for i in range(self.dec_layers):
            tgt = getattr(self, f"dec{i}")(tgt, memory, query_embed, pos)
        return self.decoder_norm(tgt)
