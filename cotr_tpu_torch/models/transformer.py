"""Encoder-decoder transformer for correspondence regression (counterpart of
cotr_tpu/models/transformer.py), for serving and for training.

Kept from the JAX package:

* post-norm residual blocks with a ReLU FFN;
* dropout on the attention probabilities, after the FFN's ReLU and on both
  residual branches of every layer, active in ``train()`` mode only;
* positional embeddings added to Q and K at every layer, never to V;
* a decoder with cross-attention only (no query self-attention), whose
  target starts at zero: every query is independent;
* a final LayerNorm on the decoder output;
* xavier-uniform initial values for every parameter of rank above 1
  (:func:`xavier_reset`).

Layout is batch-major (B, L, D). ``MultiHeadAttention.forward`` is the one
place that routes an attention: to ``ops.attention.flash_cross_attention``
(the hand-written kernels on the card, their plain version on the CPU) when
there is no key-padding mask, dropout is inactive and no gradient is wanted;
to the differentiable ``ops.attention.einsum_attention`` otherwise. That is
the JAX package's own rule: its kernel has no backward either.

Where the JAX modules take ``deterministic=`` and a dropout key, these read
the module's mode and take a ``torch.Generator`` for the keep masks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from cotr_tpu_torch.models.layers import LayerNorm, Linear
from cotr_tpu_torch.ops.attention import (einsum_attention,
                                          flash_cross_attention)
from cotr_tpu_torch.ops.dropout import dropout
from cotr_tpu_torch.parallel.tp import copy_to_model, row_parallel


class MultiHeadAttention(nn.Module):
    """Multi-head attention. Under tensor parallelism
    (``parallel.tp.shard_model``) the block holds ``nheads / tp_size`` of
    the heads: its q/k/v projections are column-parallel and its
    ``out_proj`` row-parallel over ``tp_group``."""

    def __init__(self, d_model: int, nheads: int, dropout: float = 0.0):
        super().__init__()
        self.nheads = nheads
        self.dropout = dropout
        self.q_proj = Linear(d_model, d_model)
        self.k_proj = Linear(d_model, d_model)
        self.v_proj = Linear(d_model, d_model)
        self.out_proj = Linear(d_model, d_model)
        self.tp_group = None
        self.tp_size = 1

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, lq, d = q.shape
        lk = k.shape[1]
        h = self.nheads // self.tp_size  # the heads this block holds
        hd = d // self.nheads
        if self.tp_group is not None:
            q, k, v = copy_to_model((q, k, v), self.tp_group)
        qp = self.q_proj(q).reshape(b, lq, h, hd)
        kp = self.k_proj(k).reshape(b, lk, h, hd)
        vp = self.v_proj(v).reshape(b, lk, h, hd)
        dropout_active = self.training and self.dropout > 0.0
        wants_grad = torch.is_grad_enabled() and (
            qp.requires_grad or kp.requires_grad or vp.requires_grad)
        if key_padding_mask is None and not dropout_active and not wants_grad:
            out = flash_cross_attention(qp, kp, vp)
        else:
            out = einsum_attention(qp, kp, vp, key_padding_mask, self.dropout,
                                   self.training, generator)
        out = out.reshape(b, lq, h * hd)
        if self.tp_group is not None:
            return row_parallel(self.out_proj, out, self.tp_group)
        return self.out_proj(out)


class FFN(nn.Module):
    """ReLU feed-forward block; under tensor parallelism ``linear1`` is
    column-parallel and ``linear2`` row-parallel over ``tp_group``."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.tp_group = None
        self.tp_size = 1

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.tp_group is not None:
            (x,) = copy_to_model((x,), self.tp_group)
        y = dropout(F.relu(self.linear1(x)), self.dropout, self.training,
                    generator)
        if self.tp_group is not None:
            return row_parallel(self.linear2, y, self.tp_group)
        return self.linear2(y)


class EncoderLayer(nn.Module):
    """Self-attention layer; Q = K = src + pos, V = src."""

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, nheads, dropout)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, dim_feedforward, dropout)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor, pos: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        qk = src + pos
        attn = self.self_attn(qk, qk, src, key_padding_mask, generator)
        attn = dropout(attn, self.dropout, self.training, generator)
        src = self.norm1(src + attn)
        ff = dropout(self.ffn(src, generator), self.dropout, self.training,
                     generator)
        return self.norm2(src + ff)


class DecoderLayer(nn.Module):
    """Cross-attention-only decoder layer (norm names norm2/norm3 as in the
    reference, whose norm1 belonged to the removed self-attention)."""

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.cross_attn = MultiHeadAttention(d_model, nheads, dropout)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, dim_feedforward, dropout)
        self.norm3 = LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                query_pos: torch.Tensor, pos: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        attn = self.cross_attn(tgt + query_pos, memory + pos, memory,
                               key_padding_mask, generator)
        attn = dropout(attn, self.dropout, self.training, generator)
        tgt = self.norm2(tgt + attn)
        ff = dropout(self.ffn(tgt, generator), self.dropout, self.training,
                     generator)
        return self.norm3(tgt + ff)


def _rematerialized(layer: nn.Module, generator: Optional[torch.Generator],
                    *args) -> torch.Tensor:
    """``layer(*args, generator)`` whose activations are recomputed in the
    backward pass. ``torch.utils.checkpoint`` replays only the global random
    state, so the generator's state at entry is kept here and set again for
    the recomputation: the second forward draws the first one's keep
    masks."""
    if generator is None:
        return torch.utils.checkpoint.checkpoint(
            layer, *args, None, use_reentrant=False)
    entry_state = generator.get_state()
    calls = 0

    def run(*inner):
        nonlocal calls
        calls += 1
        if calls == 1:
            return layer(*inner, generator)
        current = generator.get_state()
        generator.set_state(entry_state)
        try:
            return layer(*inner, generator)
        finally:
            generator.set_state(current)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


class Transformer(nn.Module):
    """Encoder over the canvas tokens + decoder over independent queries.

    Layers are named ``enc{i}`` / ``dec{i}`` as in the JAX package so the
    weights carry across by name. With ``remat`` every layer is recomputed
    in the backward pass (where a gradient is being recorded; a forward
    without one is unchanged)."""

    def __init__(self, d_model: int = 256, nheads: int = 8,
                 enc_layers: int = 6, dec_layers: int = 6,
                 dim_feedforward: int = 1024, dropout: float = 0.1,
                 remat: bool = False):
        super().__init__()
        self.enc_layers = enc_layers
        self.dec_layers = dec_layers
        self.remat = remat
        for i in range(enc_layers):
            self.add_module(f"enc{i}", EncoderLayer(
                d_model, nheads, dim_feedforward, dropout))
        for i in range(dec_layers):
            self.add_module(f"dec{i}", DecoderLayer(
                d_model, nheads, dim_feedforward, dropout))
        self.decoder_norm = LayerNorm(d_model, eps=1e-5)

    def _layer(self, layer: nn.Module, generator, *args) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return _rematerialized(layer, generator, *args)
        return layer(*args, generator)

    def encode(self, src: torch.Tensor, pos: torch.Tensor,
               key_padding_mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mem = src
        for i in range(self.enc_layers):
            mem = self._layer(getattr(self, f"enc{i}"), generator, mem, pos,
                              key_padding_mask)
        return mem

    def decode(self, memory: torch.Tensor, pos: torch.Tensor,
               query_embed: torch.Tensor,
               key_padding_mask: Optional[torch.Tensor] = None,
               return_intermediate: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The normed last decoder state (B, Q, d); with
        ``return_intermediate`` every layer's state through ``decoder_norm``,
        stacked (dec_layers, B, Q, d)."""
        tgt = torch.zeros_like(query_embed)
        intermediate = []
        for i in range(self.dec_layers):
            tgt = self._layer(getattr(self, f"dec{i}"), generator, tgt,
                              memory, query_embed, pos, key_padding_mask)
            if return_intermediate:
                intermediate.append(self.decoder_norm(tgt))
        if return_intermediate:
            return torch.stack(intermediate, dim=0)
        return self.decoder_norm(tgt)


def xavier_reset(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """Initial values as the JAX package draws them: xavier-uniform for every
    parameter of rank above 1, zeros for the biases, ones and zeros for the
    LayerNorms. ``generator`` is a CPU generator; the values are drawn on the
    CPU and copied to wherever the parameters live."""
    for sub in module.modules():
        if isinstance(sub, nn.LayerNorm):
            nn.init.ones_(sub.weight)
            nn.init.zeros_(sub.bias)
        elif isinstance(sub, (nn.Linear, nn.Conv2d)):
            fresh = torch.empty(sub.weight.shape)
            nn.init.xavier_uniform_(fresh, generator=generator)
            with torch.no_grad():
                sub.weight.copy_(fresh)
                if sub.bias is not None:
                    sub.bias.zero_()
