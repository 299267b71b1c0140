"""COTR in plain PyTorch: the benchmark's reference of the model.

Written from the published architecture (Jiang et al., "COTR:
Correspondence Transformer for Matching Across Images", ICCV 2021, arXiv
2103.14167; upstream ubc-vision/COTR) and the weight file's names:

* the (256, 512) canvas, ImageNet-normalized, split in its two 256-square
  halves, each through ResNet-50 to layer3 with frozen batch norm
  (bottleneck v1.5: the stride on the 3x3 convolution), the two feature
  maps joined along width: (B, 1024, 16, 32);
* a 1x1 projection to d = 256 and the 512 tokens row-major, with a sine
  map of the feature grid's pixel centers added to queries and keys at
  every layer;
* 6 post-norm encoder layers (8 heads, ReLU FFN 1024) and 6 decoder layers
  of cross-attention alone over queries that start at zero, their sine
  embedding added to the attention's queries; a final LayerNorm;
* a 3-layer MLP head giving (x, y) in canvas coordinates.

Nothing here uses a fused kernel: attention is two einsums and a softmax,
in float32. ``quant`` stands for a lower precision (the control of the
benchmark's comparison): it is applied to both operands of every
convolution and matrix product. ``dropout`` and a ``generator`` give the
training forward; its keep masks are drawn in the layers' order.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

MAX_SIZE = 256
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2))  # width, blocks, stride
D_MODEL, NHEADS, ENC_LAYERS, DEC_LAYERS = 256, 8, 6, 6
DEC_CHUNK = 8192


def normalize(canvas01: torch.Tensor) -> torch.Tensor:
    """[0, 1] canvas (..., 3) -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=canvas01.dtype,
                        device=canvas01.device)
    std = torch.tensor(IMAGENET_STD, dtype=canvas01.dtype,
                       device=canvas01.device)
    return (canvas01 - mean) / std


def sine_map(h: int, w: int, d: int = D_MODEL) -> np.ndarray:
    """(h*w, d) float32: pixel centers (j + 0.5) / w, (i + 0.5) / h through
    sin / cos of k * pi * coordinate, k = 1 .. d/4."""
    eps = 1e-6
    ys = (np.arange(h) + 0.5) / (h + eps)
    xs = (np.arange(w) + 0.5) / (w + eps)
    gx, gy = np.meshgrid(xs, ys)
    coords = np.stack([gx, gy], -1)
    bases = np.arange(1, d // 4 + 1, dtype=np.float64)
    ang = coords[..., None, :] * (bases[:, None] * np.pi)
    pos = np.concatenate([np.sin(ang).reshape(h, w, -1),
                          np.cos(ang).reshape(h, w, -1)], -1)
    return pos.reshape(h * w, d).astype(np.float32)


def query_embedding(q: torch.Tensor, d: int = D_MODEL) -> torch.Tensor:
    """(..., 2) float32 queries -> (..., d): sines then cosines of
    k * pi * coordinate, k = 1 .. d/4, coordinates inner."""
    bases = torch.arange(1, d // 4 + 1, dtype=torch.float32,
                         device=q.device)
    ang = q[..., None, :] * (bases[:, None] * math.pi)
    flat = (*q.shape[:-1], -1)
    return torch.cat([torch.sin(ang).reshape(flat),
                      torch.cos(ang).reshape(flat)], -1)


class PlainCOTR:
    """The model over a dict of float32 tensors keyed by Flax path
    (``reference.weights.to_device``)."""

    def __init__(self, w: Dict[str, torch.Tensor],
                 quant: Optional[Callable] = None, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 enc_layers: int = ENC_LAYERS, dec_layers: int = DEC_LAYERS):
        self.w = w
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        self.quant = quant or (lambda x: x)
        self.p = dropout
        self.generator = generator
        dev = next(iter(w.values())).device
        self.pos = torch.from_numpy(sine_map(16, 32)).to(dev)

    # ---------------------------------------------------------- primitives
    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        if self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x * (1.0 / (1.0 - self.p)), 0.0)

    def _conv(self, x, key, stride=1, pad=0):
        return F.conv2d(self.quant(x), self.quant(self.w[key + "/kernel"]),
                        self.w.get(key + "/bias"), stride, pad)

    def _bn(self, x, key):
        w = self.w
        scale = w[key + "/weight"] * torch.rsqrt(w[key + "/running_var"]
                                                 + 1e-5)
        bias = w[key + "/bias"] - w[key + "/running_mean"] * scale
        return x * scale[:, None, None] + bias[:, None, None]

    def _dense(self, x, key):
        return self.quant(x) @ self.quant(self.w[key + "/kernel"]) \
            + self.w[key + "/bias"]

    def _ln(self, x, key):
        return F.layer_norm(x, (x.shape[-1],), self.w[key + "/scale"],
                            self.w[key + "/bias"], 1e-5)

    def _attn(self, q, k, v, key):
        b, lq, d = q.shape
        s = k.shape[1]
        hd = d // NHEADS
        qp = self._dense(q, key + "/q_proj").reshape(b, lq, NHEADS, hd)
        kp = self._dense(k, key + "/k_proj").reshape(b, s, NHEADS, hd)
        vp = self._dense(v, key + "/v_proj").reshape(b, s, NHEADS, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk",
                              self.quant(qp * (1.0 / math.sqrt(hd))),
                              self.quant(kp))
        probs = self._drop(torch.softmax(logits, dim=-1))
        out = torch.einsum("bhqk,bkhd->bqhd", self.quant(probs),
                           self.quant(vp))
        return self._dense(out.reshape(b, lq, d), key + "/out_proj")

    def _ffn(self, x, key):
        y = self._drop(F.relu(self._dense(x, key + "/linear1")))
        return self._dense(y, key + "/linear2")

    # -------------------------------------------------------------- model
    def backbone(self, canvas: torch.Tensor) -> torch.Tensor:
        """(B, 256, 512, 3) normalized -> (B, 1024, 16, 32)."""
        b = canvas.shape[0]
        x = canvas.permute(0, 3, 1, 2)
        x = torch.cat([x[..., :MAX_SIZE], x[..., MAX_SIZE:]], 0).contiguous()
        pre = "backbone/body/"
        x = F.relu(self._bn(self._conv(x, pre + "conv1", 2, 3), pre + "bn1"))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage, (_, blocks, stride) in enumerate(STAGES):
            for i in range(blocks):
                k = f"{pre}layer{stage + 1}_block{i}/"
                s = stride if i == 0 else 1
                y = F.relu(self._bn(self._conv(x, k + "conv1"), k + "bn1"))
                y = F.relu(self._bn(self._conv(y, k + "conv2", s, 1),
                                    k + "bn2"))
                y = self._bn(self._conv(y, k + "conv3"), k + "bn3")
                if i == 0:
                    x = self._bn(self._conv(x, k + "downsample_conv", s),
                                 k + "downsample_bn")
                x = F.relu(y + x)
        return torch.cat([x[:b], x[b:]], dim=3)

    def encode(self, canvas: torch.Tensor) -> torch.Tensor:
        """(B, 256, 512, 3) normalized canvas -> memory (B, 512, 256)."""
        feats = self._conv(self.backbone(canvas), "input_proj")
        src = feats.flatten(2).transpose(1, 2)
        pos = self.pos.expand(src.shape[0], -1, -1)
        for i in range(self.enc_layers):
            k = f"transformer/enc{i}/"
            qk = src + pos
            attn = self._drop(self._attn(qk, qk, src, k + "self_attn"))
            src = self._ln(src + attn, k + "norm1")
            ff = self._drop(self._ffn(src, k + "ffn"))
            src = self._ln(src + ff, k + "norm2")
        return src

    def _decode(self, memory, queries):
        q_pos = query_embedding(queries.float())
        pos = self.pos.expand(memory.shape[0], -1, -1)
        tgt = torch.zeros_like(q_pos)
        for i in range(self.dec_layers):
            k = f"transformer/dec{i}/"
            attn = self._drop(self._attn(tgt + q_pos, memory + pos, memory,
                                         k + "cross_attn"))
            tgt = self._ln(tgt + attn, k + "norm2")
            ff = self._drop(self._ffn(tgt, k + "ffn"))
            tgt = self._ln(tgt + ff, k + "norm3")
        x = self._ln(tgt, "transformer/decoder_norm")
        x = F.relu(self._dense(x, "corr_embed/fc0"))
        x = F.relu(self._dense(x, "corr_embed/fc1"))
        return self._dense(x, "corr_embed/fc2")

    def decode(self, memory: torch.Tensor, queries: torch.Tensor
               ) -> torch.Tensor:
        """memory (B, 512, 256), queries (B, Q, 2) -> (B, Q, 2); many
        queries go in chunks (each query is independent)."""
        if queries.shape[1] <= DEC_CHUNK or self.p > 0.0:
            return self._decode(memory, queries)
        return torch.cat([self._decode(memory, queries[:, i:i + DEC_CHUNK])
                          for i in range(0, queries.shape[1], DEC_CHUNK)], 1)

    def __call__(self, canvas, queries):
        return self.decode(self.encode(canvas), queries)


# ---------------------------------------------------------- lower precisions

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest TF32 (10 mantissa bits), ties away from zero, as
    the tensor cores' operand rounding; the gradient passes straight."""
    if x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float8 e4m3 with one scale a tensor (its largest
    magnitude onto e4m3's 448), back in float32: an fp8 product's operand.
    The gradient passes straight."""
    if x.dtype != torch.float32:
        return x
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    r = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (r - x).detach()


QUANT = {"tf32": round_tf32, "fp8": round_fp8}
