"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM, the
model's operations from its shapes, and the attention's roofline.

Peaks (NVIDIA's data sheet, dense, at the full 700 W): 989 TFLOP/s in
bfloat16, 495 TFLOP/s in TF32, 3.35 TB/s of HBM. A float32 share is taken
against TF32's peak, the fastest way the card does a float32 product: the
float32 attention kernel runs three TF32 products a logit, so against the
67 TFLOP/s of float32 outside the tensor cores it could read above 100%.

Operations are counted as 2 a multiply-add, from the published sizes:
ResNet-50 to layer3 on each 256-square half of a canvas, a 1x1 projection
to d = 256, 6 encoder layers over 512 tokens and 6 decoder layers of
cross-attention over them, FFN 1024, the 3-layer head.
"""

from __future__ import annotations

from typing import Mapping, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
TOKENS = 512
HEAD_DIM = 32


def backbone_flops(model: Mapping, side: int = 256) -> float:
    """ResNet-50 (bottleneck v1.5) to ``model["layer"]`` on one square
    half of ``side`` pixels."""
    stages = {"layer1": 1, "layer2": 2, "layer3": 3, "layer4": 4}[
        model["layer"]]
    hw = side // 2
    total = 2.0 * 3 * 64 * 49 * hw * hw  # 7x7/s2 stem
    hw //= 2  # 3x3/s2 max pool
    cin = 64
    blocks = (3, 4, 6, 3)
    for stage in range(stages):
        width = 64 * 2 ** stage
        for i in range(blocks[stage]):
            stride = 2 if (stage > 0 and i == 0) else 1
            out_hw = hw // stride
            total += 2.0 * cin * width * hw * hw          # 1x1 reduce
            total += 2.0 * width * width * 9 * out_hw * out_hw  # 3x3
            total += 2.0 * width * 4 * width * out_hw * out_hw  # 1x1 expand
            if i == 0:
                total += 2.0 * cin * 4 * width * out_hw * out_hw
            cin = 4 * width
            hw = out_hw
    return total


def canvas_flops(model: Mapping) -> float:
    """Backbone of both halves, the projection and the encoder, a canvas."""
    d, f = model["hidden_dim"], model["ffn_dim"]
    proj = 2.0 * model["backbone_channels"] * d * TOKENS
    return 2 * backbone_flops(model) + proj + model["enc_layers"] * \
        attention_layer_flops(1, TOKENS, TOKENS, d, f, self_attn=True)


def attention_layer_flops(b: int, lq: int, s: int, d: int, f: int,
                          self_attn: bool) -> float:
    """One transformer layer: projections, the two attention products and
    the FFN. Cross-attention projects its S keys and values once a call."""
    qo = 2 * 2.0 * b * lq * d * d
    kv = 2 * 2.0 * b * (lq if self_attn else s) * d * d
    attn = 4.0 * b * lq * s * d
    ffn = 4.0 * b * lq * d * f
    return qo + kv + attn + ffn


def head_flops(model: Mapping) -> float:
    d = model["hidden_dim"]
    return 2.0 * (2 * d * d + 2 * d)


def serve_flops(shape_counts: Mapping[Tuple, int], model: Mapping) -> float:
    """Model operations of what ran, from the attention calls by (B, Lq, S,
    dtype): a call with Lq = S = 512 is an encoder layer's self-attention
    (a canvas encode makes ``enc_layers`` of them), any other a decoder
    layer's cross-attention (a decode makes ``dec_layers`` of them)."""
    d, f = model["hidden_dim"], model["ffn_dim"]
    enc, dec = model["enc_layers"], model["dec_layers"]
    total = 0.0
    for (b, lq, s, _), n in shape_counts.items():
        if lq == s == TOKENS:
            # per encode: backbone, projection and every encoder layer
            total += n * b * canvas_flops(model) / enc
        else:
            total += n * attention_layer_flops(b, lq, s, d, f, False)
            total += n * b * lq * head_flops(model) / dec
    return total


def train_step_flops(model: Mapping, batch: int, queries: int) -> float:
    """One training step: two forwards (the queries, then the predictions
    as queries) over the batch's canvases; the backward of everything
    past the frozen backbone at twice its forward."""
    d, f = model["hidden_dim"], model["ffn_dim"]
    backbone = 2 * backbone_flops(model) * batch
    rest = (canvas_flops(model) - 2 * backbone_flops(model)) * batch
    rest += model["dec_layers"] * attention_layer_flops(
        batch, queries, TOKENS, d, f, False)
    rest += batch * queries * head_flops(model)
    return 2 * backbone + 2 * 3 * rest


def attention_bound_s(b: int, lq: int, s: int, h: int, hd: int,
                      dtype: str) -> float:
    """Least time for one attention call on the card: each input read once
    and the output written once at the HBM's rate, or its two products at
    the dtype's peak, whichever is longer."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (2 * b * lq * h * hd + 2 * b * s * h * hd)
    flops = 4.0 * b * h * lq * s * hd
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
