"""ResNet trunk with frozen batch normalization (counterpart of
cotr_tpu/models/resnet.py).

* FrozenBN: y = x * w / sqrt(rv + eps) + (b - rm * w / sqrt(rv + eps)), the
  statistics and affine parameters being constants (buffers);
* bottleneck v1.5 blocks (stride on the 3x3 conv), trunk to ``out_layer``;
* split canvas: the (256, 512) canvas's two 256-square halves run through the
  trunk as one doubled batch and the feature maps are joined along width, so
  conv padding never mixes the two images.

The JAX package computes the 7x7/s2 stem as an equivalent 4x4/s1 conv over a
2x2 space-to-depth input, a layout trick for the TPU's matrix unit. Here it
is the plain ``Conv2d(3, 64, 7, stride=2, padding=3)`` over the same stored
kernel. Internally NCHW; the public canvas is NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cotr_tpu_torch.models.layers import Conv2d
from cotr_tpu_torch.utils.constants import MAX_SIZE

_STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class FrozenBatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the affine is formed in float32, then meets the compute dtype
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        bias = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + bias.to(x.dtype)[:, None, None])


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          dilation: int = 1) -> Conv2d:
    pad = dilation * (kernel - 1) // 2
    return Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                  dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 (strided), 1x1 expand; projection shortcut on the
    first block of each stage."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        out_ch = width * 4
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride, dilation)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = _conv(width, out_ch, 1)
        self.bn3 = FrozenBatchNorm(out_ch)
        if downsample:
            self.downsample_conv = _conv(cin, out_ch, 1, stride)
            self.downsample_bn = FrozenBatchNorm(out_ch)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class ResNet(nn.Module):
    """ResNet-50/101 trunk up to ``out_layer`` (NCHW in, NCHW out).

    Block names follow the JAX package (``layer{stage}_block{i}``) so the
    weights carry across by name."""

    def __init__(self, variant: str = "resnet50", out_layer: str = "layer3",
                 dilation: bool = False):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        widths = (64, 128, 256, 512)
        strides = [1, 2, 2, 2]
        dilations = [1, 1, 1, 1]
        if dilation:
            strides[3], dilations[3] = 1, 2
        self.block_names = []
        cin = 64
        for stage in range(int(out_layer[-1])):
            for i in range(_STAGE_BLOCKS[variant][stage]):
                name = f"layer{stage + 1}_block{i}"
                self.add_module(name, Bottleneck(
                    cin, widths[stage], strides[stage] if i == 0 else 1,
                    dilations[stage], downsample=(i == 0)))
                self.block_names.append(name)
                cin = widths[stage] * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


class SplitCanvasBackbone(nn.Module):
    """(B, 256, 512, 3) NHWC canvas -> (B, C, 256/s, 512/s) NCHW features."""

    def __init__(self, variant: str = "resnet50", out_layer: str = "layer3",
                 dilation: bool = False):
        super().__init__()
        self.body = ResNet(variant, out_layer, dilation)

    def forward(self, canvas: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = canvas.shape
        if (h, w) != (MAX_SIZE, 2 * MAX_SIZE):
            raise ValueError(f"canvas must be ({MAX_SIZE}, {2 * MAX_SIZE}), "
                             f"got {(h, w)}")
        x = canvas.permute(0, 3, 1, 2)
        halves = torch.cat([x[..., :MAX_SIZE], x[..., MAX_SIZE:]], dim=0)
        feats = self.body(halves.contiguous())
        return torch.cat([feats[:b], feats[b:]], dim=3)  # join along width
