"""Model and inference configuration (copy of cotr_tpu/config.py's
``COTRConfig`` and ``InferenceConfig``, same fields and JSON form).

Defaults reproduce the published model: ResNet-50 to layer3, d_model 256,
8 heads, 6+6 layers, FFN 1024, lin_sine positional embedding.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

_LAYER_CHANNELS = {"layer1": 256, "layer2": 512, "layer3": 1024,
                   "layer4": 2048}
_LAYER_STRIDE = {"layer1": 4, "layer2": 8, "layer3": 16, "layer4": 32}


@dataclasses.dataclass(frozen=True)
class COTRConfig:
    """Model hyper-parameters."""

    backbone: str = "resnet50"
    layer: str = "layer3"
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dropout: float = 0.1
    dilation: bool = False
    position_embedding: str = "lin_sine"  # or "exp_sine"
    activation: str = "relu"
    #: compute dtype for backbone+transformer ("float32" or "bfloat16");
    #: params are float32 and the correspondence head always runs fp32.
    dtype: str = "float32"
    #: kept for JSON compatibility with cotr_tpu. In the port the tensor's
    #: device chooses the attention path: the hand-written kernel on the
    #: card, the plain version on the CPU (ops/attention.py).
    use_flash_attention: bool = False
    #: training-only field of cotr_tpu, kept for JSON compatibility.
    remat: bool = False

    @property
    def backbone_channels(self) -> int:
        return _LAYER_CHANNELS[self.layer]

    @property
    def backbone_stride(self) -> int:
        s = _LAYER_STRIDE[self.layer]
        return s // 2 if (self.dilation and self.layer == "layer4") else s

    @property
    def dim_feedforward(self) -> int:
        # the FFN width is tied to the backbone channel count
        return self.backbone_channels

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "COTRConfig":
        return cls(**json.loads(s))


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Sparse/dense engine settings. ``zoom_ins`` is
    np.linspace(0.5, 0.0625, 4), the demos' schedule."""

    zoom_ins: Tuple[float, ...] = (0.5, 0.354166667, 0.208333333, 0.0625)
    converge_iters: int = 1
    batch_size: int = 32
    max_corrs: int = 1000
    mode: str = "stretching"  # or "tile"
    #: queries per shared crop-pair in grouped refinement
    max_load: int = 256
