"""Top-level COTR model (counterpart of cotr_tpu/models/cotr.py).

    canvas (B, 256, 512, 3) ImageNet-normalized NHWC
      -> split-canvas ResNet (frozen BN) -> 1x1 projection to d_model
      -> + sine image positional map -> transformer encoder (512 tokens)
    queries (B, Q, 2) normalized canvas coords
      -> NeRF sine embedding (fp32, then the compute dtype)
      -> cross-attention decoder over the memory
      -> 3-layer MLP head in fp32 -> (B, Q, 2)

``encode`` and ``decode`` are separate entry points so the engine encodes a
canvas once and streams query chunks through the decoder. Both honour the
module's mode: in ``train()`` mode the transformer's dropout is active and
draws its keep masks from the ``generator`` argument (FrozenBN stays frozen
in either mode).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cotr_tpu_torch.config import COTRConfig
from cotr_tpu_torch.models.layers import Conv2d
from cotr_tpu_torch.models.position import (image_position_embedding,
                                            nerf_positional_encoding)
from cotr_tpu_torch.models.resnet import SplitCanvasBackbone
from cotr_tpu_torch.models.transformer import Transformer, xavier_reset
from cotr_tpu_torch.utils.constants import CANVAS_H, CANVAS_W

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class CorrHead(nn.Module):
    """MLP(d, d, 2, num_layers=3) regression head, always float32."""

    def __init__(self, hidden_dim: int = 256):
        super().__init__()
        self.fc0 = nn.Linear(hidden_dim, hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        x = F.relu(self.fc0(x))
        x = F.relu(self.fc1(x))
        return self.fc2(x)


class COTRModel(nn.Module):
    def __init__(self, cfg: COTRConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        self.backbone = SplitCanvasBackbone(cfg.backbone, cfg.layer,
                                            cfg.dilation)
        self.input_proj = Conv2d(cfg.backbone_channels, cfg.hidden_dim, 1)
        self.transformer = Transformer(cfg.hidden_dim, cfg.nheads,
                                       cfg.enc_layers, cfg.dec_layers,
                                       cfg.dim_feedforward, cfg.dropout,
                                       cfg.remat)
        self.corr_embed = CorrHead(cfg.hidden_dim)
        fh = CANVAS_H // cfg.backbone_stride
        fw = CANVAS_W // cfg.backbone_stride
        pos = image_position_embedding(fh, fw, cfg.hidden_dim,
                                       cfg.position_embedding)
        # derived from the config, so not part of the state_dict
        self.register_buffer(
            "pos_tokens", torch.from_numpy(pos.reshape(1, fh * fw, -1).copy()),
            persistent=False)

    def _pos(self, like: torch.Tensor) -> torch.Tensor:
        return self.pos_tokens.to(like.dtype).expand(like.shape[0], -1, -1)

    def encode(self, canvas: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """canvas (B, 256, 512, 3) normalized NHWC -> memory (B, 512, d)."""
        feats = self.backbone(canvas.to(self.dtype))
        src = self.input_proj(feats)  # (B, d, fh, fw)
        src = src.flatten(2).transpose(1, 2)  # (B, fh*fw, d), row-major
        return self.transformer.encode(src, self._pos(src),
                                       generator=generator)

    def decode(self, memory: torch.Tensor, queries: torch.Tensor,
               return_intermediate: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """memory (B, 512, d) + queries (B, Q, 2) -> (B, Q, 2) float32, or
        (dec_layers, B, Q, 2) with ``return_intermediate``. A gradient flows
        back through the queries' sine embedding: the cycle loss feeds
        predictions back in as queries."""
        cfg = self.cfg
        q_embed = nerf_positional_encoding(
            queries.float(), cfg.hidden_dim // 4,
            cfg.position_embedding).to(self.dtype)
        hs = self.transformer.decode(
            memory, self._pos(memory), q_embed,
            return_intermediate=return_intermediate, generator=generator)
        return self.corr_embed(hs)

    def forward(self, canvas: torch.Tensor, queries: torch.Tensor,
                return_intermediate: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decode(self.encode(canvas, generator), queries,
                           return_intermediate, generator)


def init_weights(model: COTRModel,
                 generator: Optional[torch.Generator] = None) -> None:
    """Fresh weights from a CPU ``generator``, drawn as the JAX package's
    ``model.init`` draws them: xavier-uniform for the projection, the
    transformer and the head, a normal of variance 1/fan_in for the
    backbone's convolutions, the identity for every FrozenBN."""
    for part in (model.input_proj, model.transformer, model.corr_embed):
        xavier_reset(part, generator)
    for name, buf in model.backbone.named_buffers():
        buf.fill_(1.0 if name.endswith(("weight", "running_var")) else 0.0)
    for sub in model.backbone.modules():
        if isinstance(sub, nn.Conv2d):
            fan_in = sub.weight[0].numel()
            fresh = torch.empty(sub.weight.shape).normal_(
                0.0, fan_in ** -0.5, generator=generator)
            with torch.no_grad():
                sub.weight.copy_(fresh)


def build_model(cfg: Optional[COTRConfig] = None) -> COTRModel:
    """An uninitialized-weights model in eval mode (load weights with
    ``checkpoint_io``).

    A float32 config means real float32 on the card, as the JAX package's
    Precision.HIGHEST does on the TPU: both TF32 switches
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``, the latter True by default) are set
    to False for the process."""
    cfg = cfg or COTRConfig()
    if cfg.dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return COTRModel(cfg).eval()
