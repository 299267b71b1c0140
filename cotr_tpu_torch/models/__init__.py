"""The model (counterpart of cotr_tpu/models): the split-canvas ResNet
backbone, the sine position maps, the transformer and the COTR model, with
its checkpoint readers and writers in ``checkpoint_io`` and
``torch_convert``."""

from cotr_tpu_torch.models.cotr import COTRModel, CorrHead, build_model
from cotr_tpu_torch.models.position import (image_position_embedding,
                                            nerf_positional_encoding)
from cotr_tpu_torch.models.resnet import (FrozenBatchNorm, ResNet,
                                          SplitCanvasBackbone)
from cotr_tpu_torch.models.transformer import MultiHeadAttention, Transformer

__all__ = [
    "COTRModel",
    "CorrHead",
    "build_model",
    "image_position_embedding",
    "nerf_positional_encoding",
    "FrozenBatchNorm",
    "ResNet",
    "SplitCanvasBackbone",
    "MultiHeadAttention",
    "Transformer",
]
