"""Canvas construction: side-by-side composition and ImageNet
normalization (counterpart of cotr_tpu/ops/canvas.py), on tensors."""

from __future__ import annotations

import torch

from cotr_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD


def two_images_side_by_side(img_a: torch.Tensor,
                            img_b: torch.Tensor) -> torch.Tensor:
    """Concatenate two equal-shaped (..., H, W, C) images along width."""
    if img_a.shape != img_b.shape:
        raise ValueError(f"{tuple(img_a.shape)} vs {tuple(img_b.shape)}")
    return torch.cat([img_a, img_b], dim=-2)


def normalize_canvas(canvas: torch.Tensor) -> torch.Tensor:
    """uint8 or float (N)HWC canvas -> ImageNet-normalized float32 (uint8 is
    scaled by 1/255 first, as torchvision's to_tensor does)."""
    x = canvas.float()
    if canvas.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
