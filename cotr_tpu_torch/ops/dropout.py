"""Dropout whose keep mask comes from an explicit ``torch.Generator``.

``F.dropout`` draws from the global random state. A train step that takes
its generator as an argument (as the JAX step takes ``dropout_rng``) repeats
exactly under the same generator state, on the CPU and on the card.
"""

from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Zero each element with probability ``p`` and scale the rest by
    1/(1-p); the identity when not training or p == 0. ``generator`` lives
    on x's device; None draws from the global state."""
    if not training or p == 0.0:
        return x
    if not 0.0 < p < 1.0:
        raise ValueError(f"dropout probability must be in [0, 1), got {p}")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x * (1.0 / (1.0 - p)), 0.0)
