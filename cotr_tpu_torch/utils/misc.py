"""Small utilities (counterpart of cotr_tpu/utils/misc.py)."""

from __future__ import annotations

import random
from typing import Sequence

import numpy as np
import torch


def fix_randomness(seed: int = 42) -> None:
    """Seed Python's, numpy's and torch's global generators (the JAX
    package seeds the first two; its own randomness takes explicit keys)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def has_nan(x) -> bool:
    """True if ``x`` (an array, a tensor or None) contains a NaN."""
    if x is None:
        return False
    if torch.is_tensor(x):
        return bool(torch.isnan(x).any())
    return bool(np.isnan(np.asarray(x)).any())


def print_notification(content_list: Sequence[str],
                       notification_type: str = "NOTIFICATION") -> None:
    print(f"---------------------- {notification_type} "
          "----------------------\n")
    for content in content_list:
        print(content)
    print("\n----------------------------------------------------")


def confirm(question: str = "OK to continue?") -> bool:
    """Interactive y/n gate."""
    answer = ""
    while answer not in ("y", "n"):
        answer = input(f"{question} [y/n] ").lower()
    return answer == "y"
