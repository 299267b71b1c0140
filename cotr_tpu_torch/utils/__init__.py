"""Utilities (counterpart of cotr_tpu/utils): constants, the small helpers
of ``misc``, the device choice of the entry points (``device``) and the
profiling helpers (``profiling``)."""

from cotr_tpu_torch.utils import constants
from cotr_tpu_torch.utils.constants import CANVAS_H, CANVAS_W, MAX_SIZE
from cotr_tpu_torch.utils.misc import (confirm, fix_randomness, has_nan,
                                       print_notification)

__all__ = ["constants", "MAX_SIZE", "CANVAS_H", "CANVAS_W", "confirm",
           "fix_randomness", "has_nan", "print_notification"]
