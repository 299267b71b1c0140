"""The committed weight file, read with numpy alone.

``checkpoints/flagship.npz`` holds flat ``params/a/b/c`` keys (Flax names)
and ``__bf16_keys__``, a JSON list of the keys stored as bfloat16 bit
patterns in uint16. Convolution kernels are HWIO, dense kernels (in, out),
LayerNorm scales ``scale``.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of the file as float32, keyed by its Flax path without
    the leading ``params/``."""
    with np.load(path, allow_pickle=False) as data:
        bf16 = set(json.loads(str(data["__bf16_keys__"])))
        out = {}
        for key in data.files:
            if key == "__bf16_keys__":
                continue
            v = data[key]
            if key in bf16:
                v = (v.astype(np.uint32) << 16).view(np.float32)
            out[key.removeprefix("params/")] = np.asarray(v, np.float32)
    return out


def to_device(flat: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The arrays as float32 tensors on ``device``; convolution kernels
    turned to OIHW for ``F.conv2d``."""
    out = {}
    for key, v in flat.items():
        t = torch.from_numpy(v)
        if key.endswith("kernel") and t.dim() == 4:
            t = t.permute(3, 2, 0, 1)
        out[key] = t.contiguous().to(device)
    return out
