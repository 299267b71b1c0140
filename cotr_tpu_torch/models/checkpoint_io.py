"""Carry the JAX package's weights into the port.

``checkpoints/flagship.npz`` (written by cotr_tpu's ``save_params_npz``)
holds flat ``params/a/b/c`` keys plus ``__bf16_keys__``, a JSON list of the
keys stored as bfloat16 bit patterns in uint16. It is read with numpy alone.
The port's modules keep the JAX package's names, so a Flax key maps to a
state_dict key by its path, with these layout rules:

* conv ``kernel`` HWIO -> ``weight`` OIHW;
* dense ``kernel`` (in, out) -> ``weight`` (out, in);
* LayerNorm ``scale`` -> ``weight``;
* FrozenBN ``weight``/``bias``/``running_mean``/``running_var`` as they are.
"""

from __future__ import annotations

import json
from typing import Dict, Mapping

import numpy as np
import torch

from cotr_tpu_torch.config import COTRConfig
from cotr_tpu_torch.models.cotr import COTRModel, build_model
from cotr_tpu_torch.utils.device import resolve_device


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def load_flagship(path: str) -> Dict[str, np.ndarray]:
    """Read a cotr_tpu ``.npz`` weight file into flat float32/int arrays
    keyed ``params/a/b/c``."""
    with np.load(path, allow_pickle=False) as data:
        bf16_keys = set(json.loads(str(data["__bf16_keys__"])))
        flat = {}
        for k in data.files:
            if k == "__bf16_keys__":
                continue
            v = data[k]
            flat[k] = _bf16_bits_to_f32(v) if k in bf16_keys else v
    return flat


def params_from_flax(flat: Mapping[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
    """Flat Flax params (``params/...`` keys, numpy arrays) -> the port's
    state_dict."""
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        leaf = parts[-1]
        v = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            if v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif v.ndim == 2:
                v = v.T  # (in, out) -> (out, in)
            else:
                raise ValueError(f"{key}: kernel of rank {v.ndim}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(parts[:-1] + [leaf])] = torch.tensor(v)
    return out


def load_state(model: COTRModel, flat: Mapping[str, np.ndarray]) -> None:
    """Load flat Flax params into ``model``; any missing or unexpected key
    raises."""
    state = params_from_flax(flat)
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    unexpected = sorted(set(state) - set(want))
    if missing or unexpected:
        raise KeyError(f"weights do not match the model: missing "
                       f"{missing[:8]} ({len(missing)}), unexpected "
                       f"{unexpected[:8]} ({len(unexpected)})")
    for k, v in state.items():
        if tuple(want[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: stored {tuple(v.shape)}, model "
                             f"{tuple(want[k].shape)}")
    model.load_state_dict(state, strict=True)


def load_model(path: str, cfg: COTRConfig | None = None,
               device="cuda") -> COTRModel:
    """Build the model for ``cfg``, load ``path`` (a cotr_tpu ``.npz``) and
    move it to ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    model = build_model(cfg)
    load_state(model, load_flagship(path))
    return model.to(dev)
