"""Carry weights between the JAX package and the port, both ways.

``checkpoints/flagship.npz`` (written by cotr_tpu's ``save_params_npz``)
holds flat ``params/a/b/c`` keys plus ``__bf16_keys__``, a JSON list of the
keys stored as bfloat16 bit patterns in uint16. It is read with numpy alone.
The port's modules keep the JAX package's names, so a Flax key maps to a
state_dict key by its path, with these layout rules:

* conv ``kernel`` HWIO -> ``weight`` OIHW;
* dense ``kernel`` (in, out) -> ``weight`` (out, in);
* LayerNorm ``scale`` -> ``weight``;
* FrozenBN ``weight``/``bias``/``running_mean``/``running_var`` as they are.

``params_to_flax`` and ``save_params_npz`` go the other way, so weights the
port trained are served by either package.
"""

from __future__ import annotations

import json
from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

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


def _is_frozen_bn(module_name: str) -> bool:
    return module_name.startswith("bn") or module_name.endswith("_bn")


def params_to_flax(state: Mapping[str, torch.Tensor]
                   ) -> Dict[str, np.ndarray]:
    """The port's state_dict -> flat Flax params (``params/a/b/c`` keys,
    float32 numpy arrays): the inverse of :func:`params_from_flax`."""
    out = {}
    for key, value in state.items():
        parts = key.split(".")
        leaf = parts[-1]
        v = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight" and not _is_frozen_bn(parts[-2]):
            if v.ndim == 4:
                v, leaf = v.transpose(2, 3, 1, 0), "kernel"  # OIHW -> HWIO
            elif v.ndim == 2:
                v, leaf = v.T, "kernel"  # (out, in) -> (in, out)
            elif v.ndim == 1:
                leaf = "scale"  # LayerNorm
            else:
                raise ValueError(f"{key}: weight of rank {v.ndim}")
        out["/".join(["params"] + parts[:-1] + [leaf])] = \
            np.ascontiguousarray(v)
    return out


def save_params_npz(model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]],
                    path: str, dtype: str = "bfloat16") -> None:
    """Write the weights as one compressed ``.npz`` in the JAX package's
    format (its ``save_params_npz``): flat Flax keys, float arrays as
    bfloat16 bit patterns in uint16 (rounded to nearest even) with their keys
    listed under ``__bf16_keys__``, or as float32 with ``dtype="float32"``.
    Both packages' loaders read it."""
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype}")
    state = (model_or_state.state_dict()
             if isinstance(model_or_state, nn.Module) else model_or_state)
    store, bf16_keys = {}, []
    for k, v in params_to_flax(state).items():
        if dtype == "bfloat16":
            bits = torch.from_numpy(v).to(torch.bfloat16).view(torch.int16)
            store[k] = bits.numpy().view(np.uint16)
            bf16_keys.append(k)
        else:
            store[k] = v
    store["__bf16_keys__"] = np.asarray(json.dumps(bf16_keys))
    np.savez_compressed(path, **store)


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
