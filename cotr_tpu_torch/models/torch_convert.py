"""Reference-layout PyTorch checkpoints <-> the port's state_dict (counterpart
of cotr_tpu/models/torch_convert.py).

The reference ships weights as a torch state dict, bare or inside a
``checkpoint.pth.tar`` under ``model_state_dict``, in the DETR lineage's key
layout:

    backbone.0.body.{conv1,bn1,layerX.Y.*}
    input_proj.{weight,bias}
    transformer.encoder.layers.N.{self_attn.*,linear1,linear2,norm1,norm2}
    transformer.decoder.layers.N.{multihead_attn.*,linear1,linear2,norm2,norm3}
    transformer.decoder.norm.*
    corr_embed.layers.{0,1,2}.*

The port's weights are already OIHW and (out, in), so the conversion renames
keys and splits each packed ``in_proj_weight``/``in_proj_bias`` (3d rows) into
the q, k and v projections. ``module.`` prefixes are dropped; keys the model
has no use for (a decoder ``norm1`` or ``self_attn`` of older checkpoints) are
ignored.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from cotr_tpu_torch.config import COTRConfig
from cotr_tpu_torch.models.cotr import COTRModel, build_model
from cotr_tpu_torch.utils.device import resolve_device

_LAYER = re.compile(r"transformer\.(enc|dec)(\d+)\.(.+)")
_PACKED = re.compile(r"(self_attn|multihead_attn)\.([qkv])_proj\.(weight|bias)")


def _reference_key(key: str) -> Tuple[str, Optional[int]]:
    """A key of the port's state_dict -> (the reference's key, which third
    of a packed q/k/v projection or None)."""
    if key.startswith("backbone.body."):
        rest = key[len("backbone.body."):]
        rest = re.sub(r"^layer(\d)_block(\d+)\.", r"layer\1.\2.", rest)
        rest = rest.replace("downsample_conv.", "downsample.0.")
        rest = rest.replace("downsample_bn.", "downsample.1.")
        return "backbone.0.body." + rest, None
    layer = _LAYER.fullmatch(key)
    if layer:
        kind, index, rest = layer.groups()
        stack = "encoder" if kind == "enc" else "decoder"
        prefix = f"transformer.{stack}.layers.{index}."
        rest = rest.replace("cross_attn.", "multihead_attn.")
        rest = rest.replace("ffn.", "")
        packed = _PACKED.fullmatch(rest)
        if packed:
            attn, which, leaf = packed.groups()
            return f"{prefix}{attn}.in_proj_{leaf}", "qkv".index(which)
        return prefix + rest, None
    if key.startswith("transformer.decoder_norm."):
        return key.replace("decoder_norm", "decoder.norm"), None
    head = re.fullmatch(r"corr_embed\.fc(\d)\.(.+)", key)
    if head:
        return f"corr_embed.layers.{head.group(1)}.{head.group(2)}", None
    return key, None  # input_proj.*


def _port_keys(cfg: COTRConfig):
    return list(COTRModel(cfg).state_dict())


def _as_tensor(value) -> torch.Tensor:
    if not torch.is_tensor(value):
        value = torch.from_numpy(np.asarray(value))
    return value.detach().to("cpu", torch.float32)


def torch_state_dict_to_port(state: Mapping, cfg: COTRConfig
                             ) -> Dict[str, torch.Tensor]:
    """Reference torch state dict -> the port's state_dict for ``cfg``
    (float32 CPU tensors). A key the model needs and the dict lacks raises."""
    ref = {k.replace("module.", ""): v for k, v in state.items()}
    out = {}
    for key in _port_keys(cfg):
        ref_key, part = _reference_key(key)
        if ref_key not in ref:
            raise KeyError(f"the checkpoint has no {ref_key!r} (for {key})")
        value = _as_tensor(ref[ref_key])
        if part is not None:
            value = value.chunk(3, dim=0)[part]
        out[key] = value.clone()
    return out


def port_to_torch_state_dict(model_or_state: Union[nn.Module, Mapping],
                             cfg: COTRConfig) -> Dict[str, torch.Tensor]:
    """The inverse: the port's model or state_dict -> a state dict in the
    reference's key layout, q/k/v packed again."""
    state = (model_or_state.state_dict()
             if isinstance(model_or_state, nn.Module) else model_or_state)
    out: Dict[str, torch.Tensor] = {}
    thirds: Dict[str, list] = {}
    for key in _port_keys(cfg):
        ref_key, part = _reference_key(key)
        value = _as_tensor(state[key])
        if part is None:
            out[ref_key] = value.clone()
        else:
            thirds.setdefault(ref_key, [None] * 3)[part] = value
    for ref_key, parts in thirds.items():
        out[ref_key] = torch.cat(parts, dim=0)
    return out


def load_torch_checkpoint(path: str, cfg: Optional[COTRConfig] = None,
                          device="cuda") -> COTRModel:
    """Build the model for ``cfg`` and load a reference ``checkpoint.pth.tar``
    or ``*.pth`` into it: a bare state dict, or the reference trainer's
    wrapper with the weights under ``model_state_dict``. The model comes back
    in eval mode on ``device`` (the card unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    cfg = cfg or COTRConfig()
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = (blob.get("model_state_dict", blob) if isinstance(blob, dict)
             else blob)
    model = build_model(cfg)
    model.load_state_dict(torch_state_dict_to_port(state, cfg), strict=True)
    return model.to(dev)
