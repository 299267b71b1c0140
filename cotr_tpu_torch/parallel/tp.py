"""Tensor parallelism for the transformer (counterpart of
cotr_tpu/parallel/tp.py): Megatron's layout over a ``("data", "model")``
process mesh.

* q/k/v projections and the FFN's ``linear1``: output (head) dimension split
  (dim 0 of the torch ``(out, in)`` weight, as ``P(None, "model")`` on the
  JAX ``(in, out)`` kernel), biases split to match: each model shard
  computes a subset of the heads, ``nheads / model`` of them;
* ``out_proj`` and ``linear2``: input dimension split (dim 1 of the
  weight); the partial products are summed over ``"model"`` and the bias,
  replicated, is added once after the sum;
* everything else (layer norms, backbone, head) replicated.

Where XLA inserts the two all-reduces a layer under GSPMD, the port applies
Megatron's two autograd functions: *f* (identity forward, all-reduce
backward) on the input of a column-parallel layer and *g* (all-reduce
forward, identity backward) on the output of a row-parallel one.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from cotr_tpu_torch.parallel.mesh import (REPLICATED, Layout, ProcessMesh,
                                          gather_full, local_slice,
                                          process_group_device,
                                          require_process_mesh)

_COLUMN = ("q_proj", "k_proj", "v_proj", "linear1")
_ROW = ("out_proj", "linear2")


def _layout_for(name: str, model_axis: str) -> Layout:
    parts = name.split(".")
    if "transformer" not in parts or len(parts) < 2:
        return REPLICATED
    mod, leaf = parts[-2], parts[-1]
    if mod in _COLUMN:
        return Layout(0, model_axis)
    if mod in _ROW:
        return Layout(1, model_axis) if leaf == "weight" else REPLICATED
    return REPLICATED


def transformer_param_shardings(
        params: Union[nn.Module, Mapping[str, torch.Tensor]],
        model_axis: str = "model") -> Dict[str, Layout]:
    """The :class:`Layout` of each parameter of a ``COTRModel`` (or of a
    mapping of its parameter names), keyed by name."""
    names = (dict(params.named_parameters()) if isinstance(params, nn.Module)
             else params)
    return {name: _layout_for(name, model_axis) for name in names}


def make_2d_mesh(n_devices: int, model_parallel: int = 2,
                 axis_names: Sequence[str] = ("data", "model")
                 ) -> ProcessMesh:
    """A ``(n_devices / model_parallel, model_parallel)`` process mesh;
    ranks r and r + 1 of one data row are model peers. ``n_devices`` must
    be the world size of the running process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_2d_mesh needs an initialized process group")
    world = dist.get_world_size()
    if n_devices != world or n_devices % model_parallel:
        raise ValueError(f"n_devices={n_devices} must be the world size "
                         f"({world}) and a multiple of "
                         f"model_parallel={model_parallel}")
    return ProcessMesh(axis_names, (n_devices // model_parallel,
                                    model_parallel), process_group_device())


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: identity forward, gradient summed over the model
    group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: summed over the model group forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(tensors: Sequence[torch.Tensor], group) -> list:
    """*f* on each distinct tensor of ``tensors`` (a tensor given twice, as
    self-attention's query and key, passes once), in order."""
    seen: Dict[int, torch.Tensor] = {}
    out = []
    for t in tensors:
        if id(t) not in seen:
            seen[id(t)] = _CopyToModel.apply(t, group)
        out.append(seen[id(t)])
    return out


def row_parallel(linear: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """``linear`` with its input dimension split over the model group: the
    partial products summed by *g*, then the replicated bias added once."""
    y = F.linear(x, linear.weight.to(x.dtype))
    y = _ReduceFromModel.apply(y, group)
    return y + linear.bias.to(y.dtype)


@torch.no_grad()
def shard_model(model: nn.Module, mesh: ProcessMesh,
                model_axis: str = "model") -> Dict[str, Layout]:
    """Split ``model``'s transformer over the mesh's ``model_axis`` in
    place: each parameter keeps this rank's part of its
    :func:`transformer_param_shardings` layout, and every attention and FFN
    block learns its group. Returns the layouts. A mesh without the model
    axis, or with one of size 1, changes nothing: every layout is then
    replicated."""
    from cotr_tpu_torch.models.transformer import FFN, MultiHeadAttention

    mesh = require_process_mesh(mesh, "shard_model")
    m = mesh.shape.get(model_axis, 1)
    if m == 1:
        return {name: REPLICATED for name, _ in model.named_parameters()}
    layouts = transformer_param_shardings(model, model_axis)
    group = mesh.group(model_axis)
    for sub in model.modules():
        if isinstance(sub, MultiHeadAttention):
            width = sub.nheads
        elif isinstance(sub, FFN):
            width = sub.linear1.out_features
        else:
            continue
        if width % m:
            raise ValueError(f"{type(sub).__name__} of width {width} does "
                             f"not split over {m} model shards")
        sub.tp_group, sub.tp_size = group, m
    for name, p in model.named_parameters():
        layout = layouts[name]
        if not layout.replicated:
            p.data = local_slice(p.data, layout, mesh).clone()
    return layouts


@torch.no_grad()
def gather_state(model: nn.Module, layouts: Mapping[str, Layout],
                 mesh: ProcessMesh) -> Dict[str, torch.Tensor]:
    """``model``'s full state_dict from the parts on every rank (a
    collective: every rank calls it)."""
    state = model.state_dict()
    return {k: gather_full(v, layouts.get(k, REPLICATED), mesh)
            for k, v in state.items()}
