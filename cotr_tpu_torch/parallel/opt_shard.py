"""Optimizer-state layouts: moments follow their parameter, optionally
ZeRO-1 (counterpart of cotr_tpu/parallel/opt_shard.py).

* moments-follow-params: the Adam moments of a parameter that tensor
  parallelism splits are split the same way (each rank keeps the moments of
  its part);
* ZeRO-1 (``zero1_axis="data"``): the moments of a *replicated* parameter
  are split over the data axis on their largest dimension the axis size
  divides, so each rank keeps and updates one slice
  (``training.optim.Optimizer``) and the updated slices are gathered into
  the parameter once a step.

The dimension is chosen as the JAX package chooses it (``_zero1_spec``: the
largest, ties to the first, in the JAX array's axis order) and mapped
through the converter's axis permutation (``models/checkpoint_io``: conv
kernels HWIO <-> OIHW, dense kernels transposed), so both packages split the
same elements.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from cotr_tpu_torch.parallel.mesh import REPLICATED, Layout, Mesh


def flax_axes(name: str, ndim: int) -> Tuple[int, ...]:
    """For each dimension of the port's tensor ``name``, the axis of the
    JAX package's array it is: (3, 2, 0, 1) for a conv weight (OIHW of
    HWIO), (1, 0) for a dense weight, the identity for everything else
    (biases, layer-norm scales, FrozenBN statistics)."""
    parts = name.split(".")
    frozen_bn = len(parts) >= 2 and (parts[-2].startswith("bn")
                                     or parts[-2].endswith("_bn"))
    if parts[-1] == "weight" and not frozen_bn:
        if ndim == 4:
            return (3, 2, 0, 1)
        if ndim == 2:
            return (1, 0)
    return tuple(range(ndim))


def _zero1_dim(name: str, shape, axis_size: int) -> Optional[int]:
    """The torch dimension that ZeRO-1 splits, or None."""
    if not shape:
        return None
    axes = flax_axes(name, len(shape))
    jax_shape = [0] * len(shape)
    for dim, axis in enumerate(axes):
        jax_shape[axis] = shape[dim]
    for axis in sorted(range(len(shape)), key=lambda a: -jax_shape[a]):
        if jax_shape[axis] >= axis_size and jax_shape[axis] % axis_size == 0:
            return axes.index(axis)
    return None


def opt_state_shardings(params: Mapping[str, torch.Tensor],
                        param_layouts: Mapping[str, Layout],
                        mesh: Union[Mesh, Mapping[str, int]],
                        zero1_axis: Optional[str] = None
                        ) -> Dict[str, Layout]:
    """The layout of each parameter's Adam moments (``mu`` and ``nu``
    alike), keyed by parameter name. ``params`` maps names to the FULL
    parameters (or anything with their ``.shape``); ``mesh`` is a mesh or a
    mapping of axis sizes. The optimizer's counters are scalars and stay
    replicated."""
    sizes = mesh.shape if isinstance(mesh, Mesh) else dict(mesh)
    axis_size = sizes.get(zero1_axis, 1) if zero1_axis else 1
    out = {}
    for name, p in params.items():
        layout = param_layouts.get(name, REPLICATED)
        if zero1_axis and axis_size > 1 and layout.replicated:
            dim = _zero1_dim(name, tuple(p.shape), axis_size)
            layout = REPLICATED if dim is None else Layout(dim, zero1_axis)
        out[name] = layout
    return out
