"""Optimizer with the reference's parameter-group policy (counterpart of
cotr_tpu/training/optim.py).

The transformer, the head and the input projection train at
``learning_rate``; the backbone at ``lr_backbone``, and only when that is
above 0, and then only its layer2/3/4 convolutions; FrozenBN never trains.
Frozen parameters get ``requires_grad_(False)``, so autograd does not compute
what would be thrown away.

:class:`Optimizer` is Adam as ``optax.adam`` computes it (both moments
bias-corrected, eps 1e-8 outside the root) under ``optax.apply_if_finite``:
a step whose gradients hold a NaN or Inf leaves parameters, moments and the
Adam count untouched, until more than ``max_consecutive_errors`` such steps
came in a row, from when they are applied as they are. The cosine schedule
rides the Adam count, so a skipped step does not advance it and the first
update uses the base rate. Every decision is taken on the device
(``torch.where``): a step reads nothing back on the host.

On a process mesh (``parallel.mesh``) the optimizer takes each parameter's
layout: a parameter that tensor parallelism splits keeps the moments of its
part; with ``zero1_axis`` the moments of a replicated parameter are split
over that axis (``parallel.opt_shard``), each rank updates its slice and the
updated slices are gathered into the parameter in one collective. The
finite-step flag is reduced over every rank first, so the ranks skip a step
alike. ``state_dict`` holds the full moments whatever the layout.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from cotr_tpu_torch.config import TrainConfig
from cotr_tpu_torch.parallel.mesh import (REPLICATED, Layout, ProcessMesh,
                                          gather_full, local_slice,
                                          require_process_mesh)
from cotr_tpu_torch.parallel.opt_shard import opt_state_shardings

_TRAINABLE_BACKBONE_STAGES = ("layer2", "layer3", "layer4")
_BETA1, _BETA2, _EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 100


def _is_frozen_bn_param(names) -> bool:
    leaf = names[-1]
    if leaf in ("running_mean", "running_var"):
        return True
    if leaf in ("weight", "bias") and len(names) >= 2:
        mod = names[-2]
        return mod.startswith("bn") or mod.endswith("_bn")
    return False


def param_labels(names, lr_backbone: float) -> Dict[str, str]:
    """``main``, ``backbone`` or ``frozen`` for each dotted parameter or
    buffer name of the model."""
    def label(name: str) -> str:
        parts = name.split(".")
        if "backbone" in parts:
            if _is_frozen_bn_param(parts) or lr_backbone <= 0:
                return "frozen"
            in_trainable_stage = any(
                part.startswith(_TRAINABLE_BACKBONE_STAGES) for part in parts)
            return "backbone" if in_trainable_stage else "frozen"
        return "main"

    return {name: label(name) for name in names}


def _group_lr(cfg: TrainConfig, base: float, count: torch.Tensor):
    """The base rate, or its cosine decay to base*lr_final_frac over
    lr_decay_steps at Adam count ``count`` (a device scalar)."""
    if cfg.lr_schedule == "cosine" and cfg.lr_decay_steps > 0:
        frac = count.clamp(max=cfg.lr_decay_steps).float() \
            / cfg.lr_decay_steps
        cosine = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base * ((1.0 - cfg.lr_final_frac) * cosine
                       + cfg.lr_final_frac)
    return base


class Optimizer:
    """Adam over the ``main`` and ``backbone`` groups with the finite-step
    skip. ``step()`` reads each parameter's ``.grad``.

    ``mesh``, ``layouts`` (each parameter's, by name; replicated where
    absent) and ``zero1_axis``: the sharded state of the module's
    docstring. Every rank of the mesh calls ``step`` and ``state_dict``."""

    def __init__(self, cfg: TrainConfig,
                 named_params: Mapping[str, nn.Parameter],
                 mesh: Optional[ProcessMesh] = None,
                 layouts: Optional[Mapping[str, Layout]] = None,
                 zero1_axis: Optional[str] = None):
        if cfg.lr_schedule not in ("constant", "cosine"):
            raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
        self.cfg = cfg
        labels = param_labels(named_params, cfg.lr_backbone)
        self.groups = {"main": {}, "backbone": {}}
        for name, p in named_params.items():
            if labels[name] == "frozen":
                p.requires_grad_(False)
            else:
                p.requires_grad_(True)
                self.groups[labels[name]][name] = p
        self.base_lr = {"main": cfg.learning_rate,
                        "backbone": max(cfg.lr_backbone, 1e-30)}
        params = self.params
        if not params:
            raise ValueError("no trainable parameter")
        dev = next(iter(params.values())).device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        self.mesh = None if mesh is None else \
            require_process_mesh(mesh, "Optimizer")
        self.layouts = dict(layouts or {})
        self.moment_layouts = {n: self.layouts.get(n, REPLICATED)
                               for n in params}
        if mesh is not None:
            self.moment_layouts = opt_state_shardings(
                params, self.layouts, mesh, zero1_axis)
        #: parameters whose moments are split apart from the parameter
        #: (ZeRO-1), by name
        self.zero1 = {n: lay for n, lay in self.moment_layouts.items()
                      if lay != self.layouts.get(n, REPLICATED)}
        self.mu = {n: torch.zeros_like(self._moment_part(n, p))
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(self._moment_part(n, p))
                   for n, p in params.items()}

    def _moment_part(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The part of a parameter (as this rank holds it) that this rank's
        moments cover."""
        if name in self.zero1:
            return local_slice(local, self.zero1[name], self.mesh)
        return local

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return {**self.groups["main"], **self.groups["backbone"]}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        params = self.params
        grads = {n: p.grad for n, p in params.items()}
        finite = torch.stack(
            [torch.isfinite(g).all() for g in grads.values()]).all()
        if self.mesh is not None and self.mesh.size > 1:
            # each rank may see another part of the gradient: one decision
            flag = finite.to(torch.int32)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            finite = flag.bool()
        bump = (~finite).to(torch.int32)
        notfinite = torch.where(finite, 0, self.notfinite_count + 1) \
            .to(torch.int32)
        apply = finite | (notfinite > MAX_CONSECUTIVE_ERRORS)
        count_inc = self.count + 1
        correction1 = 1.0 - _BETA1 ** count_inc.float()
        correction2 = 1.0 - _BETA2 ** count_inc.float()
        updated = {}
        for group, members in self.groups.items():
            if not members:
                continue
            lr = _group_lr(self.cfg, self.base_lr[group], self.count)
            for name, p in members.items():
                g = self._moment_part(name, grads[name])
                w = self._moment_part(name, p)
                mu = (1.0 - _BETA1) * g + _BETA1 * self.mu[name]
                nu = (1.0 - _BETA2) * (g * g) + _BETA2 * self.nu[name]
                update = (mu / correction1) \
                    / ((nu / correction2).sqrt() + _EPS)
                new = torch.where(apply, w - lr * update, w)
                if name in self.zero1:
                    updated[name] = new
                else:
                    p.copy_(new)
                self.mu[name] = torch.where(apply, mu, self.mu[name])
                self.nu[name] = torch.where(apply, nu, self.nu[name])
        if updated:
            self._gather_updated(updated)
        self.count = torch.where(apply, count_inc, self.count)
        self.notfinite_count = notfinite
        self.total_notfinite = self.total_notfinite + bump
        self.last_finite = finite

    def _gather_updated(self, updated: Dict[str, torch.Tensor]) -> None:
        """Every rank's updated ZeRO-1 slices into the parameters, through
        one flat buffer a split axis."""
        params = self.params
        by_axis: Dict[str, list] = {}
        for name in updated:
            by_axis.setdefault(self.zero1[name].axis, []).append(name)
        for axis, names in by_axis.items():
            flat = torch.cat([updated[n].reshape(-1) for n in names])
            parts = [torch.empty_like(flat)
                     for _ in range(self.mesh.shape[axis])]
            dist.all_gather(parts, flat, group=self.mesh.group(axis))
            offset = 0
            for name in names:
                piece = updated[name]
                n = piece.numel()
                full = torch.cat([part[offset:offset + n].view(piece.shape)
                                  for part in parts], dim=self.zero1[name].dim)
                params[name].copy_(full)
                offset += n

    def _full_moment(self, name: str, part: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return part
        return gather_full(part, self.moment_layouts[name], self.mesh)

    def state_dict(self) -> dict:
        """The state with the FULL moments, whatever the layout, so a
        checkpoint does not depend on it (a collective on a mesh: every rank
        calls it)."""
        return {"count": self.count,
                "mu": {n: self._full_moment(n, v) for n, v in self.mu.items()},
                "nu": {n: self._full_moment(n, v) for n, v in self.nu.items()},
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite,
                "last_finite": self.last_finite}

    def load_state_dict(self, state: Mapping) -> None:
        """Restore what :meth:`state_dict` gave, at any layout: each rank
        keeps its part of the full moments. Moments for another set of
        parameters than this optimizer trains raise: the construction
        changed, and nothing is reshuffled quietly."""
        for kind in ("mu", "nu"):
            if set(state[kind]) != set(self.mu):
                raise ValueError(
                    f"optimizer state holds {kind} for "
                    f"{len(state[kind])} parameters, this optimizer trains "
                    f"{len(self.mu)}: "
                    f"{sorted(set(state[kind]) ^ set(self.mu))[:6]}")
        dev = self.count.device
        for name in self.mu:
            for kind, mine in (("mu", self.mu), ("nu", self.nu)):
                value = state[kind][name]
                if self.mesh is not None:
                    layout = self.moment_layouts[name]
                    if not layout.replicated and \
                            value.shape[layout.dim] == mine[name].shape[
                                layout.dim] * self.mesh.shape[layout.axis]:
                        value = local_slice(value, layout, self.mesh)
                if value.shape != mine[name].shape:
                    raise ValueError(f"{kind}[{name}]: stored "
                                     f"{tuple(value.shape)}, this rank's "
                                     f"part {tuple(mine[name].shape)}")
                mine[name] = value.to(dev, mine[name].dtype).clone()
        self.count = state["count"].to(dev, torch.int32).clone()
        self.notfinite_count = state["notfinite_count"].to(
            dev, torch.int32).clone()
        self.total_notfinite = state["total_notfinite"].to(
            dev, torch.int32).clone()
        self.last_finite = state["last_finite"].to(dev, torch.bool).clone()


def build_optimizer(cfg: TrainConfig, model: nn.Module,
                    mesh: Optional[ProcessMesh] = None,
                    layouts: Optional[Mapping[str, Layout]] = None,
                    zero1_axis: Optional[str] = None) -> Optimizer:
    """The optimizer for ``model``'s parameters; sets ``requires_grad`` by
    the freeze policy as it goes."""
    return Optimizer(cfg, dict(model.named_parameters()), mesh, layouts,
                     zero1_axis)
