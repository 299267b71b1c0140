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
update uses the base rate. Every decision is taken on the device: a step
reads nothing back on the host.

On the card a step is the two kernels of ``csrc/adam.cu`` (built with
``nvcc`` for ``sm_90a`` into ``build/`` at first use, bound with ctypes):
one finite check over every gradient, then one Adam pass that updates the
weights and moments in place and moves the counters. On the CPU it is
:meth:`Optimizer.step_plain`, the same arithmetic as an eager loop of
PyTorch ops, which the kernels equal to the bit on the card.

On a process mesh (``parallel.mesh``) the optimizer takes each parameter's
layout: a parameter that tensor parallelism splits keeps the moments of its
part; with ``zero1_axis`` the moments of a replicated parameter are split
over that axis (``parallel.opt_shard``), each rank updates its slice and the
updated slices are gathered into the parameter in one collective. The
finite-step flag is reduced over every rank first, so the ranks skip a step
alike. ``state_dict`` holds the full moments whatever the layout.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from cotr_tpu_torch import native
from cotr_tpu_torch.config import TrainConfig
from cotr_tpu_torch.parallel.mesh import (REPLICATED, Layout, ProcessMesh,
                                          gather_full, local_slice,
                                          require_process_mesh)
from cotr_tpu_torch.parallel.opt_shard import opt_state_shardings

_TRAINABLE_BACKBONE_STAGES = ("layer2", "layer3", "layer4")
_BETA1, _BETA2, _EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 100
#: elements a block of the Adam kernels takes
KERNEL_CHUNK = 16384

#: launches of ``csrc/adam.cu``'s kernels since the last reset (set it to 0
#: to start a count): two a step on the card
launches = 0

_lib = None
_lib_lock = threading.Lock()


class _Step(ctypes.Structure):
    """``AdamStep`` of ``csrc/adam.cu``: the device scalars a step reads and
    moves, and its constants as float32."""
    _fields_ = [("flag", ctypes.c_void_p), ("count", ctypes.c_void_p),
                ("notfinite", ctypes.c_void_p),
                ("total_notfinite", ctypes.c_void_p),
                ("last_finite", ctypes.c_void_p), ("done", ctypes.c_void_p),
                ("one_minus_beta1", ctypes.c_float),
                ("beta1", ctypes.c_float),
                ("one_minus_beta2", ctypes.c_float),
                ("beta2", ctypes.c_float), ("eps", ctypes.c_float),
                ("base_lr", ctypes.c_float * 2), ("cosine", ctypes.c_int),
                ("decay_steps", ctypes.c_int),
                ("inv_decay_steps", ctypes.c_float), ("pi", ctypes.c_float),
                ("one_minus_final", ctypes.c_float),
                ("final_frac", ctypes.c_float), ("max_errors", ctypes.c_int)]


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build_cuda_library("adam")))
            lib.cotr_adam_finite.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.cotr_adam_update.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(_Step), ctypes.c_void_p]
            lib.cotr_adam_finite.restype = ctypes.c_int
            lib.cotr_adam_update.restype = ctypes.c_int
            lib.cotr_adam_step_layout.argtypes = [ctypes.c_void_p]
            lib.cotr_adam_step_layout.restype = ctypes.c_int
            _check_step_layout(lib)
            _lib = lib
        return _lib


def _step_layout() -> List[int]:
    """``_Step``'s size, then each field's offset in declaration order."""
    return [ctypes.sizeof(_Step)] + [getattr(_Step, name).offset
                                     for name, _ in _Step._fields_]


def _check_step_layout(lib) -> None:
    """Raise unless ``_Step`` lays its fields out as the library's
    ``AdamStep`` does: a field added, moved or retyped on one side only
    would have the kernel read the wrong scalars."""
    want = _step_layout()
    out = (ctypes.c_int64 * (len(want) + 8))()
    got = list(out[:lib.cotr_adam_step_layout(out)])
    if got != want:
        raise RuntimeError(f"optim._Step does not mirror csrc/adam.cu's "
                           f"AdamStep: size and offsets {want} here, {got} "
                           f"in the library")


def _raise_on(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"Adam kernel launch failed: CUDA error {err}")


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
        self.mu = {n: torch.zeros_like(self._moment_part(n, p),
                                       memory_format=torch.contiguous_format)
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(self._moment_part(n, p),
                                       memory_format=torch.contiguous_format)
                   for n, p in params.items()}
        # the kernels' tables on the card, rebuilt when an address changes
        self._table_key: Optional[List[int]] = None
        self._table: Optional[torch.Tensor] = None
        self._chunks: Optional[List[int]] = None
        self._flag: Optional[torch.Tensor] = None
        self._done: Optional[torch.Tensor] = None

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
        """One Adam step from each parameter's ``.grad``: the kernels on the
        card, :meth:`step_plain` on the CPU."""
        device = self.count.device
        if device.type == "cuda":
            self._step_kernel()
        elif device.type == "cpu":
            self.step_plain()
        else:
            raise ValueError(f"no optimizer path for device {device}")

    @torch.no_grad()
    def step_plain(self) -> None:
        """The kernels' plain version: the step as an eager loop of PyTorch
        ops over the tensors, on any device."""
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

    def _step_kernel(self) -> None:
        """The step as ``csrc/adam.cu``'s two launches, with no host read:
        the finite check into ``_flag``, its minimum over the ranks on a
        mesh, then the Adam pass, in place. A ZeRO-1 part goes to the
        kernel contiguous (a copy where its slice is not) and is gathered
        into its parameter after."""
        global launches
        tensors, updated = [], {}
        for group in self.groups.values():
            for name, p in group.items():
                g = self._moment_part(name, p.grad).contiguous()
                w = p
                if name in self.zero1:
                    w = self._moment_part(name, p).contiguous()
                    updated[name] = w
                tensors.append((w, g, self.mu[name], self.nu[name]))
        lib = _library()
        with torch.cuda.device(self.count.device):
            table = self._kernel_table(tensors)
            stream = torch.cuda.current_stream().cuda_stream
            n_chunks = len(self._chunks) // 2
            _raise_on(lib.cotr_adam_finite(
                table.data_ptr(), len(tensors), n_chunks, KERNEL_CHUNK,
                self._flag.data_ptr(), stream))
            launches += 1
            if self.mesh is not None and self.mesh.size > 1:
                # each rank may see another part of the gradient: one
                # decision
                dist.all_reduce(self._flag, op=dist.ReduceOp.MIN)
            _raise_on(lib.cotr_adam_update(
                table.data_ptr(), len(tensors), n_chunks, KERNEL_CHUNK,
                ctypes.byref(self._kernel_step()), stream))
            launches += 1
        if updated:
            self._gather_updated(updated)

    def _kernel_table(self, tensors: List[tuple]) -> torch.Tensor:
        """The kernels' tensor and chunk tables on the card, uploaded again
        (from pinned memory, without a wait) only when an address changed:
        with the gradients set to None each step, the caching allocator
        mostly hands back the same blocks, and a reload of the state gives
        new moments."""
        key = [t.data_ptr() for quad in tensors for t in quad]
        if key == self._table_key:
            return self._table
        for name, quad in zip(self.mu, tensors):
            for t in quad:
                if t.dtype != torch.float32 or not t.is_contiguous() \
                        or t.device != self.count.device:
                    raise ValueError(
                        f"the Adam kernels take contiguous float32 tensors "
                        f"on {self.count.device}; {name} has a "
                        f"{t.dtype} tensor of strides {t.stride()} on "
                        f"{t.device}")
        if self._chunks is None:
            self._chunks = [c for i, (w, _, _, _) in enumerate(tensors)
                            for start in range(0, w.numel(), KERNEL_CHUNK)
                            for c in (i, start)]
            dev = self.count.device
            self._flag = torch.ones((), dtype=torch.int32, device=dev)
            self._done = torch.zeros((), dtype=torch.int32, device=dev)
        groups = [gi for gi, group in enumerate(self.groups.values())
                  for _ in group]
        rows = [v for i, quad in enumerate(tensors)
                for v in (*key[4 * i:4 * i + 4], quad[0].numel(), groups[i])]
        host = torch.tensor(rows + self._chunks, dtype=torch.int64)
        if self._table is None:
            self._table = torch.empty_like(host, device=self.count.device)
        # the caching host allocator keeps the pinned block until the copy
        # has run
        self._table.copy_(host.pin_memory(), non_blocking=True)
        self._table_key = key
        return self._table

    def _kernel_step(self) -> _Step:
        """The step's device scalars and its constants, each Python float
        rounded to float32 as a PyTorch op rounds it."""
        cfg = self.cfg
        f32 = np.float32
        steps = max(cfg.lr_decay_steps, 1)
        return _Step(
            self._flag.data_ptr(), self.count.data_ptr(),
            self.notfinite_count.data_ptr(), self.total_notfinite.data_ptr(),
            self.last_finite.data_ptr(), self._done.data_ptr(),
            f32(1.0 - _BETA1), f32(_BETA1), f32(1.0 - _BETA2), f32(_BETA2),
            f32(_EPS),
            (ctypes.c_float * 2)(f32(self.base_lr["main"]),
                                 f32(self.base_lr["backbone"])),
            int(cfg.lr_schedule == "cosine" and cfg.lr_decay_steps > 0),
            steps,
            # PyTorch on the card divides a float32 tensor by a host scalar
            # as a product with the scalar's float32 reciprocal
            f32(1.0) / f32(steps), f32(math.pi), f32(1.0 - cfg.lr_final_frac),
            f32(cfg.lr_final_frac), MAX_CONSECUTIVE_ERRORS)

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
        full = part if self.mesh is None else \
            gather_full(part, self.moment_layouts[name], self.mesh)
        return part.clone() if full is part else full

    def state_dict(self) -> dict:
        """The state with the FULL moments, whatever the layout, so a
        checkpoint does not depend on it (a collective on a mesh: every rank
        calls it). Copies: the kernels update the state in place, and a
        kept state dict does not see later steps."""
        return {"count": self.count.clone(),
                "mu": {n: self._full_moment(n, v) for n, v in self.mu.items()},
                "nu": {n: self._full_moment(n, v) for n, v in self.nu.items()},
                "notfinite_count": self.notfinite_count.clone(),
                "total_notfinite": self.total_notfinite.clone(),
                "last_finite": self.last_finite.clone()}

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
                mine[name] = value.to(dev, mine[name].dtype).clone(
                    memory_format=torch.contiguous_format)
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
