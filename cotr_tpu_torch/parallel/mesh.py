"""Device meshes and the batch layout (counterpart of
cotr_tpu/parallel/mesh.py).

A :class:`Mesh` has axis names and a size on each, and comes in two kinds.

* A **process mesh** (:class:`ProcessMesh`) is built inside an initialized
  ``torch.distributed`` process group: one device per rank, over
  ``torch.distributed.device_mesh.init_device_mesh``, with the axes
  ``("data",)`` or ``("data", "model")``. The train step and the ``Trainer``
  take it; the collectives run over NCCL on cards and gloo on the CPU.
  Users start the ranks with ``torchrun`` (part of torch).
* A **local mesh** (:class:`LocalMesh`) is built with no process group: a
  list of this process's devices, in which a device may stand more than
  once. The engines and steppers take it and split their task or squad axis
  over its entries, which keeps the JAX package's single-process serving
  API (``FasterSparseEngine(runner, mesh=make_mesh(8))``). A device listed
  N times runs its N shares one after another: that proves the partitioning
  and the equality of the answers, not a speed.

Each consumer raises on the other kind. :class:`Layout` stands for the JAX
package's ``PartitionSpec``: which dimension of a tensor is split over which
axis, in the torch tensor's own dimension order.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from cotr_tpu_torch.utils.device import resolve_device

#: how long a rendezvous or a collective may wait for the other ranks
PROCESS_GROUP_TIMEOUT = datetime.timedelta(seconds=60)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a tensor's elements live on a mesh: dimension ``dim`` split in
    equal parts over ``axis``, or every rank holding all of it (``dim``
    None)."""

    dim: Optional[int] = None
    axis: Optional[str] = None

    @property
    def replicated(self) -> bool:
        return self.dim is None

    def spec(self, ndim: int) -> Tuple[Optional[str], ...]:
        """The axis name of each dimension, as a ``PartitionSpec`` lists
        them."""
        out: List[Optional[str]] = [None] * ndim
        if self.dim is not None:
            out[self.dim] = self.axis
        return tuple(out)


REPLICATED = Layout()


class Mesh:
    """Axis names and a size on each (``shape``, a dict as the JAX mesh's
    ``.shape``)."""

    kind = ""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n


class ProcessMesh(Mesh):
    """One device per rank of the process group (see the module's
    docstring). ``device`` is this rank's device."""

    kind = "process"

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 device: torch.device):
        super().__init__(axis_names, sizes)
        from torch.distributed.device_mesh import init_device_mesh

        self.device = device
        self.device_mesh = init_device_mesh(
            device.type, tuple(sizes), mesh_dim_names=self.axis_names)

    def group(self, axis: str):
        """The process group of the ranks that differ from this one only in
        their coordinate on ``axis``."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        return self.device_mesh.get_coordinate()[self.axis_names.index(axis)]


class LocalMesh(Mesh):
    """A list of this process's devices on one axis; a device may stand
    more than once (see the module's docstring)."""

    kind = "local"

    def __init__(self, devices: Sequence[torch.device],
                 axis_name: str = "data"):
        if not devices:
            raise ValueError("a local mesh needs at least one device")
        super().__init__((axis_name,), (len(devices),))
        self.devices = tuple(devices)


def require_process_mesh(mesh: Mesh, who: str) -> ProcessMesh:
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(f"{who} takes a process mesh (built by make_mesh "
                        "inside an initialized torch.distributed process "
                        f"group), got a {mesh.kind or type(mesh).__name__} "
                        "mesh")
    return mesh


def require_local_mesh(mesh: Mesh, who: str) -> LocalMesh:
    if not isinstance(mesh, LocalMesh):
        raise TypeError(f"{who} takes a local mesh (a list of this "
                        "process's devices, built by make_mesh with no "
                        f"process group), got a {mesh.kind or type(mesh).__name__} "
                        "mesh")
    return mesh


def rank_device(device="cuda") -> torch.device:
    """This rank's device: for the card, ``cuda:LOCAL_RANK`` (as
    ``torchrun`` sets it; else the rank modulo the cards present); the CPU
    as it is. Asking for the card where there is none raises."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else \
        (dist.get_rank() if dist.is_initialized() else 0) \
        % torch.cuda.device_count()
    return torch.device("cuda", index)


def process_group_device() -> torch.device:
    return rank_device("cuda" if dist.get_backend() == "nccl" else "cpu")


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
              devices: Optional[Sequence] = None) -> Mesh:
    """A one-axis mesh.

    * ``devices`` given: a local mesh over that list (``num_devices``, if
      given, must be its length);
    * inside an initialized process group: the process mesh of every rank
      (``num_devices``, if given, must equal the world size);
    * otherwise: a local mesh over the first ``num_devices`` cards (all of
      them by default); fewer cards than asked, or none, raises.
    """
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if num_devices is not None and num_devices != len(devs):
            raise ValueError(f"num_devices={num_devices} but {len(devs)} "
                             "devices listed")
        return LocalMesh(devs, axis_name)
    if dist.is_initialized():
        world = dist.get_world_size()
        if num_devices is not None and num_devices != world:
            raise ValueError(f"num_devices={num_devices} but the process "
                             f"group has {world} ranks")
        return ProcessMesh((axis_name,), (world,), process_group_device())
    resolve_device("cuda")
    count = torch.cuda.device_count()
    n = count if num_devices is None else num_devices
    if n > count:
        raise ValueError(f"asked for {n} cards, {count} present; list the "
                         "devices to repeat one")
    return LocalMesh([torch.device("cuda", i) for i in range(n)], axis_name)


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> Layout:
    """The layout of a batch: its leading axis split over ``axis_name``."""
    return Layout(0, axis_name)


def replicated(mesh: Mesh) -> Layout:
    """The layout of a tensor every device holds whole."""
    return REPLICATED


def local_slice(tensor: torch.Tensor, layout: Layout,
                mesh: ProcessMesh) -> torch.Tensor:
    """This rank's part of a full ``tensor`` under ``layout`` (a view)."""
    if layout.replicated:
        return tensor
    n = mesh.shape[layout.axis]
    if tensor.shape[layout.dim] % n:
        raise ValueError(f"dim {layout.dim} of {tuple(tensor.shape)} does "
                         f"not split in {n}")
    return tensor.chunk(n, layout.dim)[mesh.coordinate(layout.axis)]


def gather_full(tensor: torch.Tensor, layout: Layout,
                mesh: ProcessMesh) -> torch.Tensor:
    """The full tensor from every rank's part under ``layout`` (a
    collective: every rank of the axis's group calls it)."""
    if layout.replicated or mesh.shape[layout.axis] == 1:
        return tensor
    part = tensor.contiguous()
    parts = [torch.empty_like(part) for _ in range(mesh.shape[layout.axis])]
    dist.all_gather(parts, part, group=mesh.group(layout.axis))
    return torch.cat(parts, dim=layout.dim)


def _rows(x, index: int, count: int):
    if x.shape[0] % count:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                         f"over {count} devices")
    k = x.shape[0] // count
    return x[index * k:(index + 1) * k]


def data_rows(x, mesh: ProcessMesh, axis_name: str = "data"):
    """This rank's rows of a global batch's array or tensor, where it is
    (a view: nothing moves)."""
    return _rows(x, mesh.coordinate(axis_name), mesh.shape[axis_name])


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def shard_batch(batch: Any, mesh: Mesh, axis_name: str = "data") -> Any:
    """Split every tensor (or array) of ``batch`` (a tensor or a dict of
    them) on its leading axis over ``axis_name``. On a process mesh: this
    rank's rows of the global batch, on its device. On a local mesh: one
    part for each entry of the mesh, on that entry's device, in order."""
    def one(x):
        x = _as_tensor(x)
        if isinstance(mesh, ProcessMesh):
            return data_rows(x, mesh, axis_name).to(mesh.device)
        local = require_local_mesh(mesh, "shard_batch")
        return [_rows(x, i, len(local.devices)).to(dev)
                for i, dev in enumerate(local.devices)]

    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)


def shard_batch_multihost(batch: Any, mesh: Mesh,
                          axis_name: str = "data") -> Any:
    """A batch whose rows each rank's loader made for it alone (its slice
    of the global batch, ``PrefetchLoader(shard=...)``), on this rank's
    device."""
    mesh = require_process_mesh(mesh, "shard_batch_multihost")
    if isinstance(batch, dict):
        return {k: _as_tensor(v).to(mesh.device) for k, v in batch.items()}
    return _as_tensor(batch).to(mesh.device)


def replicate(tree: Any, mesh: Mesh,
              home: Optional[torch.device] = None) -> Any:
    """The same values everywhere.

    On a process mesh: every tensor of ``tree`` (a module, whose parameters
    and buffers change in place, a tensor or a dict of tensors) takes global
    rank 0's values, on this rank's device. On a local mesh: one copy for
    each entry of the mesh, made once for each distinct device and shared by
    repeated entries; on its own device (``home``, or where its tensors
    are) ``tree`` is its own copy."""
    if isinstance(mesh, ProcessMesh):
        return _broadcast(tree, mesh)
    local = require_local_mesh(mesh, "replicate")
    home = _device_of(tree) if home is None else home
    copies: Dict[torch.device, Any] = {}
    out = []
    for dev in local.devices:
        if dev not in copies:
            copies[dev] = tree if _same_device(home, dev) else \
                _copy_to(tree, dev)
        out.append(copies[dev])
    return out


def _device_of(tree) -> Optional[torch.device]:
    if torch.is_tensor(tree):
        return tree.device
    if isinstance(tree, nn.Module):
        first = next(iter(tree.parameters()), None)
        return first.device if first is not None else None
    if isinstance(tree, dict) and tree:
        return _device_of(next(iter(tree.values())))
    return None


def _same_device(a: Optional[torch.device], b: torch.device) -> bool:
    if a is None or a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    return (a.index or 0) == (b.index or 0)


def _copy_to(tree, dev: torch.device):
    if torch.is_tensor(tree):
        return tree.to(dev)
    if isinstance(tree, nn.Module):
        import copy

        return copy.deepcopy(tree).to(dev)
    if isinstance(tree, dict):
        return {k: _copy_to(v, dev) for k, v in tree.items()}
    raise TypeError(f"cannot copy a {type(tree).__name__} to {dev}")


@torch.no_grad()
def _broadcast(tree, mesh: ProcessMesh):
    if isinstance(tree, nn.Module):
        tree.to(mesh.device)
        for t in list(tree.parameters()) + list(tree.buffers()):
            dist.broadcast(t.data, src=0)
        return tree
    if torch.is_tensor(tree):
        t = tree.to(mesh.device).contiguous().clone()
        dist.broadcast(t, src=0)
        return t
    if isinstance(tree, dict):
        return {k: _broadcast(v, mesh) for k, v in tree.items()}
    raise TypeError(f"cannot replicate a {type(tree).__name__}")


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """A sum over the ranks of ``group`` into a new tensor, outside
    autograd."""
    out = tensor.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def init_distributed(device="cuda", store=None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> bool:
    """Join the process group when this process is one of several ranks:
    with ``store``, ``rank`` and ``world_size`` given, or under ``torchrun``
    (which sets ``WORLD_SIZE``, ``RANK`` and the rendezvous address in the
    environment). NCCL for the card, gloo for the CPU; a rendezvous or a
    collective waits at most ``PROCESS_GROUP_TIMEOUT``. Returns whether a
    group was started here (the caller then ends it with
    ``torch.distributed.destroy_process_group``); False when one is already
    running or the process runs alone."""
    if dist.is_initialized():
        return False
    if store is None and "WORLD_SIZE" not in os.environ:
        return False
    kw = dict(timeout=PROCESS_GROUP_TIMEOUT)
    if store is None:
        dev = rank_device(device)
    else:
        kw.update(store=store, rank=rank, world_size=world_size)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend="nccl" if dev.type == "cuda" else "gloo",
                            **kw)
    return True


def is_rank_zero() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def process_shard() -> Tuple[int, int]:
    """(rank, world size) of the running process group, (0, 1) without
    one: a data-parallel loader's ``shard``."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()
