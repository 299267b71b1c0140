"""The train and evaluation steps (counterpart of
cotr_tpu/training/train_step.py): forward + cycle forward + backward + Adam,
on one device or over a process mesh (``parallel.mesh``).

Where the JAX step is a pure function of (state, batch, dropout key), this
one updates the model and the optimizer in place and returns the state with
its step counted up; the dropout masks come from a ``torch.Generator`` on the
model's device, and the same generator state gives the same step. Nothing in
a step reads a value back on the host.

On one card a step is replayed as a CUDA graph: the first call with a new
signature (the batch's keys, shapes, dtypes and devices; the model, the
optimizer and the generator; the addresses of the model's parameters and
buffers) runs eagerly and warms up; the second captures the batch's
canvas, the forward, the cycle forward, the loss and the backward in one
``torch.cuda.CUDAGraph`` and replays it; every later call copies the batch
into the graph's inputs and replays it. The generator is registered with
the graph, so a replay draws the masks an eager step would and moves the
generator as far. Adam's two launches run after the replay, as on an eager
step. Off the card, on a mesh and with the model's ``remat`` (its generator
``get_state``/``set_state`` cannot be captured) every step runs eagerly.

On a mesh each rank holds its rows of the global batch. The loss is
normalized by the global counts (``training.loss.cotr_loss``'s ``reduce``),
so the gradients are SUMMED over the data axis, through one flat buffer:
each rank's parameter part with the ranks that hold the same part. With a
``"model"`` axis the transformer is split as ``parallel.tp`` says; with
``zero1_axis`` the optimizer's moments as ``parallel.opt_shard`` says.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from cotr_tpu_torch.config import TrainConfig
from cotr_tpu_torch.data.device_synth import synth_supervision_batch
from cotr_tpu_torch.models.cotr import COTRModel, init_weights
from cotr_tpu_torch.ops.canvas import (canvas_from_crops_and_homographies,
                                       normalize_canvas)
from cotr_tpu_torch.parallel.mesh import (ProcessMesh, all_reduce_sum,
                                          replicate, require_process_mesh)
from cotr_tpu_torch.parallel.tp import shard_model
from cotr_tpu_torch.training.loss import cotr_loss
from cotr_tpu_torch.training.optim import Optimizer, build_optimizer
from cotr_tpu_torch.utils.device import resolve_device
from cotr_tpu_torch.utils.profiling import span


class TrainState(NamedTuple):
    #: steps taken, skipped ones included (a host integer)
    step: int
    model: COTRModel
    optimizer: Optimizer


def _prep_image(image: torch.Tensor) -> torch.Tensor:
    """A batch may carry raw uint8 canvases (a quarter of the bytes to
    upload); they are ImageNet-normalized on the device. Float canvases pass
    through as already normalized."""
    if image.dtype == torch.uint8:
        return normalize_canvas(image)
    return image


def batch_canvas(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The training canvas from either batch layout:

    * ``image``: a ready (B, 256, 512, 3) canvas (uint8 or normalized float);
    * ``crop`` + ``h_mat`` [+ ``photo``]: the B side is warped from the
      source crop on the device, inside the step.
    """
    if "image" in batch and "cand" not in batch:
        return _prep_image(batch["image"])
    return canvas_from_crops_and_homographies(batch["crop"], batch["h_mat"],
                                              batch.get("photo"))


def batch_views(batch: Dict[str, torch.Tensor], cfg: TrainConfig,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
    """(canvas, queries, targets, weights) from any batch layout:

    * ``image`` or ``crop`` + ``h_mat``, with host-made ``queries`` and
      ``targets`` (weights None);
    * ``cand`` + cameras + quantized depth: the supervision is synthesized
      here on the device (``data.device_synth``), its selection scores drawn
      from ``generator``; invalid picks carry weight 0.
    """
    if "cand" in batch:
        canvas, queries, targets, weights = synth_supervision_batch(
            batch, cfg.num_kp, cfg.bidirectional, generator=generator)
        return _prep_image(canvas), queries, targets, weights
    return batch_canvas(batch), batch["queries"], batch["targets"], None


def create_train_state(model: COTRModel, cfg: TrainConfig,
                       generator: Optional[torch.Generator] = None,
                       device="cuda", mesh: Optional[ProcessMesh] = None,
                       zero1_axis: Optional[str] = None) -> TrainState:
    """Step 0: ``model`` on ``device`` with its optimizer. With a (CPU)
    ``generator`` the weights are drawn afresh from it; without one the
    model keeps the weights it holds (a warm start).

    On a process ``mesh`` the model goes to the rank's device and takes
    global rank 0's weights, then its transformer is split over the mesh's
    ``"model"`` axis if it has one; ``zero1_axis`` splits the replicated
    parameters' moments."""
    if generator is not None:
        init_weights(model, generator)
    if mesh is None:
        model.to(resolve_device(device))
        return TrainState(0, model, build_optimizer(cfg, model))
    mesh = require_process_mesh(mesh, "create_train_state")
    replicate(model, mesh)
    layouts = shard_model(model, mesh)
    return TrainState(0, model, build_optimizer(cfg, model, mesh, layouts,
                                                zero1_axis))


def _reduce_over(mesh: ProcessMesh, axis: str = "data"):
    group = mesh.group(axis)
    return lambda t: all_reduce_sum(t, group)


@torch.no_grad()
def reduce_gradients(params, mesh: ProcessMesh, axis: str = "data") -> None:
    """Sum every trainable parameter's ``.grad`` over ``axis``, through one
    flat buffer (each rank's gradients are of its share of the loss)."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=mesh.group(axis))
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


class _StepGraph(NamedTuple):
    """One captured step: the graph, its batch (copied into before each
    replay), its metrics and the gradients it writes, each parameter with
    its own."""
    graph: "torch.cuda.CUDAGraph"
    batch: Dict[str, torch.Tensor]
    metrics: Dict[str, torch.Tensor]
    grads: Tuple[Tuple[torch.nn.Parameter, torch.Tensor], ...]


def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def _graph_signature(model: COTRModel, optimizer: Optimizer,
                     batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator]
                     ) -> Optional[tuple]:
    """What a captured step is kept under, or None where a step runs
    eagerly: off the card and with the model's ``remat``. A new batch
    layout or shape, a new model, optimizer or generator object, or a
    parameter or buffer at a new address is a new signature."""
    device = optimizer.count.device
    if not _on_card(device) or model.transformer.remat:
        return None
    layout = tuple((k, tuple(v.shape), v.dtype, v.device)
                   for k, v in sorted(batch.items()))
    if any(dev != device for *_, dev in layout):
        return None
    return (id(model), id(optimizer), id(generator), layout,
            tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                        model.buffers())))


def make_train_step(cfg: TrainConfig,
                    mesh: Optional[ProcessMesh] = None) -> Callable:
    """Returns train_step(state, batch, generator) -> (state, metrics).

    batch: tensors on the model's device, {'image': (B, 256, 512, 3),
    'queries': (B, Q, 2), 'targets': (B, Q, 2)}, the crop layout of
    :func:`batch_canvas` or the candidate layout of :func:`batch_views`
    (whose scores come from ``generator`` before the dropout masks do).
    metrics: ``loss``, ``corr_loss``, ``cycle_loss``
    (device scalars), ``pred`` and ``target``, all detached; on a replayed
    step copies, which later steps leave as they are.

    With a process ``mesh``: B is this rank's rows; the metrics' losses are
    the global batch's, ``pred`` and ``target`` this rank's. Each rank draws
    its masks from its own ``generator`` (seeded apart on the data axis).

    On one card the step is a CUDA graph from a signature's second call on
    (the module's docstring). The graphs of one step function share one
    memory pool. ``train_step.counts`` counts the steps by path:
    ``captures``, ``replays`` (the capturing call's own included) and
    ``eager``; ``train_step.eager`` runs one step eagerly whatever the
    signature."""
    reduce = None
    if mesh is not None:
        mesh = require_process_mesh(mesh, "make_train_step")
        reduce = _reduce_over(mesh)
    graphs: Dict[tuple, _StepGraph] = {}
    #: signatures whose first call has run, each with its model, optimizer
    #: and generator, kept alive so that the ids in it name no other object
    warmed: Dict[tuple, tuple] = {}
    pool = None
    counts = {"captures": 0, "replays": 0, "eager": 0}

    def loss_of(model, batch, generator):
        canvas, queries, targets, weights = batch_views(
            batch, cfg, generator=generator)
        return cotr_loss(model, canvas, queries, targets,
                         cycle_consis=cfg.cycle_consis,
                         bidirectional=cfg.bidirectional, generator=generator,
                         weights=weights, reduce=reduce)

    def eager(state: TrainState, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None):
        with span("cotr.train.step"):
            model, optimizer = state.model, state.optimizer
            model.train()
            with span("cotr.train.forward"):
                optimizer.zero_grad()
                loss, metrics = loss_of(model, batch, generator)
            with span("cotr.train.backward"):
                loss.backward()
                if mesh is not None:
                    reduce_gradients(model.parameters(), mesh)
            with span("cotr.train.optimizer"):
                optimizer.step()
            counts["eager"] += 1
            metrics = {k: v.detach() for k, v in metrics.items()}
            return TrainState(state.step + 1, model, optimizer), metrics

    def capture(model, optimizer, batch, generator) -> _StepGraph:
        """The step from the batch to the gradients as one graph, on a copy
        of ``batch``; the gradients are None at capture, so the graph
        writes them afresh."""
        nonlocal pool
        static = {k: v.clone() for k, v in batch.items()}
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        if pool is None:
            pool = torch.cuda.graph_pool_handle()
        optimizer.zero_grad()
        with torch.cuda.graph(graph, pool=pool):
            loss, metrics = loss_of(model, static, generator)
            loss.backward()
        counts["captures"] += 1
        return _StepGraph(
            graph, static, {k: v.detach() for k, v in metrics.items()},
            tuple((p, p.grad) for p in optimizer.params.values()))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        model, optimizer = state.model, state.optimizer
        key = None if mesh is not None else \
            _graph_signature(model, optimizer, batch, generator)
        if key is None:
            return eager(state, batch, generator)
        step_graph = graphs.get(key)
        if step_graph is None:
            if key not in warmed:
                warmed[key] = (model, optimizer, generator)
                return eager(state, batch, generator)
        with span("cotr.train.step"):
            model.train()
            if step_graph is None:
                step_graph = graphs[key] = capture(model, optimizer, batch,
                                                   generator)
            with span("cotr.train.replay"):
                for k, v in step_graph.batch.items():
                    v.copy_(batch[k])
                for p, g in step_graph.grads:
                    if p.grad is not g:
                        p.grad = g
                step_graph.graph.replay()
            counts["replays"] += 1
            with span("cotr.train.optimizer"):
                optimizer.step()
            metrics = {k: v.clone() for k, v in step_graph.metrics.items()}
            return TrainState(state.step + 1, model, optimizer), metrics

    train_step.counts = counts
    train_step.eager = eager
    return train_step


def make_eval_step(cfg: TrainConfig,
                   mesh: Optional[ProcessMesh] = None) -> Callable:
    """Returns eval_step(model, batch) -> {'val_loss', 'pred'}: one
    deterministic forward without a gradient, so its attention goes through
    the hand-written kernels on the card. A candidate-layout batch draws
    its selection scores from a generator seeded 0 at every call.

    With a process ``mesh``: ``val_loss`` is the global batch's, normalized
    as the training loss is; ``pred`` this rank's rows."""
    reduce = None
    if mesh is not None:
        reduce = _reduce_over(require_process_mesh(mesh, "make_eval_step"))

    @torch.no_grad()
    def eval_step(model: COTRModel, batch: Dict[str, torch.Tensor]):
        model.eval()
        kw = {}
        if "cand" in batch:
            kw["generator"] = torch.Generator(
                device=batch["cand"].device).manual_seed(0)
        canvas, queries, targets, weights = batch_views(batch, cfg, **kw)
        pred = model(canvas, queries)
        err_sq = (pred - targets) ** 2
        if weights is None:
            if reduce is None:
                return {"val_loss": err_sq.mean(), "pred": pred}
            num, count = err_sq.sum(), pred.new_full((), err_sq.numel())
        else:
            w = weights.to(pred.dtype)[..., None]
            num, count = (err_sq * w).sum(), w.sum() * pred.shape[-1]
        if reduce is not None:
            num, count = reduce(torch.stack([num, count]))
        return {"val_loss": num / count.clamp(min=1.0), "pred": pred}

    return eval_step
