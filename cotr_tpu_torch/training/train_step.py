"""The train and evaluation steps (counterpart of
cotr_tpu/training/train_step.py): forward + cycle forward + backward + Adam
on one device.

Where the JAX step is a pure function of (state, batch, dropout key), this
one updates the model and the optimizer in place and returns the state with
its step counted up; the dropout masks come from a ``torch.Generator`` on the
model's device, and the same generator state gives the same step. Nothing in
a step reads a value back on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from cotr_tpu_torch.config import TrainConfig
from cotr_tpu_torch.data.device_synth import synth_supervision_batch
from cotr_tpu_torch.models.cotr import COTRModel, init_weights
from cotr_tpu_torch.ops.canvas import (canvas_from_crops_and_homographies,
                                       normalize_canvas)
from cotr_tpu_torch.training.loss import cotr_loss
from cotr_tpu_torch.training.optim import Optimizer, build_optimizer
from cotr_tpu_torch.utils.device import resolve_device


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
                       device="cuda") -> TrainState:
    """Step 0: ``model`` on ``device`` with its optimizer. With a (CPU)
    ``generator`` the weights are drawn afresh from it; without one the
    model keeps the weights it holds (a warm start)."""
    dev = resolve_device(device)
    if generator is not None:
        init_weights(model, generator)
    model.to(dev)
    return TrainState(0, model, build_optimizer(cfg, model))


def make_train_step(cfg: TrainConfig) -> Callable:
    """Returns train_step(state, batch, generator) -> (state, metrics).

    batch: tensors on the model's device, {'image': (B, 256, 512, 3),
    'queries': (B, Q, 2), 'targets': (B, Q, 2)}, the crop layout of
    :func:`batch_canvas` or the candidate layout of :func:`batch_views`
    (whose scores come from ``generator`` before the dropout masks do).
    metrics: ``loss``, ``corr_loss``, ``cycle_loss``
    (device scalars), ``pred`` and ``target``, all detached."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        model, optimizer = state.model, state.optimizer
        model.train()
        canvas, queries, targets, weights = batch_views(
            batch, cfg, generator=generator)
        optimizer.zero_grad()
        loss, metrics = cotr_loss(
            model, canvas, queries, targets, cycle_consis=cfg.cycle_consis,
            bidirectional=cfg.bidirectional, generator=generator,
            weights=weights)
        loss.backward()
        optimizer.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(state.step + 1, model, optimizer), metrics

    return train_step


def make_eval_step(cfg: TrainConfig) -> Callable:
    """Returns eval_step(model, batch) -> {'val_loss', 'pred'}: one
    deterministic forward without a gradient, so its attention goes through
    the hand-written kernels on the card. A candidate-layout batch draws
    its selection scores from a generator seeded 0 at every call."""

    @torch.no_grad()
    def eval_step(model: COTRModel, batch: Dict[str, torch.Tensor]):
        model.eval()
        kw = {}
        if "cand" in batch:
            kw["generator"] = torch.Generator(
                device=batch["cand"].device).manual_seed(0)
        canvas, queries, targets, weights = batch_views(batch, cfg, **kw)
        pred = model(canvas, queries)
        if weights is None:
            val = ((pred - targets) ** 2).mean()
        else:
            w = weights.to(pred.dtype)[..., None]
            val = ((pred - targets) ** 2 * w).sum() / \
                (w.sum() * pred.shape[-1]).clamp(min=1.0)
        return {"val_loss": val, "pred": pred}

    return eval_step
