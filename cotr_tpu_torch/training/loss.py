"""Training losses: correspondence MSE + cycle consistency (counterpart of
cotr_tpu/training/loss.py).

* main loss: MSE(pred, target) over normalized canvas coordinates;
* bidirectional cycle loss: the predictions go back in as queries, the pairs
  whose round trip lands within 10/256 of the original query are kept, and
  their MSE is added. The gradient flows through BOTH forwards: ``pred`` is
  not detached;
* unidirectional variant: the canvas halves are swapped and x is shifted by
  0.5 on both legs.

A training step therefore runs two full forwards and one backward. The
model's mode decides whether dropout is active; each forward draws its own
keep masks from ``generator``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from cotr_tpu_torch.utils.constants import MAX_SIZE

CYCLE_THRESH = 10.0 / MAX_SIZE


def masked_mse(err_sq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``mse_loss(x[mask], y[mask])`` without the indexing: the mean of the
    squared error over the selected (B, Q) vectors' elements, 0 (with a zero
    gradient) when nothing is selected, and no count read back on the
    host."""
    mask_f = mask.to(err_sq.dtype)[..., None]
    total = (err_sq * mask_f).sum()
    count = mask_f.sum() * err_sq.shape[-1]
    return torch.where(count > 0, total / count.clamp(min=1.0), 0.0)


def _shift_x(xy: torch.Tensor, dx: float) -> torch.Tensor:
    return torch.cat([xy[..., :1] + dx, xy[..., 1:]], dim=-1)


def cotr_loss(model, canvas: torch.Tensor, queries: torch.Tensor,
              targets: torch.Tensor, *, cycle_consis: bool = True,
              bidirectional: bool = True,
              generator: Optional[torch.Generator] = None,
              weights: Optional[torch.Tensor] = None,
              reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (loss, metrics).

    ``weights`` (B, Q), optional per-query validity: a pick of weight 0
    counts in neither term and both terms normalize by the weight sum.

    ``reduce``, under data parallelism: a function that sums a small tensor
    over the ranks of the data group (outside autograd). The terms are then
    normalized by the GLOBAL counts (the elements, the weight sum, the
    cycle-consistent picks), so the returned loss is this rank's share of
    the global batch's loss: the sum over the ranks of the losses, and of
    their gradients, is the one-process step's. The metrics ``loss``,
    ``corr_loss`` and ``cycle_loss`` are the global values; ``pred`` and
    ``target`` stay this rank's."""
    pred = model(canvas, queries, generator=generator)
    err_sq = (pred - targets) ** 2
    if weights is not None:
        w = weights.to(pred.dtype)[..., None]
        corr_num, corr_count = (err_sq * w).sum(), w.sum() * pred.shape[-1]
    cycle_sq = mask = None
    if cycle_consis:
        if bidirectional:
            cycle = model(canvas, pred, generator=generator)
        else:
            canvas_rev = torch.cat([canvas[:, :, MAX_SIZE:],
                                    canvas[:, :, :MAX_SIZE]], dim=2)
            cycle = _shift_x(model(canvas_rev, _shift_x(pred, -0.5),
                                   generator=generator), -0.5)
        mask = torch.linalg.norm(cycle - queries, dim=-1) < CYCLE_THRESH
        if weights is not None:
            mask = mask & (weights > 0)
        cycle_sq = (cycle - queries) ** 2

    if reduce is None:
        corr_loss = err_sq.mean() if weights is None else \
            corr_num / corr_count.clamp(min=1.0)
        cycle_loss = pred.new_zeros(()) if cycle_sq is None else \
            masked_mse(cycle_sq, mask)
        loss = corr_loss if cycle_sq is None else corr_loss + cycle_loss
        metrics = {"loss": loss, "corr_loss": corr_loss,
                   "cycle_loss": cycle_loss}
    else:
        if weights is None:
            corr_count = pred.new_full((), err_sq.numel())
        counts = [corr_count.detach()]
        if cycle_sq is not None:
            mask_f = mask.to(cycle_sq.dtype)[..., None]
            cycle_num = (cycle_sq * mask_f).sum()
            counts.append(mask_f.sum() * cycle_sq.shape[-1])
        totals = reduce(torch.stack(counts))
        if weights is None:
            # the local mean times the local share of the elements: with
            # one rank the factor is exactly 1, the one-process step's
            corr_loss = err_sq.mean() * (corr_count / totals[0])
        else:
            corr_loss = corr_num / totals[0].clamp(min=1.0)
        if cycle_sq is None:
            cycle_loss = pred.new_zeros(())
            loss = corr_loss
        else:
            cycle_loss = torch.where(totals[1] > 0,
                                     cycle_num / totals[1].clamp(min=1.0),
                                     0.0)
            loss = corr_loss + cycle_loss
        parts = reduce(torch.stack([loss.detach(), corr_loss.detach(),
                                    cycle_loss.detach()]))
        metrics = {"loss": parts[0], "corr_loss": parts[1],
                   "cycle_loss": parts[2]}
    metrics.update(pred=pred, target=targets)
    return loss, metrics
