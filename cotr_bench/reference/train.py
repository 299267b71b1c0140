"""The published training step in plain PyTorch: the loss, its gradient and
Adam.

* loss: the mean squared error of the predictions against the targets in
  canvas coordinates, plus the cycle term: the predictions go back in as
  queries over the same canvas, and the queries whose round trip lands
  within 10/256 of where they started count in a second mean squared error
  (the gradient flows through both forwards);
* Adam (beta 0.9 / 0.999, eps 1e-8 outside the root, both moments
  bias-corrected) on everything outside the backbone at the learning rate;
  the backbone is frozen when its rate is 0, as the published recipe has
  it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from cotr_bench.reference.crops import training_canvas
from cotr_bench.reference.model import PlainCOTR

CYCLE_THRESH = 10.0 / 256
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def loss_of(model: PlainCOTR, canvas, queries, targets) -> torch.Tensor:
    pred = model(canvas, queries)
    err = ((pred - targets) ** 2).mean()
    cycle = model(canvas, pred)
    sq = (cycle - queries) ** 2
    mask = (torch.linalg.norm(cycle - queries, dim=-1)
            < CYCLE_THRESH).float()[..., None]
    count = mask.sum() * sq.shape[-1]
    cyc = torch.where(count > 0, (sq * mask).sum() / count.clamp(min=1.0),
                      0.0)
    return err + cyc


def trainable(key: str) -> bool:
    return not key.startswith("backbone/")


def run_steps(weights: Dict[str, torch.Tensor], batches: List[dict],
              seed: int, lr: float, dropout: float,
              quant: Optional[Callable] = None, layers=(6, 6)) -> dict:
    """Adam steps from ``weights``, one a batch, the dropout masks drawn
    from a generator on the weights' device seeded ``seed``.

    Returns {"loss": [float a step], "grad": {key: first step's gradient},
    "params": {key: trainable weights after the last step}}."""
    dev = next(iter(weights.values())).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = {k: v.clone() for k, v in weights.items()}
    keys = [k for k in w if trainable(k)]
    mu = {k: torch.zeros_like(w[k]) for k in keys}
    nu = {k: torch.zeros_like(w[k]) for k in keys}
    losses, first_grad = [], None
    for step, batch in enumerate(batches, start=1):
        for k in keys:
            w[k].requires_grad_(True)
        model = PlainCOTR(w, quant=quant, dropout=dropout, generator=gen,
                          enc_layers=layers[0], dec_layers=layers[1])
        canvas = training_canvas(batch["crop"], batch["h_mat"])
        loss = loss_of(model, canvas, batch["queries"], batch["targets"])
        grads = torch.autograd.grad(loss, [w[k] for k in keys])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            c1 = 1.0 - BETA1 ** step
            c2 = 1.0 - BETA2 ** step
            for k, g in zip(keys, grads):
                mu[k] = (1.0 - BETA1) * g + BETA1 * mu[k]
                nu[k] = (1.0 - BETA2) * g * g + BETA2 * nu[k]
                upd = (mu[k] / c1) / ((nu[k] / c2).sqrt() + EPS)
                w[k] = (w[k].detach() - lr * upd)
        if first_grad is None:
            first_grad = {k: g.detach() for k, g in zip(keys, grads)}
    return {"loss": losses, "grad": first_grad,
            "params": {k: w[k].detach() for k in keys}}
