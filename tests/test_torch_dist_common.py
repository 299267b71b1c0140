"""Multi-rank scenarios for the port's parallelism, run in spawned gloo
processes on the CPU, and the helper that runs them.

This module imports neither JAX nor anything of ``cotr_tpu``, and no test
module: a spawned child imports it by name, and must not start JAX's eight
virtual devices (``tests/conftest.py``) in each rank. The ranks meet through
a ``FileStore`` under the test's ``tmp_path`` (no TCP port), every
collective waits at most ``PROCESS_GROUP_TIMEOUT`` (60 s), and the parent
joins each child with a timeout and kills it on expiry, so a hung collective
fails its test in about a minute.

Each scenario returns a dict of tensors and numbers, which the child saves
for the parent to read; a failing child saves its traceback instead. The
parent makes the batch once and hands it to every rank, so no two
processes depend on computing the same inputs alike.
"""

import multiprocessing
import os
import traceback

import numpy as np
import torch

#: seconds a whole scenario may take before its children are killed
JOIN_TIMEOUT = 240


def _child(name, rank, world, store_path, out_dir, args):
    torch.set_num_threads(2)
    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        from cotr_tpu_torch.parallel.mesh import init_distributed

        store = torch.distributed.FileStore(store_path, world)
        init_distributed("cpu", store=store, rank=rank, world_size=world)
        try:
            result = globals()[name](rank, world, *args)
        finally:
            torch.distributed.destroy_process_group()
        torch.save(result, path)
    except BaseException:  # reported to the parent, which fails the test
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(name: str, world: int, tmp_dir, *args,
              timeout: float = JOIN_TIMEOUT) -> list:
    """Run scenario ``name`` of this module on ``world`` gloo ranks; returns
    each rank's result, in rank order. A child that fails, or outlives
    ``timeout``, fails the call with what it reported."""
    out_dir = os.path.join(str(tmp_dir), f"{name}_{world}")
    os.makedirs(out_dir, exist_ok=True)
    store_path = os.path.join(out_dir, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(name, r, world, store_path,
                                              out_dir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    import time

    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r in range(world):
        err = os.path.join(out_dir, f"rank{r}.pt.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"scenario {name} on {world} ranks: hung {hung}, exit codes "
            f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ------------------------------------------------------------ shared set-up

#: full width (d 256, 8 heads, FFN 1024), one encoder and one decoder layer
DEPTH = dict(enc_layers=1, dec_layers=1, dropout=0.0)
#: queries a sample. The CPU's matrix products round a row alike at 16 rows
#: and at 32 (at 8 they do not), so one sample's forward is bit for bit the
#: same in a batch of 1 and of 2
Q = 16


def build(seed: int = 0, dtype=torch.float32):
    """A fresh 1 + 1 model with weights drawn from ``seed``; in float64
    (after :func:`float64_patches`) for the comparisons of trained weights:
    in float32 Adam turns the rounding noise of a gradient whose true value
    is 0 (a key projection's bias: the softmax does not see a constant
    added to every logit) into a step of about ``lr``, whichever rank
    computed it."""
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.models.cotr import build_model, init_weights

    model = build_model(COTRConfig(**DEPTH))
    init_weights(model, torch.Generator().manual_seed(seed))
    if dtype == torch.float64:
        model = model.double()
        model.dtype = torch.float64
    return model


def float64_patches(setattr_=setattr):
    """The three places where the model computes in float32 whatever its
    dtype (the head, layer norm, the softmax) compute in the input's dtype
    instead, so a float64 model is float64 throughout but for its input
    embeddings. ``setattr_``: ``setattr`` in a child process, a
    monkeypatch's in a test."""
    import math

    import torch.nn.functional as F

    from cotr_tpu_torch.models import cotr, layers, transformer
    from cotr_tpu_torch.ops.attention import _check

    def head(self, x):
        return self.fc2(F.relu(self.fc1(F.relu(self.fc0(x)))))

    def layer_norm(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)

    def attention(q, k, v, key_padding_mask=None, dropout_p=0.0,
                  training=False, generator=None):
        _check(q, k, v)
        assert key_padding_mask is None and dropout_p == 0.0
        logits = torch.einsum("bqhd,bkhd->bhqk",
                              q / math.sqrt(q.shape[-1]), k)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)

    setattr_(cotr.CorrHead, "forward", head)
    setattr_(layers.LayerNorm, "forward", layer_norm)
    setattr_(transformer, "einsum_attention", attention)


def to_float64(batch: dict) -> dict:
    return {k: v.double() if v.is_floating_point() else v
            for k, v in batch.items()}


def cycle_batch(model, consistent=(6, 2), seed: int = 3) -> dict:
    """A batch of ``len(consistent)`` samples whose k-th row holds
    ``consistent[k]`` cycle-consistent queries: the fresh model answers
    nearly the same point for every query, so a query placed where the
    round trip lands passes the cycle check and a query far from it does
    not. The counts differ between the ranks that take the rows."""
    rng = np.random.RandomState(seed)
    b = len(consistent)
    image = torch.from_numpy(
        rng.uniform(-1, 1, (b, 256, 512, 3)).astype(np.float32))
    start = torch.from_numpy(
        rng.uniform(0.05, 0.45, (b, Q, 2)).astype(np.float32))
    with torch.no_grad():
        landing = model(image, model(image, start))
    far = torch.from_numpy(rng.uniform(0.05, 0.3, (b, Q, 2))
                           .astype(np.float32))
    queries = far.clone()
    for row, n in enumerate(consistent):
        queries[row, :n] = landing[row, :n]
    targets = torch.from_numpy(
        rng.uniform(0.55, 0.95, (b, Q, 2)).astype(np.float32))
    return {"image": image, "queries": queries, "targets": targets}


def cycle_counts(model, batch) -> list:
    """The cycle-consistent picks of each row under ``model``."""
    from cotr_tpu_torch.training.loss import CYCLE_THRESH

    with torch.no_grad():
        pred = model(batch["image"], batch["queries"])
        cycle = model(batch["image"], pred)
    ok = torch.linalg.norm(cycle - batch["queries"], dim=-1) < CYCLE_THRESH
    return ok.sum(dim=1).tolist()


def trained(model) -> dict:
    """The parameters the optimizer trains (backbone frozen), on the
    CPU."""
    return {k: v.detach().cpu().clone() for k, v in model.named_parameters()
            if v.requires_grad}


def one_process_steps(model, cfg, batch, steps: int) -> tuple:
    """(losses, trained weights) of ``steps`` one-process steps."""
    from cotr_tpu_torch.training import train_step as ts

    state = ts.create_train_state(model, cfg, None, "cpu")
    step = ts.make_train_step(cfg)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch, torch.Generator())
        losses.append(float(metrics["loss"]))
    return losses, trained(model)


def weights_for(batch) -> torch.Tensor:
    """Per-query validity weights whose sums differ between the rows."""
    b = batch["queries"].shape[0]
    w = torch.zeros(b, Q)
    for row in range(b):
        w[row, :Q - 3 * row] = 1.0
    return w


# -------------------------------------------------------------- scenarios

def dp_scenario(rank, world, batch):
    """2-rank data parallelism against the one-process step on ``batch``
    (:func:`cycle_batch`, made once by the parent): in float32 the weighted
    loss with the global normalization and a step whose batch holds a NaN
    on rank 1 only; in float64 two train steps."""
    from cotr_tpu_torch.config import TrainConfig
    from cotr_tpu_torch.parallel.mesh import (make_mesh, shard_batch,
                                              shard_batch_multihost)
    from cotr_tpu_torch.training import train_step as ts
    from cotr_tpu_torch.training.loss import cotr_loss

    cfg = TrainConfig(batch_size=2, lr_backbone=0.0)
    mesh = make_mesh()
    rows = shard_batch(batch, mesh)
    mine = shard_batch_multihost({k: v.clone() for k, v in rows.items()},
                                 mesh)
    out = {"coordinate": mesh.coordinate("data"),
           "rows_are_mine": all(torch.equal(mine[k], v) and torch.equal(
               v, batch[k][rank:rank + 1]) for k, v in rows.items()),
           "cycle_counts": cycle_counts(build(), batch)}

    # the weighted loss: this rank's share, gradients summed over the ranks
    model = build()
    state = ts.create_train_state(model, cfg, None, "cpu", mesh)
    local = shard_batch(batch, mesh)
    weights = shard_batch(weights_for(batch), mesh)
    loss, metrics = cotr_loss(model, local["image"], local["queries"],
                              local["targets"], weights=weights,
                              reduce=ts.all_reduce_sum)
    loss.backward()
    ts.reduce_gradients(model.parameters(), mesh)
    out["weighted"] = {k: float(metrics[k]) for k in
                       ("loss", "corr_loss", "cycle_loss")}
    out["weighted_grads"] = {k: v.grad.clone() for k, v in
                             model.named_parameters() if v.requires_grad}
    model.zero_grad()

    # a NaN in rank 1's rows: every rank skips the step
    before = trained(model)
    nan = {k: v.clone() for k, v in local.items()}
    if rank == 1:
        nan["queries"][0, 0, 0] = float("nan")
    state, _ = ts.make_train_step(cfg, mesh)(state, nan, torch.Generator())
    out["nan"] = {"count": int(state.optimizer.count),
                  "total_notfinite": int(state.optimizer.total_notfinite),
                  "unchanged": all(torch.equal(v, before[k])
                                   for k, v in trained(model).items())}
    if rank == 0:
        ref = build()
        ts.create_train_state(ref, cfg, None, "cpu")  # the freeze policy
        loss, metrics = cotr_loss(ref, batch["image"], batch["queries"],
                                  batch["targets"],
                                  weights=weights_for(batch))
        loss.backward()
        out["ref_weighted"] = {k: float(metrics[k].detach()) for k in
                               ("loss", "corr_loss", "cycle_loss")}
        out["ref_weighted_grads"] = {k: v.grad.clone() for k, v in
                                     ref.named_parameters()
                                     if v.requires_grad}

    # two steps in float64
    float64_patches()
    batch64 = to_float64(batch)
    model = build(dtype=torch.float64)
    state = ts.create_train_state(model, cfg, None, "cpu", mesh)
    step = ts.make_train_step(cfg, mesh)
    local = shard_batch(batch64, mesh)
    losses = []
    for _ in range(2):
        state, metrics = step(state, local, torch.Generator())
        losses.append(float(metrics["loss"]))
    out["losses"] = losses
    out["weights"] = trained(model)
    if rank == 0:
        out["ref_losses"], out["ref_weights"] = one_process_steps(
            build(dtype=torch.float64), cfg, batch64, 2)
    return out


def tp_scenario(rank, world, batch):
    """2 x 2 (data, model), float64: Megatron TP with ZeRO-1 for two steps
    on ``batch``, against the one-process step (rank 0); then an Inf in one
    model shard's part of a split gradient only."""
    from cotr_tpu_torch.config import TrainConfig
    from cotr_tpu_torch.parallel.mesh import shard_batch
    from cotr_tpu_torch.parallel.tp import gather_state, make_2d_mesh
    from cotr_tpu_torch.training import train_step as ts

    cfg = TrainConfig(batch_size=2, lr_backbone=0.0)
    float64_patches()
    batch = to_float64(batch)
    mesh = make_2d_mesh(world, model_parallel=2)
    model = build(dtype=torch.float64)
    state = ts.create_train_state(model, cfg, None, "cpu", mesh,
                                  zero1_axis="data")
    opt = state.optimizer
    out = {"coordinate": (mesh.coordinate("data"), mesh.coordinate("model")),
           "q_proj": tuple(model.transformer.enc0.self_attn.q_proj
                           .weight.shape),
           "moments": {
               "model": sum(lay.axis == "model"
                            for lay in opt.moment_layouts.values()),
               "data": sum(lay.axis == "data"
                           for lay in opt.moment_layouts.values()),
               "replicated": sum(lay.replicated
                                 for lay in opt.moment_layouts.values())}}
    step = ts.make_train_step(cfg, mesh)
    local = shard_batch(batch, mesh)
    losses = []
    for _ in range(2):
        state, metrics = step(state, local, torch.Generator())
        losses.append(float(metrics["loss"]))
    out["losses"] = losses
    full = gather_state(model, opt.layouts, mesh)
    out["weights"] = {k: full[k] for k in trained(model)}
    out["moments_state"] = opt.state_dict()

    # a non-finite value in one shard's part of a split gradient
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    for p in opt.params.values():
        p.grad = torch.zeros_like(p)
    if mesh.coordinate("model") == 1:
        model.transformer.dec0.cross_attn.q_proj.weight.grad[0, 0] = \
            float("inf")
    opt.step()
    out["nan"] = {"count": int(opt.count),
                  "total_notfinite": int(opt.total_notfinite),
                  "unchanged": all(torch.equal(v, before[k]) for k, v in
                                   model.named_parameters())}
    if rank == 0:
        out["ref_losses"], out["ref_weights"] = one_process_steps(
            build(dtype=torch.float64), cfg, batch, 2)
    return out


def checkpoint_scenario(rank, world, run_dir, batch):
    """A float64 ``Trainer`` at world size 2 with ZeRO-1 and a trainable
    backbone takes one step from the global ``batch`` and writes its
    checkpoint."""
    from cotr_tpu_torch.config import COTRConfig, TrainConfig
    from cotr_tpu_torch.training.trainer import Trainer

    float64_patches()
    trainer = make_trainer(COTRConfig, TrainConfig, Trainer, run_dir, batch,
                           max_iter=1, zero1_axis="data")
    trainer.initialize(seed=0)
    trainer.train()
    opt = trainer.state.optimizer
    return {"zero1": {k: (lay.dim, lay.axis) for k, lay in
                      opt.zero1.items()},
            "local_nu": {k: tuple(v.shape) for k, v in opt.nu.items()},
            "is_main": trainer.is_main}


def make_trainer(COTRConfig, TrainConfig, Trainer, run_dir, batch,
                 max_iter, **kw):
    """The checkpoint test's float64 Trainer: lr_backbone 1e-5 (layer2/3
    convolutions train, so ZeRO-1 splits 4-D moments), a validation and a
    checkpoint every step."""
    cfg = TrainConfig(batch_size=2, lr_backbone=1e-5, max_iter=max_iter,
                      valid_iter=1, out_dir=run_dir)
    host = {k: v.double().numpy() if v.is_floating_point() else v.numpy()
            for k, v in batch.items()}
    return Trainer(build(dtype=torch.float64), COTRConfig(**DEPTH), cfg,
                   train_loader=lambda: [host], out_dir=run_dir,
                   use_tensorboard=False, device="cpu", **kw)


def train_synthetic_scenario(rank, world, argv):
    """The train twin run whole inside a gloo group (as under torchrun):
    each rank's loader makes its rows, the warm start takes rank 0's
    weights, rank 0 writes the files."""
    from cotr_tpu_torch.tools import train_synthetic

    result = train_synthetic.main(argv, device="cpu")
    return {k: result[k] for k in ("before_px", "after_px", "step")}
