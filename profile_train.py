#!/usr/bin/env python3
"""Where the port's train step spends its time on one NVIDIA card.

    python3 profile_train.py [--dtype float32|bfloat16] [--lr-backbone X]
    python3 profile_train.py --synthetic

Takes chip_smoke.py's training set-up (full width, ``TrainConfig()``: batch
24, 200 queries a sample, dropout 0.1, the flagship's backbone and fresh
weights elsewhere, one generated batch in the ``crop`` + ``h_mat`` layout),
warms up, then profiles a few steps with ``torch.profiler`` and reports for
one step:

* the wall time (host clock, the card drained at both ends) without the
  profiler, and the device's idle share against it (1 - kernel time / wall
  time; the profiler with shapes recorded slows the host several times over
  and the kernels not at all, so the profiled wall time is printed beside
  it and used for nothing);
* device time by class. Each kernel counts under the aten op that launched
  it, forward or backward: the optimizer (everything under
  ``Optimizer.step``), the einsum attention (the batched products, the
  softmax, and every op on a (B, 8, Lq, 512) tensor: mask, dropout, casts),
  convolution, Linear layers (the other matrix products), layer norm,
  copies, elementwise and other.

Prints one JSON line last; writes the profiler's table to
chiprun_out/profile_train_<dtype>.txt.

``--synthetic`` takes the train twin's set-up instead (chip_smoke.py's
``[synthetic-train]``: bfloat16, lr_backbone 1e-4, dropout 0, from the
flagship, batch 24 of its synthetic dataset) and feeds the same trainer in
turn from a batch already on the card, from one host batch uploaded every
step, from the twin's loader (8 threads) and from the same loader with 8
processes; for each it reports ms a step (CUDA events from one step's start
to the next one's, median of the steps after the first 8), the loop's wait
on the loader (for its first batch, for its first 8 batches, one to each
worker, and for a step after them: mean, median and longest), the upload's
host time, and, profiled, the
device's busy time and idle share.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import statistics
import os
import sys
import tempfile
import time
import types

import numpy as np
import torch
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the generated batch and the trainer set-up)

WARMUP_STEPS = 4
PROFILED_STEPS = 3
OPTIMIZER_SCOPE = "Optimizer.step"
# the profiler's own buffer management, not the program's work
_PROFILER_OWN = ("Buffer Flush", "Activity Buffer Request")


def _is_attention_shape(shape) -> bool:
    return len(shape) == 4 and shape[1] == 8 and shape[3] == 512


def _class_of(evt) -> str:
    node = evt
    while node is not None:
        if node.name == OPTIMIZER_SCOPE:
            return "optimizer"
        node = node.cpu_parent
    name = evt.name
    shapes = evt.input_shapes or []
    if ("bmm" in name or "softmax" in name
            or any(_is_attention_shape(s) for s in shapes if s)):
        return "einsum attention"
    if "conv" in name:
        return "convolution"
    if "mm" in name or "matmul" in name or "linear" in name:
        return "Linear layers"
    if "layer_norm" in name:
        return "layer norm"
    if "copy_" in name:
        return "copy"
    return "elementwise and other"


SYNTH_STEPS = 32
SYNTH_PROFILED_STEPS = 8


def _feed_record(attention, trainer, factory, steps: int, profile: bool,
                 startup: int = chip_smoke.TRAIN_WARMUP_STEPS) -> dict:
    """``steps`` steps of ``trainer`` fed by ``factory``: ms a step (median
    of the steps after the first ``startup``), the loop's wait on the
    loader, for its first batch, its first ``startup`` batches and a steady
    step, the upload's host time; with ``profile``, the device's busy time
    over the same steps."""
    loader = chip_smoke.TimedLoader(factory)
    trainer.train_loader = loader
    plain_batch = trainer._batch
    upload = [0.0]

    def timed_batch(batch):
        t0 = time.perf_counter()
        out = plain_batch(batch)
        upload[0] += time.perf_counter() - t0
        return out

    trainer._batch = timed_batch
    spy = chip_smoke.TrainSpy(attention, trainer)
    trainer.cfg = dataclasses.replace(trainer.cfg,
                                      max_iter=trainer.state.step + steps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profile:
        with torch.profiler.profile(activities=acts) as prof:
            trainer.train()
            torch.cuda.synchronize()
    else:
        trainer.train()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses, ms = spy.finish()
    trainer._train_step, trainer.validate = spy.step_fn, spy.validate_fn
    trainer.save_checkpoint, trainer._batch = spy.save_fn, plain_batch
    steady = ms[startup:]
    # the wait before step i is the i-th batch's: a pool's first batches
    # wait for its workers to start, one batch to a worker
    steady_waits = loader.waits[startup:steps]
    record = dict(steps=steps, startup_steps=startup,
                  ms_per_step=statistics.median(steady),
                  ms_per_step_mean=float(np.mean(steady)),
                  wall_ms_per_step=wall * 1e3 / steps,
                  loader_wait_ms_per_step=loader.wait_s * 1e3 / steps,
                  loader_wait_share=loader.wait_s / wall,
                  loader_first_batch_ms=loader.first_wait_s * 1e3,
                  loader_startup_wait_ms=sum(loader.waits[:startup]) * 1e3,
                  loader_wait_steady_ms_per_step=float(
                      np.mean(steady_waits)) * 1e3,
                  loader_wait_steady_median_ms=float(
                      np.median(steady_waits)) * 1e3,
                  loader_wait_steady_max_ms=max(steady_waits) * 1e3,
                  loader_wait_steady_share=sum(steady_waits) / (
                      sum(ms[startup - 1:steps - 1]) / 1e3),
                  upload_ms_per_step=upload[0] * 1e3 / steps,
                  loss_first=losses[0], loss_last=losses[-1])
    if profile:
        busy_us = sum(evt.self_device_time_total
                      for evt in prof.key_averages()
                      if evt.device_type == DeviceType.CUDA
                      and evt.key not in _PROFILER_OWN
                      and not evt.is_user_annotation)
        record.update(profiled_wall_ms_per_step=wall * 1e3 / steps,
                      device_busy_ms_per_step=busy_us / 1e3 / steps)
    return record


def synthetic_breakdown() -> int:
    """The train twin's step fed four ways (see the module's docstring)."""
    from cotr_tpu_torch.data.loader import PrefetchLoader
    from cotr_tpu_torch.ops import attention
    from cotr_tpu_torch.tools import train_synthetic as train_twin

    card = chip_smoke.phase_card()
    log = chip_smoke.log
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    results = {}
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, "build")) as out_dir:
        texture_dir = os.path.join(out_dir, "textures")
        os.makedirs(texture_dir)
        texture_glob = chip_smoke.write_textures(
            texture_dir, chip_smoke.SYNTH_TEXTURES, np.random.RandomState(12))
        args = train_twin.parse_args(chip_smoke.synthetic_argv(
            texture_glob, os.path.join(out_dir, "run"), 10 ** 6,
            "--valid_iter", str(10 ** 6)))
        train_ds, val_ds = train_twin.build_datasets(args)
        trainer = train_twin.build_trainer(args, train_ds, val_ds,
                                           device="cuda")
        host_batch = next(iter(PrefetchLoader(train_ds, args.batch_size,
                                              num_workers=8, seed=5)))
        card_batch = trainer._batch(host_batch)

        def loader(executor):
            return PrefetchLoader(train_ds, args.batch_size,
                                  num_workers=args.workers, seed=1,
                                  executor=executor)

        feeds = [("batch on the card", lambda: itertools.repeat(card_batch)),
                 ("one host batch, uploaded each step",
                  lambda: itertools.repeat(host_batch)),
                 ("loader, 8 threads", loader("thread")),
                 ("loader, 8 processes", loader("process")),
                 ("batch on the card, again",
                  lambda: itertools.repeat(card_batch))]
        for name, factory in feeds:
            results[name] = _feed_record(attention, trainer, factory,
                                         SYNTH_STEPS, profile=False,
                                         startup=args.workers)
        for name, factory in (feeds[0], feeds[2]):
            prof = _feed_record(attention, trainer, factory,
                                SYNTH_PROFILED_STEPS, profile=True)
            # against the step timed without the profiler, as above
            prof["device_idle_share"] = 1.0 - (
                prof["device_busy_ms_per_step"] / results[name]["ms_per_step"])
            results[name]["profiled"] = prof
    for name, r in results.items():
        prof = r.get("profiled")
        log(f"[synthetic step] {name}: {r['ms_per_step']:.1f} ms a step "
            f"(median; mean {r['ms_per_step_mean']:.1f}), loader wait "
            f"{r['loader_wait_ms_per_step']:.1f} ms a step "
            f"({r['loader_wait_share']:.1%}): first batch "
            f"{r['loader_first_batch_ms']:.1f} ms, first "
            f"{r['startup_steps']} batches {r['loader_startup_wait_ms']:.1f} "
            f"ms, then {r['loader_wait_steady_ms_per_step']:.1f} ms a step "
            f"({r['loader_wait_steady_share']:.1%} of those steps; median "
            f"{r['loader_wait_steady_median_ms']:.1f}, longest "
            f"{r['loader_wait_steady_max_ms']:.1f} ms), upload "
            f"{r['upload_ms_per_step']:.2f} ms a step"
            + (f"; profiled: device busy "
               f"{prof['device_busy_ms_per_step']:.1f} ms a step, idle share "
               f"{prof['device_idle_share']:.3f}" if prof else ""))
    print(json.dumps(dict(card=card, cpu_count=os.cpu_count(),
                          batch=args.batch_size, dtype=args.dtype,
                          lr_backbone=args.lr_backbone, feeds=results)),
          flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32")
    parser.add_argument("--lr-backbone", type=float, default=0.0)
    parser.add_argument("--synthetic", action="store_true",
                        help="the train twin's step, fed four ways")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    if args.synthetic:
        return synthetic_breakdown()
    from cotr_tpu_torch.config import COTRConfig, TrainConfig
    from cotr_tpu_torch.models import checkpoint_io
    from cotr_tpu_torch.models.cotr import build_model
    from cotr_tpu_torch.ops import attention
    from cotr_tpu_torch.training.trainer import Trainer

    card = chip_smoke.phase_card()
    mods = types.SimpleNamespace(
        Trainer=Trainer, build_model=build_model,
        params_from_flax=checkpoint_io.params_from_flax,
        load_flagship=checkpoint_io.load_flagship)
    cfg = COTRConfig(dtype=args.dtype)
    train_cfg = TrainConfig(lr_backbone=args.lr_backbone,
                            valid_iter=10 ** 9)
    batch = chip_smoke.on_card(chip_smoke.make_train_batch(
        np.random.RandomState(7), train_cfg.batch_size, train_cfg.num_kp))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, "build")) as out_dir:
        trainer = chip_smoke.make_trainer(mods, cfg, train_cfg, batch,
                                          out_dir)
    optimizer = trainer.state.optimizer
    plain_step = optimizer.step

    def scoped_step():
        with torch.profiler.record_function(OPTIMIZER_SCOPE):
            plain_step()

    optimizer.step = scoped_step

    def run(steps: int) -> float:
        trainer.cfg = dataclasses.replace(
            trainer.cfg, max_iter=trainer.state.step + steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps

    run(WARMUP_STEPS)
    attention.launches = 0
    step_s = run(PROFILED_STEPS)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        profiled_step_s = run(PROFILED_STEPS)
    by_class: dict = {}
    busy_us = 0.0
    for evt in prof.key_averages():
        # kernels and copies; not the span that a record_function scope
        # leaves on the device's timeline
        if (evt.device_type == DeviceType.CUDA
                and evt.key not in _PROFILER_OWN
                and evt.key != OPTIMIZER_SCOPE
                and not evt.is_user_annotation):
            busy_us += evt.self_device_time_total
    for evt in prof.events():
        if (evt.device_type == DeviceType.CPU
                and evt.self_device_time_total > 0
                and evt.name not in _PROFILER_OWN):
            label = _class_of(evt)
            by_class[label] = by_class.get(label, 0.0) \
                + evt.self_device_time_total / 1e3 / PROFILED_STEPS
    busy_ms = busy_us / 1e3 / PROFILED_STEPS
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"profile_train_{args.dtype}.txt"), "w") as f:
        f.write(table)
    print(table[:6000], flush=True)
    result = dict(card=card, dtype=args.dtype, lr_backbone=args.lr_backbone,
                  batch=train_cfg.batch_size,
                  queries=int(batch["queries"].shape[1]),
                  step_ms=step_s * 1e3, profiled_step_ms=profiled_step_s * 1e3,
                  device_busy_ms=busy_ms,
                  device_ms_unattributed=busy_ms - sum(by_class.values()),
                  device_idle_share=1.0 - busy_ms / (step_s * 1e3),
                  device_ms_by_class=by_class,
                  attention_kernel_launches=attention.launches)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
