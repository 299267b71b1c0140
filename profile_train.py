#!/usr/bin/env python3
"""Where the port's train step spends its time on one NVIDIA card.

    python3 profile_train.py [--dtype float32|bfloat16] [--lr-backbone X]

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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32")
    parser.add_argument("--lr-backbone", type=float, default=0.0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
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
