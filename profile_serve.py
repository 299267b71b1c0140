#!/usr/bin/env python3
"""Where the port's serving time goes on one NVIDIA card.

    python3 profile_serve.py [--engine scan|squad]

``--engine scan`` (the default) serves chip_smoke.py's three generated
image pairs with the flagship weights (float32, ``SparseEngine(mode=
"tile")``, ``cotr_corr_multiscale_with_cycle_consistency`` at zoom
linspace(0.5, 0.0625, 4), 100 correspondences) after one warm-up pair.
``--engine squad`` serves chip_smoke.py's squad workload instead: its
50 x 40 grid of 2,000 forced queries on the 768 x 1024 pair through
``FasterSparseEngine(mode="tile")`` with its defaults, after one warm-up
call. Either way it reports:

* the wall time of the dense seed passes alone and of the whole call;
* device time by class of the aten op that launched each kernel (and the
  hand-written attention kernel by name) from ``torch.profiler`` over the
  whole call, and the device's idle share (1 - busy time / wall time).

Prints one JSON line last; writes the profiler's table to
chiprun_out/profile_serve_<engine>.txt.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the generated pairs and card query)

# aten op-name fragments -> class, first match wins; each kernel is counted
# once, under the op that launched it
_OP_CLASSES = [("convolution", ("conv",)),
               ("matrix product", ("mm", "matmul")),
               ("layer norm", ("layer_norm",)),
               ("copy", ("copy_",))]


# the profiler's own buffer management, not the program's work
_PROFILER_OWN = ("Buffer Flush", "Activity Buffer Request")


def _class_of(op_name: str) -> str:
    for label, frags in _OP_CLASSES:
        if any(f in op_name for f in frags):
            return label
    return "elementwise and other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--engine", choices=("scan", "squad"),
                        default="scan")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.inference.engine import (FasterSparseEngine,
                                                 SparseEngine)
    from cotr_tpu_torch.inference.runner import ModelRunner
    from cotr_tpu_torch.models.checkpoint_io import load_model

    card = chip_smoke.phase_card()
    rng = np.random.RandomState(1)
    specs = [((768, 1024), 4.0, 1.05, (20, -12)),
             ((512, 512), -3.0, 0.97, (-10, 8)),
             ((480, 640), 2.0, 1.0, (16, 10))]
    pairs = []
    for (h, w), angle, scale, shift in specs:
        img_a = chip_smoke.procedural_texture(rng, h, w)
        hmat = chip_smoke.known_homography(h, w, angle, scale, shift)
        pairs.append((img_a, chip_smoke.warp_homography(img_a, hmat)))
    runner = ModelRunner(load_model(chip_smoke.FLAGSHIP, COTRConfig(),
                                    device="cuda"), device="cuda")
    zooms = chip_smoke.ZOOMS
    if args.engine == "scan":
        engine = SparseEngine(runner, mode="tile")
        dense_jobs = [[(a, b), (b, a)] for a, b in pairs]

        def serve():
            return [engine.cotr_corr_multiscale_with_cycle_consistency(
                a, b, zoom_ins=zooms, max_corrs=100) for a, b in pairs]

        engine.cotr_corr_multiscale_with_cycle_consistency(
            *pairs[-1], zoom_ins=zooms, max_corrs=100)  # warm-up
    else:
        engine = FasterSparseEngine(runner, mode="tile")
        pairs = pairs[:1]
        dense_jobs = [pairs]
        queries = chip_smoke.grid_queries(*pairs[0][0].shape[:2])

        def serve():
            return [engine.cotr_corr_multiscale(
                a, b, zoom_ins=zooms, queries_a=queries, force=True,
                max_corrs=len(queries)) for a, b in pairs]

        serve()  # warm-up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for job in dense_jobs:
        engine._dense_fields_many(job)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    serve()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    by_class = {"attention (hand-written)": 0.0}
    busy_us = 0.0
    for evt in prof.key_averages():
        if evt.key in _PROFILER_OWN:
            continue
        if evt.device_type == DeviceType.CUDA:
            # every kernel and copy on the card; the hand-written kernel is
            # launched through ctypes, outside any aten op
            busy_us += evt.self_device_time_total
            if "attention_kernel" in evt.key:
                by_class["attention (hand-written)"] += \
                    evt.self_device_time_total / 1e6
        elif evt.key.startswith("aten::") and evt.self_device_time_total > 0:
            label = _class_of(evt.key)
            by_class[label] = by_class.get(label, 0.0) + \
                evt.self_device_time_total / 1e6
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"profile_serve_{args.engine}.txt"), "w") as f:
        f.write(table)
    print(table[:6000], flush=True)
    result = dict(card=card, engine=args.engine, pairs=len(pairs),
                  dense_seed_s=dense_s,
                  serve_wall_s=wall_s, profiled_wall_s=prof_wall_s,
                  device_busy_s=busy_us / 1e6,
                  device_s_unattributed=busy_us / 1e6 - sum(by_class.values()),
                  device_idle_share=1.0 - busy_us / 1e6 / prof_wall_s,
                  device_s_by_class=by_class)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
