"""Break one multi-pair call into its cost centres (counterpart of
tools/triage_multipair.py).

The 64-pair small-job regime (``cotr_corr_multiscale_multipair`` on 64
pairs of 32 queries) is timed whole over ``--trials`` calls after a warm
call, and these cost centres are timed inside it by wrapping them:

  * dense_seed_s: the dense seed pass of all pairs
    (``FasterSparseEngine._dense_fields_many``, one batched device pass);
  * image_stack_upload_s: the image stacks' build and upload
    (``FasterSparseEngine._stack_images``);
  * squad_formation_s: squad formation on the host
    (``inference/grouped.form_squads``, summed over pairs, levels and
    iterations);
  * dispatch_enqueue_s: ``GroupedStepper.dispatch_indexed``, which launches
    its work on the card and returns without waiting: its time is the
    enqueue time only.

What the wrappers leave out (``unaccounted_s``) is the device's compute as
the host waits for each dispatch's result, the host's table building and
the conclusion. Writes ``--out`` and prints the same report.

  python -m cotr_tpu_torch.tools.triage_multipair --pairs 64 --queries 32

It runs on the card; ``main(argv, device="cpu")`` runs it on the CPU and
returns the report.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--zooms", default="0.5,0.25")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--ckpt", default="checkpoints/flagship.npz")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--seed_stride", type=int, default=1)
    ap.add_argument("--out", default="out/triage_multipair.json")
    return ap.parse_args(argv)


def build_engine(args: argparse.Namespace, device):
    """The engine the JAX tool builds: ``FasterSparseEngine`` in tile mode
    at ``--seed_stride`` over the ``--ckpt`` weights in ``--dtype``."""
    from cotr_tpu_torch.inference.engine import FasterSparseEngine
    from cotr_tpu_torch.tools.triage_dense import flagship_runner

    return FasterSparseEngine(flagship_runner(args.ckpt, args.dtype, device),
                              mode="tile", seed_stride=args.seed_stride)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    from cotr_tpu_torch.inference import grouped as grp_mod
    from cotr_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    engine = build_engine(args, resolve_device(device))

    zoom_ins = [float(z) for z in args.zooms.split(",")]
    imr = np.random.RandomState(0)
    side = args.side
    mp_imgs = [(imr.randint(0, 255, (side, side, 3), dtype=np.uint8),
                imr.randint(0, 255, (side, side, 3), dtype=np.uint8))
               for _ in range(args.pairs)]
    mp_queries = [imr.uniform(8, side - 8, (args.queries, 2)
                              ).astype(np.float64)
                  for _ in range(args.pairs)]

    # ---- timed wrappers around the cost centres (accumulate per call)
    acc = {}

    def timed(obj, name, key):
        orig = getattr(obj, name)

        def wrap(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
            acc[key + "_calls"] = acc.get(key + "_calls", 0) + 1
            return out
        setattr(obj, name, wrap)
        return orig

    origs = [
        (engine, "_dense_fields_many",
         timed(engine, "_dense_fields_many", "dense_seed_s")),
        (engine, "_stack_images",
         timed(engine, "_stack_images", "image_stack_upload_s")),
        (grp_mod, "form_squads",
         timed(grp_mod, "form_squads", "squad_formation_s")),
        (engine._stepper, "dispatch_indexed",
         timed(engine._stepper, "dispatch_indexed", "dispatch_enqueue_s")),
    ]

    def job():
        engine.cotr_corr_multiscale_multipair(
            mp_imgs, zoom_ins=zoom_ins, max_corrs=args.queries,
            queries_list=[q.copy() for q in mp_queries], force=True,
            pair_seeds=list(range(args.pairs)))

    try:
        job()  # warm every shape (not timed)
        acc.clear()
        walls = []
        for _ in range(args.trials):
            t0 = time.perf_counter()
            job()
            walls.append(time.perf_counter() - t0)
    finally:
        for obj, name, orig in origs:
            setattr(obj, name, orig)

    wall = float(np.median(walls))
    per_trial = {k: round(v / args.trials, 3) for k, v in acc.items()
                 if not k.endswith("_calls")}
    calls = {k: v // args.trials for k, v in acc.items()
             if k.endswith("_calls")}
    accounted = sum(per_trial.values())
    report = {
        "pairs": args.pairs, "queries_per_pair": args.queries,
        "seed_stride": args.seed_stride,
        "zoom_depth": len(zoom_ins), "image_side": side,
        "wall_s_median": round(wall, 3),
        "wall_s_all": [round(w, 3) for w in walls],
        "q_s": round(args.pairs * args.queries / wall, 1),
        "cost_centers_s_per_trial": per_trial,
        "calls_per_trial": calls,
        "unaccounted_s": round(wall - accounted, 3),
        "note": ("dispatch_enqueue is the host's time to launch a dispatch "
                 "on the card, which returns without waiting: the device's "
                 "compute lands in unaccounted, where the host waits for "
                 "each dispatch's result, together with the host's table "
                 "building and the conclusion"),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
