"""Readings that set and test the comparison's limits; the benchmark's own
runs never call this.

    python3 -m cotr_bench.control --workload <name> --seeds 11,12,13 \\
        [--seconds 0] [--control tf32|fp8] [--fault NAME]

For each seed, in one process: the cell's set-up, then a short
window at the cell's own load (at least one pass of its pool), then the
comparison's numbers of the program and, with ``--control``, of the
reference computed in that lower precision in the program's place. One
JSON line a seed.

``--fault`` breaks the timed path underneath the harness first:

* ``unchanged``: a step returns its state unchanged (the refinement gives
  back the seeds; the optimizer's step changes nothing);
* ``half_batch``: half of the batch is left out (every other canvas of a
  device call answers zeros; the train step takes the mean over
  the first half of the batch's rows);
* ``altered``: the answers are moved where the engine produces them
  (``_conclude``): every returned point in B shifted by ``ALTER_PX``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from cotr_bench import drivers
from cotr_bench import run as harness

ALTER_PX = 8.0


def _half(out: torch.Tensor) -> torch.Tensor:
    """Every other canvas of a device call left out (answering zeros)."""
    keep = torch.zeros_like(out)
    keep[0::2] = out[0::2]
    return keep


def install_fault(name: str) -> None:
    """Break the program underneath the harness's recorders."""
    import cotr_tpu_torch.inference.engine as engine_mod
    import cotr_tpu_torch.inference.refine as refine_mod
    from cotr_tpu_torch.inference.grouped import GroupedStepper
    from cotr_tpu_torch.inference.runner import ModelRunner
    from cotr_tpu_torch.training import optim, train_step

    if name == "unchanged":
        def stay(orig, unpack):
            def wrapped(*args, **kw):
                hists = orig(*args, **kw)
                return unpack(args, kw, hists)
            return wrapped

        engine_mod.refine_grouped = stay(
            engine_mod.refine_grouped,
            lambda a, kw, h: np.stack([np.asarray(a[7], np.float64)]
                                      * h.shape[0]))
        engine_mod.refine_grouped_pairs = stay(
            engine_mod.refine_grouped_pairs,
            lambda a, kw, hs: [np.stack([np.asarray(p["loc_to"],
                                                    np.float64)] * h.shape[0])
                               for p, h in zip(a[3], hs)])
        loop = refine_mod.refine_loop

        def still_loop(forward, img_a, img_b, loc_from, loc_to0, *a, **kw):
            hist = loop(forward, img_a, img_b, loc_from, loc_to0, *a, **kw)
            return loc_to0[None].expand_as(hist).clone()

        refine_mod.refine_loop = still_loop
        optim.Optimizer.step = lambda self: None
    elif name == "half_batch":
        encode_decode = GroupedStepper._encode_decode
        GroupedStepper._encode_decode = \
            lambda self, *a: _half(encode_decode(self, *a))
        forward = ModelRunner.forward
        ModelRunner.forward = lambda self, c, q: _half(forward(self, c, q))
        views = train_step.batch_views

        def half_views(batch, cfg, generator=None):
            n = max(next(iter(batch.values())).shape[0] // 2, 1)
            return views({k: v[:n] for k, v in batch.items()}, cfg,
                         generator)

        train_step.batch_views = half_views
    elif name == "altered":
        conclude = engine_mod.SparseEngine._conclude

        def moved(self, *a, **kw):
            corrs, idx = conclude(self, *a, **kw)
            corrs = corrs.copy()
            corrs[:, 2] += ALTER_PX
            return corrs, idx

        engine_mod.SparseEngine._conclude = moved
    else:
        raise ValueError(f"unknown fault {name!r}")


def readings(root: Path, workload: str, seed: int, seconds: float,
             control, device: str = "cuda") -> dict:
    """One seed's numbers: the program's and, with ``control``, the lower
    precision's, without a result line."""
    bench = harness.load_bench(root)
    cell = harness.find_cell(bench, workload)
    base = root / "cotr_bench"
    config = harness.load_json(base / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(base / "traffic" / f"{cell['traffic']}.json")
    limits = harness.load_json(base / "limits" / f"{workload}.json")
    ctx = drivers.Context(root, config, traffic, seed, device)
    driver = drivers.make(ctx)
    driver.build()
    if driver.kind == "serve":
        t0 = time.perf_counter()
        i = 0
        while i < driver.calls_per_pass() or \
                time.perf_counter() - t0 < seconds:
            driver.request(i)
            i += 1
    driver.free()
    out = {"workload": workload, "seed": seed,
           "program": driver.numbers(), "limits": limits}
    out["correct"] = all(np.isfinite(out["program"][k])
                         and out["program"][k] <= v
                         for k, v in limits.items())
    if control:
        out["control"] = driver.numbers(control)
        out["control_correct"] = all(out["control"][k] <= v
                                     for k, v in limits.items())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--control", choices=("tf32", "fp8"))
    p.add_argument("--fault", choices=("unchanged", "half_batch", "altered"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("cotr_bench.control: no CUDA device", file=sys.stderr)
        return 2
    harness.set_caches(harness.ROOT)
    if args.fault:
        install_fault(args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(harness.ROOT, args.workload, seed, args.seconds,
                       args.control)
        out["fault"] = args.fault
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
