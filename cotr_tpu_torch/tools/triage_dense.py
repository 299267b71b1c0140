"""Time the public ``dense_flow`` end to end and split one call into its
phases (counterpart of tools/triage_dense.py).

Runs ``dense_flow`` on two random square images ``--trials`` times after a
warm call (median and IQR of the walls). Each trial is followed by a split
call, in which the stage functions of ``inference/dense`` that the call
runs are timed inside it, each ending in ``torch.cuda.synchronize()`` on
the card; the plain and the split calls alternate, so a drift of the host
reaches both. The report's split is that of the split call with the median
wall, in the port's own phases:

  canvas_build_upload          ``_canvases_for_jobs`` (the images cross as
                               uint8, resized and normalized on the
                               device);
  device_pass                  ``dense_pass_device``: encode, the
                               131,072-query decode and the cycle
                               confidence;
  map_resize_merge_on_device   ``_frames_on_device``: every field's patch
                               affine, PIL's resize to its patch and the
                               min-confidence merge of each side, on the
                               device (the JAX tool fetches the whole dense
                               field, then times ``_resize_field_host``,
                               PIL on the host, and the numpy merge);
  fetch                        ``_fetch_fields``: the merged fields cast to
                               float64 and copied to the host, one copy per
                               frame shape and one wait;
  call_wall                    the wall of that call, its phases and
                               what lies between them.

The model is the flagship in bfloat16, as in the JAX tool.

  python -m cotr_tpu_torch.tools.triage_dense --trials 7 --side 1024

It runs on the card; ``main(argv, device="cpu")`` runs it on the CPU and
returns the report it prints.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "checkpoints", "flagship.npz")

#: the dense grid's queries of one canvas (256 x 512)
DENSE_QUERIES = 131072


def flagship_runner(ckpt: str, dtype: str, device):
    """A ``ModelRunner`` over the weights at ``ckpt`` (any layout
    ``load_params`` reads) in ``dtype`` on ``device``."""
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.inference.runner import ModelRunner
    from cotr_tpu_torch.models.checkpoint_io import load_model

    return ModelRunner(load_model(ckpt, COTRConfig(dtype=dtype),
                                  device=device), device=device)


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=7)
    ap.add_argument("--side", type=int, default=1024)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    from cotr_tpu_torch.inference import dense
    from cotr_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(device)
    runner = flagship_runner(FLAGSHIP, "bfloat16", dev)

    imr = np.random.RandomState(0)
    sq_a = imr.randint(0, 255, (args.side, args.side, 3), dtype=np.uint8)
    sq_b = imr.randint(0, 255, (args.side, args.side, 3), dtype=np.uint8)

    origs = {name: getattr(dense, name) for name in (
        "_canvases_for_jobs", "dense_pass_device", "_frames_on_device",
        "_fetch_fields")}

    def split_call():
        """One call with its stage functions timed where it runs them:
        ({stage: seconds}, the call's wall)."""
        phases = {}

        def timed(name, fn):
            def wrap(*a, **kw):
                sync(dev)
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sync(dev)
                phases[name] = phases.get(name, 0.0) \
                    + time.perf_counter() - t0
                return out
            return wrap

        try:
            for name, fn in origs.items():
                setattr(dense, name, timed(name, fn))
            sync(dev)
            t0 = time.perf_counter()
            dense.dense_flow(runner, sq_a, sq_b)
            sync(dev)
            return phases, time.perf_counter() - t0
        finally:
            for name, fn in origs.items():
                setattr(dense, name, fn)

    dense.dense_flow(runner, sq_a, sq_b)  # warm
    walls, finite, splits = [], [], []
    for _ in range(args.trials):
        t0 = time.perf_counter()
        out = dense.dense_flow(runner, sq_a, sq_b)
        walls.append(time.perf_counter() - t0)
        finite.append(all(np.isfinite(x).all() for x in out))
        splits.append(split_call())
    if not all(finite):
        raise ValueError(f"dense_flow returned non-finite values in trials "
                         f"{[i for i, ok in enumerate(finite) if not ok]}")
    walls_s = sorted(walls)
    med = walls_s[len(walls_s) // 2]
    q1 = walls_s[len(walls_s) // 4]
    q3 = walls_s[(3 * len(walls_s)) // 4]
    phases, split_wall = sorted(splits, key=lambda s: s[1])[len(splits) // 2]

    report = {
        "trials": args.trials,
        "wall_s_all": [round(w, 3) for w in walls],
        "median_s": round(med, 3),
        "iqr_s": [round(q1, 3), round(q3, 3)],
        "q_s_median": round(DENSE_QUERIES / med, 1),
        "phase_split_one_call_s": {
            "canvas_build_upload": round(phases["_canvases_for_jobs"], 3),
            "device_pass": round(phases["dense_pass_device"], 3),
            "map_resize_merge_on_device": round(
                phases["_frames_on_device"], 3),
            "fetch": round(phases["_fetch_fields"], 3),
            "call_wall": round(split_wall, 3),
        },
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
