"""Classify the accuracy tail: why are the p90 errors far above the median?
(counterpart of tools/diagnose_tail.py)

Runs eval-suite cells (synthetic warps, exact ground truth; see
``eval_suite``) with the engine's diagnostics on, then classifies every
tail query (final EPE above ``--tail_px``) from its zoom history (the seed
and one row per zoom level, ``engine.last_diag``):

* seed_blind: the dense-pass seed missed by more than the first zoom
  level's patch half-size, so the true target never entered a crop the
  refiner looked at (better seeding fixes it, not refinement);
* diverged: the seed was inside the first patch but refinement moved away
  (final EPE above the seed's by more than 1 px);
* filter_flagged: the std and border filters would have dropped it, but
  ``force=True`` returns it anyway (a confidence-aware output fixes it);
* converged_wrong: refined into the wrong basin (below the seed's EPE but
  still in the tail, and unflagged): the model's own error.

Writes one JSON with the counts, EPE statistics and tail shares of each
class.

  python -m cotr_tpu_torch.tools.diagnose_tail --ckpt checkpoints/flagship.npz

The flags and defaults are the JAX tool's, plus ``--textures``, as in
``eval_suite``. It runs on the card; ``main(argv, device="cpu")`` runs it
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from cotr_tpu_torch.config import COTRConfig
from cotr_tpu_torch.inference.engine import SparseEngine
from cotr_tpu_torch.inference.runner import ModelRunner
from cotr_tpu_torch.models.checkpoint_io import load_model
from cotr_tpu_torch.tools import eval_synthetic_pair as eval_twin
from cotr_tpu_torch.tools.eval_suite import (REAL_EVAL_IMAGES,
                                             load_textures,
                                             parse_cycle_select)
from cotr_tpu_torch.tools.train_synthetic import texture_paths
from cotr_tpu_torch.utils.constants import zoom_ladder


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--jitter", type=float, default=0.15)
    ap.add_argument("--grid", type=int, default=15)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--proc", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--tail_px", type=float, default=5.0)
    ap.add_argument("--zoom_depth", type=int, default=4)
    ap.add_argument("--cycle_select", nargs="?", const=True,
                    default=False, type=parse_cycle_select,
                    help="enable the engine's cycle-scored candidate "
                         "selection and classify its outputs")
    ap.add_argument("--engine", default="faster", choices=["faster", "base"],
                    help="faster = grouped squads (production eval config); "
                         "base = per-task crops (isolates grouping effects)")
    ap.add_argument("--max_load", type=int, default=256)
    ap.add_argument("--textures", nargs="+", default=None,
                    help="files or globs of the real held-out images "
                         "(default: the JAX tool's four)")
    ap.add_argument("--out", default="out/diagnose_tail")
    return ap.parse_args(argv)


def build_engine(ckpt: str, dtype: str, kind: str, max_load: int,
                 device="cuda"):
    """``eval_synthetic_pair``'s ``FasterSparseEngine`` (``kind``
    'faster') or ``SparseEngine`` ('base') in tile mode over the weights at
    ``ckpt``, diagnostics on."""
    if kind == "faster":
        engine = eval_twin.build_engine(ckpt, dtype, max_load, device)
    else:
        engine = SparseEngine(ModelRunner(load_model(
            ckpt, COTRConfig(dtype=dtype), device=device), device=device),
            mode="tile")
    engine.collect_diagnostics = True
    return engine


def classify(r: dict, tail_px: float) -> str:
    if r["final_epe"] <= tail_px:
        return "ok"
    if r["seed_epe"] > r["half0"]:
        return "seed_blind"
    if r["final_epe"] > r["seed_epe"] + 1.0:
        return "diverged"
    if not r["kept"]:
        return "filter_flagged"
    return "converged_wrong"


def report(rows: list, tail_px: float) -> dict:
    """Pooled EPE, each class's statistics and each tail class's share."""
    classes = {}
    for r in rows:
        classes.setdefault(classify(r, tail_px), []).append(r)

    def stats(rs):
        e = np.array([r["final_epe"] for r in rs])
        se = np.array([r["seed_epe"] for r in rs])
        return {"n": len(rs), "frac_of_all": round(len(rs) / len(rows), 4),
                "final_epe_median": round(float(np.median(e)), 2),
                "final_epe_p90": round(float(np.percentile(e, 90)), 2),
                "seed_epe_median": round(float(np.median(se)), 2)}

    all_final = np.array([r["final_epe"] for r in rows])
    tail = [r for r in rows if r["final_epe"] > tail_px]
    return {
        "queries": len(rows),
        "pooled": {"median": round(float(np.median(all_final)), 2),
                   "p90": round(float(np.percentile(all_final, 90)), 2),
                   "tail_frac": round(len(tail) / len(rows), 4)},
        "classes": {k: stats(v) for k, v in sorted(
            classes.items(), key=lambda kv: -len(kv[1]))},
        "tail_class_shares": {
            k: round(len(v) / max(len(tail), 1), 4)
            for k, v in classes.items() if k != "ok"},
    }


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Returns the report written to ``<out>/diagnose_tail.json``."""
    args = parse_args(argv)
    side = args.side
    textures = load_textures(texture_paths(args.textures) or
                             REAL_EVAL_IMAGES, side, args.proc)
    engine = build_engine(args.ckpt, args.dtype, args.engine, args.max_load,
                          device)
    zoom_ins = zoom_ladder(args.zoom_depth)
    seeds = [int(s) for s in args.seeds.split(",")]
    # the first zoom level's patch half-size on the target side: the
    # refiner crops B's patch around the seed, so a seed further off leaves
    # the true target outside every crop (a square pair of one size has
    # relative scale 1)
    half0 = side * zoom_ins[0] / 2.0

    rows = []  # one dict per query
    for name, img_a in textures.items():
        for seed in seeds:
            _, gt = eval_twin.match_seed(engine, img_a, seed, args.jitter,
                                         args.grid, zoom_ins,
                                         cycle_select=args.cycle_select)
            d = engine.last_diag
            # force=True keeps the histories in query order
            hist = d["history"]  # (1 + Z, T, 2)
            if args.cycle_select:
                # classify the selected outputs: the row the tail reads
                hist = np.concatenate([hist, d["selected"][None]], axis=0)
            epes = np.linalg.norm(hist - gt[None], axis=2)  # (1 + Z, T)
            for ti in range(hist.shape[1]):
                rows.append({
                    "texture": name, "seed": seed,
                    "seed_epe": float(epes[0, ti]),
                    "level_epes": [float(e) for e in epes[1:, ti]],
                    "final_epe": float(epes[-1, ti]),
                    "half0": half0,
                    "kept": bool(d["kept_by_filters"][ti])})
            n_tail = int((epes[-1] > args.tail_px).sum())
            print(f"{name} seed {seed}: median "
                  f"{np.median(epes[-1]):.2f}px, tail {n_tail}/"
                  f"{hist.shape[1]}", flush=True)

    result = {"ckpt": os.path.abspath(args.ckpt), "engine": args.engine,
              "cycle_select": args.cycle_select, "tail_px": args.tail_px,
              **report(rows, args.tail_px)}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "diagnose_tail.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"pooled": result["pooled"],
                      "tail_class_shares": result["tail_class_shares"]}))
    print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
