"""Accuracy suite for ranking trained weights (counterpart of
tools/eval_suite.py).

The known-homography evaluation of ``eval_synthetic_pair`` over enough
textures and warps that its pooled metrics can rank checkpoints:

* held-out textures: the 4 real evaluation images the training glob
  excludes (``SyntheticHomographyDataset.EVAL_TEXTURES``), or the files of
  ``--textures`` in their place, plus ``--proc`` procedural textures drawn
  from an evaluation-only seed stream disjoint from every training pool's;
* ``--seeds`` known-homography warps per texture, ``grid**2`` queries each;
* pooled median EPE and PCK with a bootstrap 95% CI over (texture, seed)
  cells: resampling whole cells keeps the CI honest about the correlation
  of the queries of one warp;
* leave-one-seed-out pooled metrics, to check a ranking against the seed
  set.

  python -m cotr_tpu_torch.tools.eval_suite --ckpt checkpoints/flagship.npz \\
      [--textures 'eval/*.npy'] --out out/eval_suite

The flags and defaults are the JAX tool's, plus ``--textures`` (paths or
globs of image or ``.npy`` files). It runs on the card;
``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from cotr_tpu_torch.data.synthetic import (SAMPLE_IMAGES_DIR,
                                           SyntheticHomographyDataset,
                                           make_procedural_texture,
                                           read_texture)
from cotr_tpu_torch.ops.sampling import resize_pil_u8_host
from cotr_tpu_torch.tools import eval_synthetic_pair as eval_twin
from cotr_tpu_torch.tools.eval_synthetic_pair import build_engine
from cotr_tpu_torch.tools.train_synthetic import texture_paths
from cotr_tpu_torch.utils.constants import zoom_ladder

#: the JAX tool's four real held-out images
REAL_EVAL_IMAGES = tuple(os.path.join(SAMPLE_IMAGES_DIR, name) for name in
                         SyntheticHomographyDataset.EVAL_TEXTURES)

# evaluation-only procedural texture stream: training pools derive their
# texture seed from the dataset seed as (seed*7_368_787 + 0x5EED) % 2**32
# (data/synthetic.py); this base is not congruent to that map for any seed
# the committed training recipes use (1 and 777)
PROC_EVAL_SEED_BASE = 0xE7A1_0000


def parse_cycle_select(v):
    """``--cycle_select``'s values: 'true' or 'rescue'."""
    return {"rescue": "rescue", "true": True}[v]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--jitter", type=float, default=0.15)
    ap.add_argument("--grid", type=int, default=15,
                    help="grid**2 queries per (texture, seed) cell; "
                         "15**2 x 5 seeds = 1125 pooled per texture")
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--proc", type=int, default=4,
                    help="procedural eval-only textures appended to the 4 "
                         "real held-out images")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--max_load", type=int, default=256)
    ap.add_argument("--zoom_depth", type=int, default=4)
    ap.add_argument("--converge_iters", type=int, default=1)
    ap.add_argument("--cycle_select", nargs="?", const=True, default=False,
                    type=parse_cycle_select,
                    help="engine-side cycle-scored candidate selection "
                         "(engine.cotr_corr_multiscale(cycle_select=True)): "
                         "replaces diverged force=True outputs with the "
                         "best zoom-history candidate by reverse cycle "
                         "error")
    ap.add_argument("--bootstrap", type=int, default=2000)
    ap.add_argument("--textures", nargs="+", default=None,
                    help="files or globs of the real held-out images "
                         "(default: the JAX tool's four)")
    ap.add_argument("--out", default="out/eval_suite")
    return ap.parse_args(argv)


def summarize(epe: np.ndarray) -> dict:
    return dict(eval_twin.summarize(epe), n=int(epe.shape[0]))


def load_textures(paths: Sequence[str], side: int,
                  proc: int) -> Dict[str, np.ndarray]:
    """The suite's (side, side) uint8 textures by name: each image's centred
    square of side min(side, h, w), resized as PIL's BILINEAR does where it
    is smaller than ``side``, then ``proc`` procedural ones."""
    textures = {}
    for p in paths:
        crop = eval_twin.center_crop(read_texture(p), side)
        if crop.shape[0] != side:
            crop = resize_pil_u8_host(crop, (side, side))
        textures[os.path.basename(p)] = crop
    for i in range(proc):
        rng = np.random.RandomState((PROC_EVAL_SEED_BASE + i) % (2 ** 32))
        textures[f"proc_eval_{i}"] = make_procedural_texture(rng, size=side)
    return textures


def suite_stats(cells: Dict[tuple, np.ndarray], names: Sequence[str],
                seeds: Sequence[int], bootstrap: int) -> dict:
    """Per-texture and pooled statistics, the bootstrap CI over cells and
    the leave-one-seed-out pools, keyed as the JAX tool keys them."""
    per_texture = {}
    for name in names:
        pool = np.concatenate([cells[(name, s)] for s in seeds])
        per_texture[name] = summarize(pool)
        per_texture[name]["per_seed_median_px"] = {
            str(s): round(float(np.median(cells[(name, s)])), 2)
            for s in seeds}
    pooled = np.concatenate(list(cells.values()))

    cell_list = list(cells.values())
    brng = np.random.RandomState(0)
    boot_median, boot_pck5 = [], []
    for _ in range(bootstrap):
        idx = brng.randint(0, len(cell_list), len(cell_list))
        bp = np.concatenate([cell_list[i] for i in idx])
        boot_median.append(np.median(bp))
        boot_pck5.append((bp < 5).mean())

    loso = {}
    for drop in seeds:
        sub = np.concatenate([e for (_, s), e in cells.items() if s != drop])
        loso[f"without_seed_{drop}"] = {
            "epe_median_px": round(float(np.median(sub)), 2),
            "pck@5px": round(float((sub < 5).mean()), 4)}
    return {
        "queries_total": int(pooled.shape[0]),
        "pooled": summarize(pooled),
        "epe_median_px_ci95": [round(float(np.percentile(boot_median, 2.5)),
                                     2),
                               round(float(np.percentile(boot_median, 97.5)),
                                     2)],
        "pck@5px_ci95": [round(float(np.percentile(boot_pck5, 2.5)), 4),
                         round(float(np.percentile(boot_pck5, 97.5)), 4)],
        "leave_one_seed_out": loso,
        "per_texture": per_texture,
    }


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Returns the statistics written to ``<out>/eval_suite.json``."""
    args = parse_args(argv)
    textures = load_textures(texture_paths(args.textures) or
                             REAL_EVAL_IMAGES, args.side, args.proc)
    engine = build_engine(args.ckpt, args.dtype, args.max_load, device)
    zoom_ins = zoom_ladder(args.zoom_depth)
    seeds = [int(s) for s in args.seeds.split(",")]

    cells = {}  # (texture, seed) -> epe array
    for name, img_a in textures.items():
        for seed in seeds:
            t0 = time.time()
            epe = eval_twin.eval_seed(engine, img_a, seed, args.jitter,
                                      args.grid, zoom_ins,
                                      args.converge_iters,
                                      cycle_select=args.cycle_select)
            cells[(name, seed)] = epe
            print(f"{name} seed {seed}: median {np.median(epe):.2f}px "
                  f"n={epe.shape[0]} ({time.time() - t0:.0f}s)", flush=True)

    stats = {
        "suite": "eval_suite_v1", "cycle_select": args.cycle_select,
        "ckpt": os.path.abspath(args.ckpt),
        "side": args.side, "zoom_depth": len(zoom_ins),
        "textures": list(textures), "seeds": seeds,
        **suite_stats(cells, list(textures), seeds, args.bootstrap)}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "eval_suite.json")
    with open(path, "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps({k: stats[k] for k in
                      ("pooled", "epe_median_px_ci95", "pck@5px_ci95")}))
    print(f"wrote {path}")
    return stats


if __name__ == "__main__":
    main()
