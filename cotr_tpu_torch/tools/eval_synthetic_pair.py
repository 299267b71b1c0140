"""Evaluate weights on a known-homography warp of one image (counterpart of
tools/eval_synthetic_pair.py).

The warp is synthetic, so the ground truth is exact: end-point error
percentiles and PCK of the squad engine's correspondences over a grid of
queries, pooled over warp seeds, and a painted overlay (a replacement image
composited through the four matched corners of a centered region).

  python -m cotr_tpu_torch.tools.eval_synthetic_pair \\
      --ckpt checkpoints/flagship.npz --image some.jpg --rep_img other.jpg \\
      --seeds 0,1,2 --out out/eval_pair

The functions take arrays and an engine; only ``main`` reads and writes
image files (with PIL, imported there). It runs on the card;
``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cotr_tpu_torch.data.synthetic import SAMPLE_IMAGES_DIR
from cotr_tpu_torch.ops.geometry_cv import (apply_homography,
                                            homography_from_4pts,
                                            warp_perspective)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--image",
                    default=os.path.join(SAMPLE_IMAGES_DIR, "cathedral_1.jpg"))
    ap.add_argument("--rep_img",
                    default=os.path.join(SAMPLE_IMAGES_DIR,
                                         "Meisje_met_de_parel.jpg"))
    ap.add_argument("--side", type=int, default=512,
                    help="square side the source image is cropped to")
    ap.add_argument("--jitter", type=float, default=0.15,
                    help="corner jitter fraction of the warp")
    ap.add_argument("--grid", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", default=None,
                    help="comma list of warp seeds, e.g. 0,1,2; metrics "
                         "pool all seeds' queries")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--max_load", type=int, default=256)
    ap.add_argument("--zoom_depth", type=int, default=4,
                    help="levels in the linspace(0.5, 0.0625, N) ladder")
    ap.add_argument("--converge_iters", type=int, default=1)
    ap.add_argument("--out", default="out/eval_pair")
    return ap.parse_args(argv)


def center_crop(img: np.ndarray, side: int) -> np.ndarray:
    """The centered square of side min(side, h, w)."""
    h, w = img.shape[:2]
    side = min(side, h, w)
    y0, x0 = (h - side) // 2, (w - side) // 2
    return np.ascontiguousarray(img[y0:y0 + side, x0:x0 + side])


def homography_for_seed(side: int, seed: int, jitter: float) -> np.ndarray:
    """The known perspective warp of a square of ``side`` for ``seed`` (the
    family the synthetic task trains on): corners jittered by up to
    ``jitter`` of the side."""
    rng = np.random.RandomState(seed)
    s = float(side - 1)
    corners = np.array([[0.0, 0], [s, 0], [s, s], [0, s]], np.float64)
    jit = rng.uniform(-jitter, jitter, (4, 2)) * s
    return homography_from_4pts(corners, corners + jit)


def query_grid(side: int, grid: int, h_mat: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(queries, ground truth): a grid x grid lattice over the middle 80%
    of the square, without the queries whose target leaves the image."""
    lin = np.linspace(side * 0.1, side * 0.9, grid)
    gx, gy = np.meshgrid(lin, lin)
    queries = np.stack([gx.ravel(), gy.ravel()], axis=1)
    gt = apply_homography(h_mat, queries)
    ok = ((gt >= 0) & (gt <= side - 1)).all(axis=1)
    return queries[ok], gt[ok]


def warp_for_seed(img_a: np.ndarray, seed: int, jitter: float,
                  device) -> Tuple[np.ndarray, np.ndarray]:
    """The seed's known warp of the square ``img_a``, warped on ``device``:
    (h_mat, img_b)."""
    side = img_a.shape[0]
    h_mat = homography_for_seed(side, seed, jitter)
    img = torch.from_numpy(img_a.astype(np.float32)).to(device)
    img_b = warp_perspective(img, h_mat, (side, side)).cpu().numpy()
    return h_mat, img_b.astype(np.uint8)


def match_seed(engine, img_a: np.ndarray, seed: int, jitter: float,
               grid: int, zoom_ins, converge_iters: int = 1,
               cycle_select=False) -> Tuple[np.ndarray, np.ndarray]:
    """(the engine's correspondences, their ground truth) on one warp
    seed's query grid (the middle 80%, queries whose target leaves the
    image dropped), in query order. ``cycle_select`` goes to
    ``cotr_corr_multiscale``."""
    # a fresh engine stream per seed: the squad permutations would otherwise
    # depend on which seeds ran before
    engine.rng = np.random.RandomState(10_000 + seed)
    h_mat, img_b = warp_for_seed(img_a, seed, jitter, engine.runner.device)
    queries, gt = query_grid(img_a.shape[0], grid, h_mat)
    corrs = engine.cotr_corr_multiscale(
        img_a, img_b, zoom_ins=zoom_ins, converge_iters=converge_iters,
        max_corrs=len(queries), queries_a=queries.copy(), force=True,
        cycle_select=cycle_select)
    return corrs, gt


def eval_seed(engine, img_a: np.ndarray, seed: int, jitter: float,
              grid: int, zoom_ins, converge_iters: int = 1,
              cycle_select=False) -> np.ndarray:
    """End-point errors (px) of ``match_seed``'s correspondences."""
    corrs, gt = match_seed(engine, img_a, seed, jitter, grid, zoom_ins,
                           converge_iters, cycle_select)
    return np.linalg.norm(corrs[:, 2:] - gt, axis=1)


def summarize(epe: np.ndarray) -> Dict[str, float]:
    return {
        "epe_mean_px": round(float(epe.mean()), 2),
        "epe_median_px": round(float(np.median(epe)), 2),
        "epe_p90_px": round(float(np.percentile(epe, 90)), 2),
        "epe_p95_px": round(float(np.percentile(epe, 95)), 2),
        "pck@1px": round(float((epe < 1).mean()), 4),
        "pck@3px": round(float((epe < 3).mean()), 4),
        "pck@5px": round(float((epe < 5).mean()), 4),
    }


def evaluate(engine, img_a: np.ndarray, seeds: Sequence[int],
             jitter: float = 0.15, grid: int = 12, zoom_ins=None,
             converge_iters: int = 1, image_name: str = "") -> dict:
    """The pooled statistics over ``seeds`` (with per-seed rows when there
    is more than one), keyed as the JAX tool keys them."""
    per_seed = {s: eval_seed(engine, img_a, s, jitter, grid, zoom_ins,
                             converge_iters) for s in seeds}
    pooled = np.concatenate(list(per_seed.values()))
    stats = {"image": image_name, "side": int(img_a.shape[0]),
             "queries": int(pooled.shape[0]), "zoom_depth": len(zoom_ins),
             "seeds": list(seeds), **summarize(pooled)}
    if len(seeds) > 1:
        stats["per_seed"] = {str(s): summarize(e) for s, e in per_seed.items()}
    return stats


def paint_overlay(engine, img_a: np.ndarray, rep: np.ndarray, seed: int,
                  jitter: float, zoom_ins, converge_iters: int = 1
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Match the four corners of a centered region (a quarter of the side
    in from each edge) and composite ``rep`` through them onto the warped
    image. Returns (overlay uint8, corner errors in px)."""
    h_mat, img_b = warp_for_seed(img_a, seed, jitter, engine.runner.device)
    # reseeded like eval_seed, so the overlay does not depend on how many
    # seeds ran before it
    engine.rng = np.random.RandomState(20_000 + seed)
    side = img_a.shape[0]
    pad = side * 0.25
    region = np.array([[pad, pad], [side - pad, pad],
                       [pad, side - pad], [side - pad, side - pad]])
    corner_corrs = engine.cotr_corr_multiscale(
        img_a, img_b, zoom_ins=zoom_ins, converge_iters=converge_iters,
        max_corrs=4, queries_a=region.copy(), force=True)
    rh, rw = rep.shape[:2]
    rep_corners = np.array([[0, 0], [rw, 0], [0, rh], [rw, rh]], np.float64)
    hm = homography_from_4pts(rep_corners, corner_corrs[:, 2:])
    dev = engine.runner.device
    warped = warp_perspective(torch.from_numpy(rep).to(dev), hm,
                              (side, side))
    mask = warp_perspective(torch.ones((rh, rw, 1), device=dev), hm,
                            (side, side)) > 0
    img_b_t = torch.from_numpy(img_b).to(dev)
    overlay = (warped * mask + img_b_t * ~mask).to(torch.uint8).cpu().numpy()
    gt_corners = apply_homography(h_mat, region)
    return overlay, np.linalg.norm(corner_corrs[:, 2:] - gt_corners, axis=1)


def build_engine(ckpt: str, dtype: str = "bfloat16", max_load: int = 256,
                 device="cuda"):
    """``FasterSparseEngine(mode="tile")`` over the weights at ``ckpt`` (any
    layout ``load_params`` reads) in ``dtype``."""
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.inference.engine import FasterSparseEngine
    from cotr_tpu_torch.inference.runner import ModelRunner
    from cotr_tpu_torch.models.checkpoint_io import load_model

    model = load_model(ckpt, COTRConfig(dtype=dtype), device=device)
    return FasterSparseEngine(ModelRunner(model, device=device), mode="tile",
                              max_load=max_load)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    import PIL.Image

    from cotr_tpu_torch.utils.constants import zoom_ladder

    args = parse_args(argv)
    with PIL.Image.open(args.image) as im:
        img_a = center_crop(np.array(im.convert("RGB")), args.side)
    with PIL.Image.open(args.rep_img) as im:
        rep = np.array(im.convert("RGB"))
    engine = build_engine(args.ckpt, args.dtype, args.max_load, device)
    zoom_ins = zoom_ladder(args.zoom_depth)
    seeds = ([int(s) for s in args.seeds.split(",")] if args.seeds
             else [args.seed])
    stats = evaluate(engine, img_a, seeds, args.jitter, args.grid, zoom_ins,
                     args.converge_iters, os.path.basename(args.image))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "eval_pair.json"), "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps(stats))
    overlay, corner_err = paint_overlay(engine, img_a, rep, seeds[0],
                                        args.jitter, zoom_ins,
                                        args.converge_iters)
    out_png = os.path.join(args.out, "painted_overlay.png")
    PIL.Image.fromarray(overlay).save(out_png)
    print(f"painted overlay -> {out_png} "
          f"(corner EPE: {np.round(corner_err, 2).tolist()} px)")
    return dict(stats, corner_epe_px=corner_err.tolist())


if __name__ == "__main__":
    main()
