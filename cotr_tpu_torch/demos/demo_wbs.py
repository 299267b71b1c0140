"""Wide-baseline stereo with known relative scale (counterpart of
demos/demo_wbs.py): ``areas=[1.0, 1.0]`` skips the dense scale-estimation
pass; the annotated points of A are forced queries, and the answers are
scored against the annotation in B.

    python -m cotr_tpu_torch.demos.demo_wbs --img_a a.npy --img_b b.npy \\
        --pts points.txt
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from cotr_tpu_torch.demos.demo_utils import (SAMPLE_DIR, ZOOM_INS,
                                             add_common_args, build_engine,
                                             load_image,
                                             save_corr_visualization)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--img_a", default=f"{SAMPLE_DIR}/imgs/petrzin_01.png")
    ap.add_argument("--img_b", default=f"{SAMPLE_DIR}/imgs/petrzin_02.png")
    ap.add_argument("--pts", default=f"{SAMPLE_DIR}/petrzin_pts.txt")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Returns ``corrs`` and ``err``, each answer's distance in pixels from
    the annotated point."""
    args = parse_args(argv)
    engine = build_engine(args, mode="tile", device=device)
    img_a = load_image(args.img_a)
    img_b = load_image(args.img_b)
    gt = np.loadtxt(args.pts)
    queries = gt[:, :2]

    corrs = engine.cotr_corr_multiscale(
        img_a, img_b, zoom_ins=ZOOM_INS, converge_iters=1,
        max_corrs=len(queries), queries_a=queries, force=True,
        areas=[1.0, 1.0])
    err = np.linalg.norm(corrs[:, 2:] - gt[:, 2:], axis=1)
    print(f"{corrs.shape[0]} correspondences; "
          f"mean error vs annotation: {err.mean():.2f}px, "
          f"median {np.median(err):.2f}px")
    save_corr_visualization(img_a, img_b, corrs, args.out or "wbs_output.png")
    return {"corrs": corrs, "err": err}


if __name__ == "__main__":
    main()
