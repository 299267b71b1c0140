"""Sparse + dense matching on a single image pair (counterpart of
demos/demo_single_pair.py): bidirectional cycle-consistent multiscale
matching, Delaunay densification, warp of B onto A on the card.

    python -m cotr_tpu_torch.demos.demo_single_pair --img_a a.npy \\
        --img_b b.npy [--densify]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from cotr_tpu_torch.demos.demo_utils import (SAMPLE_DIR, ZOOM_INS,
                                             add_common_args, build_engine,
                                             load_image,
                                             save_corr_visualization,
                                             write_png)
from cotr_tpu_torch.inference.triangulate import triangulate_corr
from cotr_tpu_torch.ops.sampling import gather_bilinear
from cotr_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--img_a", default=f"{SAMPLE_DIR}/imgs/cathedral_1.jpg")
    ap.add_argument("--img_b", default=f"{SAMPLE_DIR}/imgs/cathedral_2.jpg")
    ap.add_argument("--densify", action="store_true")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Returns ``corrs`` and, with ``--densify``, ``dense`` (the flow of
    every pixel of A into B, 0 outside the hull) and ``warped`` (B sampled
    at that flow, float32)."""
    args = parse_args(argv)
    dev = resolve_device(device)
    engine = build_engine(args, mode="tile", device=dev)
    img_a = load_image(args.img_a)
    img_b = load_image(args.img_b)

    corrs = engine.cotr_corr_multiscale_with_cycle_consistency(
        img_a, img_b, zoom_ins=ZOOM_INS, converge_iters=1,
        max_corrs=args.max_corrs)
    print(f"found {corrs.shape[0]} correspondences")
    save_corr_visualization(img_a, img_b, corrs,
                            args.out or "sparse_output.png")
    result = {"corrs": corrs}

    if args.densify and corrs.shape[0] >= 3:
        dense = triangulate_corr(corrs, img_a.shape, img_b.shape)
        if dense is not None:
            flow = torch.from_numpy(dense).to(dev, torch.float32)
            warped = gather_bilinear(
                torch.from_numpy(img_b).to(dev, torch.float32),
                flow[..., 0], flow[..., 1]).cpu().numpy()
            write_png("dense_output.png",
                      np.clip(warped, 0, 255).astype(np.uint8))
            print("wrote dense_output.png")
            result.update(dense=dense, warped=warped)
    return result


if __name__ == "__main__":
    main()
