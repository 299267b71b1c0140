"""Guided matching over keypoints (counterpart of
demos/demo_guided_matching.py): correspond the keypoints of each image
into the other, keep the mutual nearest neighbours, and prune them with
RANSAC on the fundamental matrix, every hypothesis solved in one batched
pass on the card.

    python -m cotr_tpu_torch.demos.demo_guided_matching --img_a a.npy \\
        --img_b b.npy --kpts_a a_kpts.npy --kpts_b b_kpts.npy \\
        [--faster_infer yes]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from cotr_tpu_torch.demos.demo_utils import (SAMPLE_DIR, ZOOM_INS,
                                             add_common_args, build_engine,
                                             load_image,
                                             save_corr_visualization)
from cotr_tpu_torch.ops.geometry_cv import find_fundamental_ransac


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--img_a",
                    default=f"{SAMPLE_DIR}/imgs/21126421_4537535153.jpg")
    ap.add_argument("--img_b",
                    default=f"{SAMPLE_DIR}/imgs/21526113_4379776807.jpg")
    ap.add_argument("--kpts_a", default=f"{SAMPLE_DIR}/"
                    "21126421_4537535153.jpg.disk.kpts.npy")
    ap.add_argument("--kpts_b", default=f"{SAMPLE_DIR}/"
                    "21526113_4379776807.jpg.disk.kpts.npy")
    return ap.parse_args(argv)


def mutual_matches(kpts_a: np.ndarray, kpts_b: np.ndarray, corr_ab, idx_ab,
                   corr_ba) -> np.ndarray:
    """(M, 4) [x_a, y_a, x_b, y_b]: keypoint pairs whose transfers land
    nearest each other both ways."""
    d_ab = np.linalg.norm(corr_ab[:, None, 2:] - kpts_b[None, :, :2], axis=2)
    d_ba = np.linalg.norm(corr_ba[:, None, 2:] - kpts_a[None, :, :2], axis=2)
    nn_ab = d_ab.argmin(axis=1)
    nn_ba = d_ba.argmin(axis=1)
    matches = [[*kpts_a[idx_ab[i]][:2], *kpts_b[j][:2]]
               for i, j in enumerate(nn_ab) if nn_ba[j] == i]
    return np.asarray(matches).reshape(-1, 4)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Returns ``mutual`` (the mutual matches), ``matches`` (those RANSAC
    keeps; all of them when there are fewer than 8) and the ``inliers``
    mask over ``mutual`` (None without RANSAC)."""
    args = parse_args(argv)
    engine = build_engine(args, mode="tile", device=device)
    img_a = load_image(args.img_a)
    img_b = load_image(args.img_b)
    kpts_a = np.load(args.kpts_a)
    kpts_b = np.load(args.kpts_b)
    print(f"keypoints: {len(kpts_a)} / {len(kpts_b)}")

    t0 = time.time()
    if hasattr(engine, "cotr_corr_multiscale_multipair"):
        # both directions are independent fixed-keypoint jobs: one multipair
        # call shares every dense-pass and squad dispatch between them
        (corr_ab, idx_ab), (corr_ba, idx_ba) = \
            engine.cotr_corr_multiscale_multipair(
                [(img_a, img_b), (img_b, img_a)], zoom_ins=ZOOM_INS,
                max_corrs=[len(kpts_a), len(kpts_b)],
                queries_list=[kpts_a, kpts_b], force=True, return_idx=True)
    else:
        corr_ab, idx_ab = engine.cotr_corr_multiscale(
            img_a, img_b, zoom_ins=ZOOM_INS, max_corrs=len(kpts_a),
            queries_a=kpts_a, force=True, return_idx=True)
        corr_ba, idx_ba = engine.cotr_corr_multiscale(
            img_b, img_a, zoom_ins=ZOOM_INS, max_corrs=len(kpts_b),
            queries_a=kpts_b, force=True, return_idx=True)
    print(f"correspondence passes: {time.time() - t0:.1f}s "
          f"({engine.total_tasks} task-steps)")

    mutual = mutual_matches(kpts_a, kpts_b, corr_ab, idx_ab, corr_ba)
    print(f"mutual matches: {len(mutual)}")
    matches, mask = mutual, None
    if len(mutual) >= 8:
        _, mask = find_fundamental_ransac(mutual[:, :2], mutual[:, 2:],
                                          threshold=1.0, device=device)
        matches = mutual[mask]
        print(f"RANSAC inliers: {len(matches)}")
    save_corr_visualization(img_a, img_b, matches,
                            args.out or "guided_matching_output.png")
    return {"mutual": mutual, "matches": matches, "inliers": mask}


if __name__ == "__main__":
    main()
