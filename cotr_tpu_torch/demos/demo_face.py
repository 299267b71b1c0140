"""Facial-landmark transfer (counterpart of demos/demo_face.py): 68
landmarks as fixed queries, confidence-filtered (force=False), stretching
mode.

    python -m cotr_tpu_torch.demos.demo_face --img_a a.npy --img_b b.npy \\
        --landmarks landmarks.npy
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
    ap.add_argument("--img_a", default=f"{SAMPLE_DIR}/imgs/face_1.png")
    ap.add_argument("--img_b", default=f"{SAMPLE_DIR}/imgs/face_2.png")
    ap.add_argument("--landmarks",
                    default=f"{SAMPLE_DIR}/face_landmarks.npy")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Returns ``corrs`` (the confident transfers) and ``landmarks``."""
    args = parse_args(argv)
    engine = build_engine(args, mode="stretching", device=device)
    img_a = load_image(args.img_a)
    img_b = load_image(args.img_b)
    landmarks = np.load(args.landmarks)
    if landmarks.ndim == 3:
        landmarks = landmarks[0]
    print(f"{len(landmarks)} landmark queries")

    corrs = engine.cotr_corr_multiscale(
        img_a, img_b, zoom_ins=ZOOM_INS, converge_iters=1,
        max_corrs=len(landmarks), queries_a=landmarks, force=False)
    print(f"{corrs.shape[0]} confident landmark transfers")
    save_corr_visualization(img_a, img_b, corrs, args.out or "face_output.png")
    return {"corrs": corrs, "landmarks": landmarks}


if __name__ == "__main__":
    main()
