"""Two-view reconstruction (counterpart of demos/demo_reconstruction.py):
bidirectional cycle-consistent correspondences, ray back-projection with
known camera parameters, closed-form two-ray midpoint triangulation.

    python -m cotr_tpu_torch.demos.demo_reconstruction --img_a a.npy \\
        --img_b b.npy --camera_a cam_a.npy --camera_b cam_b.npy \\
        --out_pcd points.npy

A camera file holds a pickled dict: ``intrinsic`` (3x3) with ``c2w``
(camera to world, 4x4) or with ``W2C`` / ``extrinsic`` (world to camera,
3x4 or 4x4).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import numpy as np

from cotr_tpu_torch.demos.demo_utils import (SAMPLE_DIR, ZOOM_INS,
                                             add_common_args, build_engine,
                                             load_image,
                                             save_corr_visualization)
from cotr_tpu_torch.ops.geometry_cv import (pixel_rays,
                                            triangulate_rays_midpoint)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--img_a", default=f"{SAMPLE_DIR}/imgs/img_0.jpg")
    ap.add_argument("--img_b", default=f"{SAMPLE_DIR}/imgs/img_1.jpg")
    ap.add_argument("--camera_a", default=f"{SAMPLE_DIR}/camera_0.npy")
    ap.add_argument("--camera_b", default=f"{SAMPLE_DIR}/camera_1.npy")
    ap.add_argument("--out_pcd", default="reconstruction.npy")
    args = ap.parse_args(argv)
    if args.max_corrs == 100:
        args.max_corrs = 2048
    return args


def camera_to_world(cam: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(intrinsic, camera-to-world 4x4) of a camera dict."""
    k = np.asarray(cam["intrinsic"], np.float64)
    if "c2w" in cam:
        return k, np.asarray(cam["c2w"], np.float64)
    w2c = np.asarray(cam.get("W2C", cam.get("extrinsic")), np.float64)
    if w2c.shape == (3, 4):
        w2c = np.concatenate([w2c, [[0, 0, 0, 1]]], axis=0)
    return k, np.linalg.inv(w2c)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Returns ``corrs`` and ``points`` (N, 3), the triangulated points in
    world coordinates."""
    args = parse_args(argv)
    engine = build_engine(args, mode="tile", device=device)
    img_a = load_image(args.img_a)
    img_b = load_image(args.img_b)
    cam_a = np.load(args.camera_a, allow_pickle=True).item()
    cam_b = np.load(args.camera_b, allow_pickle=True).item()

    corrs = engine.cotr_corr_multiscale_with_cycle_consistency(
        img_a, img_b, zoom_ins=ZOOM_INS, converge_iters=1,
        max_corrs=args.max_corrs)
    print(f"{corrs.shape[0]} correspondences")

    k_a, c2w_a = camera_to_world(cam_a)
    k_b, c2w_b = camera_to_world(cam_b)
    oa, da = pixel_rays(corrs[:, :2], k_a, c2w_a)
    ob, db = pixel_rays(corrs[:, 2:], k_b, c2w_b)
    pcd = triangulate_rays_midpoint(oa, da, ob, db)

    # colors from image a
    xy = np.clip(corrs[:, :2].astype(int),
                 0, [img_a.shape[1] - 1, img_a.shape[0] - 1])
    colors = img_a[xy[:, 1], xy[:, 0]]
    np.save(args.out_pcd, np.concatenate([pcd, colors], axis=1))
    print(f"wrote {args.out_pcd} ({pcd.shape[0]} points)")
    save_corr_visualization(img_a, img_b, corrs,
                            args.out or "recon_corrs.png")
    return {"corrs": corrs, "points": pcd}


if __name__ == "__main__":
    main()
