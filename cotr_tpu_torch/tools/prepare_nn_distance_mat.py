"""Build the N x N depth-reprojection overlap matrix that kNN retrieval
reads (counterpart of scripts/prepare_nn_distance_mat.py).

Cell (i, j) is the depth-consistent IoU of capture j's depth reprojected
into capture i: j's depth is lifted to a world point cloud, projected into
i and splatted, and the pixels where i's depth and the splat agree within
``OFFSET_THRESHOLD`` are counted over the union of both valid masks. The
matrix starts at -1 and fills in invocations of at most ``--cells`` cells
(the first in ``argwhere`` order), so a run resumes where the last one
stopped; the diagonal is 1.

On the card (the default) each source capture j is lifted once, in
float64, and projected into a block of its target captures at once
(``geometry.projector.splat_reprojections``); every capture's depth stays
on the card for the run. ``--device cpu`` computes each cell with the numpy
``distance_between_two_caps`` in a process ``Pool``, as the JAX script
does. A cell whose computation fails raises: the JAX script writes 0.0
there, which a CUDA or shape error would turn into a silent cell.

  python -m cotr_tpu_torch.tools.prepare_nn_distance_mat \\
      --scene_dir ... --image_dir ... --depth_dir ... \\
      --valid_list megadepth_valid_list.json --out dist_mat.npy

``main(argv, device="cpu")`` runs it on the CPU too.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from typing import Dict, Optional, Sequence

import numpy as np

OFFSET_THRESHOLD = 100.0  # reference prepare_nn_distance_mat.py OFFSET

#: target captures projected at once on the card
TARGET_BLOCK = 16

_scene = None


def distance_between_two_caps(cap_1, cap_2) -> float:
    """Depth-consistent reprojection IoU of ``cap_2``'s depth in ``cap_1``
    (reference :50-75), in numpy."""
    from cotr_tpu_torch.geometry.projector import (pcd_2d_to_img_2d,
                                                   pcd_3d_to_pcd_2d)

    pcd = cap_2.point_cloud_world
    size = cap_1.pinhole_cam.shape[:2]
    reproj = pcd_3d_to_pcd_2d(
        pcd[:, 0:3], cap_1.pinhole_cam.intrinsic_mat,
        cap_1.cam_pose.world_to_camera[0:3, :], size,
        keep_z=True, crop=True, filter_neg=True, norm_coord=False)
    reproj = pcd_2d_to_img_2d(reproj, size)[..., 0]
    query_mask = cap_1.depth_map > 0
    reproj_mask = reproj > 0
    inter = query_mask & reproj_mask
    union = query_mask | reproj_mask
    if union.sum() == 0:
        return 0.0
    inter = (np.abs(cap_1.depth_map - reproj) * inter
             < OFFSET_THRESHOLD) & inter
    return float(inter.sum() / union.sum())


def read_scene(scene_args):
    from cotr_tpu_torch.data.colmap import ColmapWithDepthAsciiReader

    return ColmapWithDepthAsciiReader.read_sfm_scene_given_valid_list_path(
        *scene_args)


def _work(pair):
    i, j = pair
    return i, j, distance_between_two_caps(_scene.captures[i],
                                           _scene.captures[j])


def _init(scene_args):
    global _scene
    _scene = read_scene(scene_args)


def numpy_cells(scene_args, cells, num_cpus: int) -> Dict[tuple, float]:
    """{(i, j): IoU} of ``cells`` from ``distance_between_two_caps`` in a
    ``Pool`` of ``num_cpus`` processes, each reading the scene once. The
    workers are spawned: they start clean of the caller's threads and
    device."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(num_cpus, initializer=_init,
                  initargs=(scene_args,)) as pool:
        return {(i, j): v for i, j, v in pool.imap_unordered(
            _work, [tuple(int(x) for x in p) for p in cells],
            chunksize=16)}


def torch_cells(captures, cells, device) -> Dict[tuple, float]:
    """{(i, j): IoU} of ``cells`` on ``device`` in float64: each source
    capture j lifted once, its targets projected ``TARGET_BLOCK`` at a time
    (targets of one image size together)."""
    import torch

    from cotr_tpu_torch.geometry.projector import splat_reprojections

    cells = np.asarray(cells, np.int64).reshape(-1, 2)
    depths = {}

    def depth_of(k):
        if k not in depths:
            depths[k] = torch.from_numpy(np.ascontiguousarray(
                captures[k].depth_map, np.float32)).to(device)
        return depths[k]

    out = {}
    with torch.inference_mode():
        for j in dict.fromkeys(cells[:, 1].tolist()):
            src = captures[j]
            depth = depth_of(j).double()
            h, w = depth.shape
            ys, xs = torch.meshgrid(
                torch.arange(h, dtype=torch.float64, device=device),
                torch.arange(w, dtype=torch.float64, device=device),
                indexing="ij")
            valid = (depth > 0).reshape(-1)
            z = depth.reshape(-1)[valid][:, None]
            pix = torch.stack([xs.reshape(-1)[valid], ys.reshape(-1)[valid],
                               torch.ones_like(z[:, 0])], dim=1)
            k_inv = torch.from_numpy(np.linalg.inv(
                src.pinhole_cam.intrinsic_mat)).to(device, torch.float64)
            c2w = torch.from_numpy(np.asarray(
                src.cam_pose.camera_to_world, np.float64)).to(device)
            xyz = (k_inv @ pix.T).T * z
            xyzw = torch.cat([xyz, torch.ones_like(z)], dim=1)
            xyzw = (c2w @ xyzw.T).T
            points = xyzw[:, :3] / xyzw[:, 3:4]
            by_size = {}
            for i in cells[cells[:, 1] == j, 0].tolist():
                shape = tuple(captures[i].pinhole_cam.shape[:2])
                by_size.setdefault(shape, []).append(i)
            for size, targets in by_size.items():
                for start in range(0, len(targets), TARGET_BLOCK):
                    chunk = targets[start:start + TARGET_BLOCK]
                    proj = torch.from_numpy(np.stack([np.matmul(
                        captures[i].pinhole_cam.intrinsic_mat,
                        captures[i].cam_pose.world_to_camera[0:3, :])
                        for i in chunk]).astype(np.float64)).to(device)
                    reproj = splat_reprojections(points, proj, size)
                    target = torch.stack([depth_of(i) for i in chunk]
                                         ).double()
                    query, hit = target > 0, reproj > 0
                    inter = query & hit
                    union = (query | hit).sum(dim=(1, 2))
                    inter = (((target - reproj).abs() * inter
                              < OFFSET_THRESHOLD) & inter).sum(dim=(1, 2))
                    for i, n_i, n_u in zip(chunk, inter.tolist(),
                                           union.tolist()):
                        out[(i, j)] = float(np.int64(n_i) / np.int64(n_u)) \
                            if n_u else 0.0
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene_dir", required=True)
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--depth_dir", required=True)
    ap.add_argument("--valid_list", required=True)
    ap.add_argument("--out", default="dist_mat.npy")
    ap.add_argument("--num_cpus", type=int, default=os.cpu_count(),
                    help="processes of the numpy path (--device cpu)")
    ap.add_argument("--cells", type=int, default=10_000,
                    help="max cells per invocation (resumable)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the numpy path)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> np.ndarray:
    """Fill the next ``--cells`` cells of ``--out``; returns the matrix."""
    from cotr_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device or device)
    scene_args = (args.scene_dir, args.image_dir, args.depth_dir,
                  args.valid_list, "no_crop")
    scene = read_scene(scene_args)
    n = len(scene.captures)

    if os.path.isfile(args.out):
        dist = np.load(args.out)
        if dist.shape != (n, n):
            raise ValueError(f"{args.out} holds a {dist.shape} matrix; the "
                             f"scene has {n} captures")
        if dist.min() >= 0:
            print(f"{args.out} is complete")
            return dist
    else:
        dist = np.full((n, n), -1.0, np.float32)
    np.fill_diagonal(dist, 1.0)

    todo = np.argwhere(dist < 0)[:args.cells]
    print(f"{n}x{n} matrix; {len(todo)} cells this run; "
          f"{(dist >= 0).mean():.1%} done")
    if dev.type == "cpu":
        values = numpy_cells(scene_args, todo, args.num_cpus)
    else:
        values = torch_cells(scene.captures, todo, dev)
    for (i, j), v in values.items():
        dist[i, j] = v
    np.save(args.out, dist)
    print(f"progress {(dist >= 0).mean():.1%}; saved {args.out}")
    return dist


if __name__ == "__main__":
    main()
