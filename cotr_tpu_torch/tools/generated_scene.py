"""Write a generated COLMAP scene in MegaDepth's layout, for the MegaDepth
training and evaluation tools where MegaDepth itself is not at hand.

    python -m cotr_tpu_torch.tools.generated_scene --root out/scene \\
        [--views 48 --height 768 --width 1024 --val_views 24 --seed 0 \\
         --scenes 1]

It prints the path of the dataset config that ``train_cotr`` and
``eval_megadepth`` take (``--dataset_config``).

The scene: a textured background plane, tilted, and two textured
rectangles floating in front of it at other depths, so a pixel seen in one
view can be hidden by a rectangle in another and the occlusion check of
``data.dataset.compute_corrs`` rejects it. Cameras on a ring around the
optical axis look at the scene's centre. Every file is written with numpy
(and, for ``image_format="png"``, imageio):

    <root>/0000/dense0/imgs/view_NNN.npy    uint8 (H, W, 3) images
    <root>/0000/dense0/imgs/view_NNN.npy.geometric.bin
                                            COLMAP depth, ray-traced
    <root>/0000/dense0/sparse/{cameras,images,points3D}.txt
                                            one PINHOLE camera; POINTS2D of
                                            300 surface points, visible ones
    <root>/0000/dense0/dist_mat/dist_mat.npy
                                            share of view i's pixels that
                                            reproject consistently into j
    <root>/{valid_list,train,val}.json, <root>/dataset.json

With ``scenes`` above 1, scenes 0001, 0002, ... repeat scene 0000 under
their own paths (images and depths symbolic links to scene 0000's, the
text files and the distance matrix copied): the training split grows by
``views`` queries a scene, as a dataset of that many scenes would, at the
cost of rendering one. The validation split stays in scene 0000.

The depth sits beside its image because the reader joins the image's
absolute path to the depth directory (``data.colmap``). With
``depth_format="h5"`` (h5py) depths are MegaDepth's ``depths/view_NNN.h5``
instead, which the JAX package can read too. The poses are the
float32 ones the reader gets back from images.txt, so depth and poses agree.
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from cotr_tpu_torch.data.synthetic import make_procedural_texture
from cotr_tpu_torch.geometry import transforms
from cotr_tpu_torch.geometry.camera import CameraPose, Rotation, Translation

#: (normal, offset, u axis, v axis, centre, half extents or None, texture
#: scale in scene units a texture) of each surface; the first is unbounded
SURFACES = [
    ((0.12, 0.0, 1.0), 10.0, (1.0, 0.0, -0.12), (0.0, 1.0, 0.0),
     (0.0, 0.0, 10.0), None, 6.0),
    ((0.0, 0.0, 1.0), 6.0, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
     (-1.2, 0.3, 6.0), (1.4, 1.3), 2.8),
    ((0.0, 0.25, 1.0), 7.5, (1.0, 0.0, 0.0), (0.0, 1.0, -0.25),
     (1.6, -1.0, 7.75), (1.3, 1.1), 2.6),
]
TEXTURE_SIZE = 512
POINTS = 300


def _look_at(centre: np.ndarray, target: np.ndarray, roll: float
             ) -> np.ndarray:
    """4x4 world-to-camera of a camera at ``centre`` looking at
    ``target``, x right and y down in the image, rolled by ``roll``."""
    z = target - centre
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c, s = np.cos(roll), np.sin(roll)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.stack([x, y, z])
    w2c = np.eye(4)
    w2c[:3, :3] = rot
    w2c[:3, 3] = -rot @ centre
    return w2c


def _poses(views: int, rng: np.random.RandomState):
    """(quaternion float32, translation float32) of each view, on a ring of
    radius about 1.4 around the axis, each looking near (0, 0, 8)."""
    out = []
    for i in range(views):
        a = 2 * np.pi * i / views
        r = 1.4 * (1 + 0.2 * rng.uniform(-1, 1))
        centre = np.array([r * np.cos(a), 0.7 * r * np.sin(a),
                           rng.uniform(-0.8, 0.4)])
        target = np.array([0.0, 0.0, 8.0]) + rng.uniform(-0.4, 0.4, 3)
        w2c = _look_at(centre, target, rng.uniform(-0.15, 0.15))
        q = transforms.quaternion_from_matrix(w2c).astype(np.float32)
        out.append((q / np.linalg.norm(q), w2c[:3, 3].astype(np.float32)))
    return out


def _trace(w2c: np.ndarray, kinv: np.ndarray, h: int, w: int):
    """Ray-trace one view: (depth (h, w) float32 along the camera's z, 0
    where no surface is hit; surface index (h, w); u, v surface
    coordinates)."""
    c2w = np.linalg.inv(w2c)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ kinv.T  # z = 1
    dirs = rays @ c2w[:3, :3].T
    origin = c2w[:3, 3]
    best = np.full((h, w), np.inf)
    which = np.full((h, w), -1)
    uv = np.zeros((h, w, 2))
    for k, (n, off, ua, va, ctr, half, _) in enumerate(SURFACES):
        n = np.asarray(n)
        denom = dirs @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (off - origin @ n) / denom
        pts = origin + t[..., None] * dirs
        rel = pts - np.asarray(ctr)
        u = rel @ np.asarray(ua) / np.linalg.norm(ua)
        v = rel @ np.asarray(va) / np.linalg.norm(va)
        hit = np.isfinite(t) & (t > 0.1) & (t < best)
        if half is not None:
            hit &= (np.abs(u) < half[0]) & (np.abs(v) < half[1])
        best = np.where(hit, t, best)
        which = np.where(hit, k, which)
        uv = np.where(hit[..., None], np.stack([u, v], -1), uv)
    depth = np.where(which >= 0, best, 0.0).astype(np.float32)
    return depth, which, uv


def _shade(which: np.ndarray, uv: np.ndarray, textures) -> np.ndarray:
    """Each hit pixel's colour from its surface's texture, tiled, nearest."""
    img = np.zeros(which.shape + (3,), np.uint8)
    for k, tex in enumerate(textures):
        m = which == k
        scale = SURFACES[k][6]
        px = np.floor(uv[m] / scale * TEXTURE_SIZE).astype(np.int64)
        img[m] = tex[px[:, 1] % TEXTURE_SIZE, px[:, 0] % TEXTURE_SIZE]
    return img


def write_colmap_array(path: str, array: np.ndarray) -> None:
    """A COLMAP dense .bin: "width&height&channels&" then float32 data in
    column-major order (``geometry.capture.read_colmap_array`` reads it)."""
    a = np.asarray(array, np.float32)
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else a.shape[2]
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode())
        f.write(np.transpose(a.reshape(h, w, c), (1, 0, 2)).tobytes(
            order="F"))


def _overlap(depths, w2cs, k: np.ndarray, rng, samples: int = 2000
             ) -> np.ndarray:
    """dist[i, j]: the share of ``samples`` valid pixels of view i that
    land inside view j with depth within 0.5 of j's."""
    n = len(depths)
    h, w = depths[0].shape
    kinv = np.linalg.inv(k)
    dist = np.eye(n, dtype=np.float32)
    for i in range(n):
        ys, xs = np.nonzero(depths[i] > 0)
        pick = rng.choice(len(ys), min(samples, len(ys)), replace=False)
        ys, xs = ys[pick], xs[pick]
        cam = np.stack([xs, ys, np.ones_like(xs)], -1) @ kinv.T \
            * depths[i][ys, xs][:, None]
        world = (cam - w2cs[i][:3, 3]) @ w2cs[i][:3, :3]
        for j in range(n):
            if j == i:
                continue
            p = (world @ w2cs[j][:3, :3].T + w2cs[j][:3, 3]) @ k.T
            z = p[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                u, v = p[:, 0] / z, p[:, 1] / z
            ok = (z > 0) & (u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1)
            zd = depths[j][v[ok].astype(int), u[ok].astype(int)]
            dist[i, j] = np.sum(np.abs(zd - z[ok]) < 0.5) / len(ys)
    return dist


def _repeat_scene(dense: str, out: str) -> dict:
    """Scene 0000's dense directory again at ``out``: links to its images
    and depths, copies of its text files and distance matrix. Returns the
    new scene's directories."""
    import shutil

    for sub in ("imgs", "depths", "sparse", "dist_mat"):
        src = os.path.join(dense, sub)
        if not os.path.isdir(src):
            continue
        os.makedirs(os.path.join(out, sub), exist_ok=True)
        for name in os.listdir(src):
            if sub in ("imgs", "depths"):
                os.symlink(os.path.join(src, name),
                           os.path.join(out, sub, name))
            else:
                shutil.copy(os.path.join(src, name), os.path.join(out, sub))
    depth = "depths" if os.path.isdir(os.path.join(dense, "depths")) \
        else "imgs"
    return dict(scene_dir=os.path.join(out, "sparse"),
                image_dir=os.path.join(out, "imgs"),
                depth_dir=os.path.join(out, depth))


def make_scene(root: str, views: int = 48, height: int = 768,
               width: int = 1024, val_views: int = 24, seed: int = 0,
               image_format: str = "npy", depth_format: str = "bin",
               scenes: int = 1) -> str:
    """Write the scene under ``root``; returns the dataset config's path.
    ``val_views`` of the views (every other one from the first) form the
    validation split; the training split holds them all, as MegaDepth's
    split files may."""
    if image_format not in ("npy", "png") or depth_format not in ("bin",
                                                                  "h5"):
        raise ValueError(f"formats: image 'npy' or 'png', depth 'bin' or "
                         f"'h5'; got {image_format!r}, {depth_format!r}")
    if not 1 <= val_views <= views:
        raise ValueError(f"val_views must lie in [1, {views}]")
    rng = np.random.RandomState(seed)
    dense = os.path.join(os.path.abspath(root), "0000", "dense0")
    img_dir = os.path.join(dense, "imgs")
    depth_dir = img_dir if depth_format == "bin" else os.path.join(dense,
                                                                   "depths")
    sparse = os.path.join(dense, "sparse")
    for d in (img_dir, depth_dir, sparse, os.path.join(dense, "dist_mat")):
        os.makedirs(d, exist_ok=True)
    textures = [make_procedural_texture(rng, TEXTURE_SIZE)
                for _ in SURFACES]
    f = 0.8 * width
    k = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]])
    kinv = np.linalg.inv(k)
    poses = _poses(views, rng)
    names = [f"view_{i:03d}.{image_format}" for i in range(views)]

    def render(i: int):
        q, t = poses[i]
        w2c = CameraPose(Translation(t), Rotation(q)).world_to_camera
        depth, which, uv = _trace(w2c, kinv, height, width)
        img = _shade(which, uv, textures)
        path = os.path.join(img_dir, names[i])
        if image_format == "npy":
            np.save(path, img)
        else:
            import imageio.v2 as imageio

            imageio.imwrite(path, img)
        if depth_format == "bin":
            write_colmap_array(path + ".geometric.bin", depth)
        else:
            import h5py

            stem = os.path.splitext(names[i])[0]
            with h5py.File(os.path.join(depth_dir, stem + ".h5"), "w") as fh:
                fh.create_dataset("depth", data=depth)
        return w2c, depth

    # numpy's array loops release the interpreter lock: views in parallel
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        w2cs, depths = zip(*pool.map(render, range(views)))

    # surface points and the views that see them, for covisibility
    pts = []
    for _ in range(POINTS):
        n, off, ua, va, ctr, half, _ = SURFACES[rng.randint(len(SURFACES))]
        lim = half if half is not None else (5.0, 3.5)
        u, v = rng.uniform(-1, 1) * lim[0], rng.uniform(-1, 1) * lim[1]
        pts.append(np.asarray(ctr) + u * np.asarray(ua) / np.linalg.norm(ua)
                   + v * np.asarray(va) / np.linalg.norm(va))
    pts = np.array(pts)
    obs: List[List[str]] = [[] for _ in range(views)]
    tracks: List[List[str]] = [[] for _ in range(POINTS)]
    for i, w2c in enumerate(w2cs):
        p = (pts @ w2c[:3, :3].T + w2c[:3, 3]) @ k.T
        z = p[:, 2]
        u, v = p[:, 0] / z, p[:, 1] / z
        for pid in range(POINTS):
            if not (z[pid] > 0 and 0 <= u[pid] < width - 1
                    and 0 <= v[pid] < height - 1):
                continue
            if abs(depths[i][int(v[pid]), int(u[pid])] - z[pid]) > 0.05:
                continue  # hidden
            tracks[pid].append(f"{i + 1} {len(obs[i])}")
            obs[i].append(f"{u[pid]:.3f} {v[pid]:.3f} {pid + 1}")

    with open(os.path.join(sparse, "cameras.txt"), "w") as fh:
        fh.write("# Camera list with one line of data per camera:\n"
                 "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                 "# Number of cameras: 1\n"
                 f"1 PINHOLE {width} {height} {f!r} {f!r} {width / 2!r} "
                 f"{height / 2!r}\n")
    with open(os.path.join(sparse, "images.txt"), "w") as fh:
        fh.write("# Image list with two lines of data per image:\n"
                 "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, "
                 "NAME\n"
                 "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                 f"# Number of images: {views}, mean observations per "
                 f"image: {np.mean([len(o) for o in obs]):.1f}\n")
        for i, (name, (q, t)) in enumerate(zip(names, poses)):
            vals = " ".join(repr(float(x)) for x in (*q, *t))
            fh.write(f"{i + 1} {vals} 1 {name}\n{' '.join(obs[i])}\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as fh:
        fh.write("# 3D point list with one line of data per point:\n"
                 "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as "
                 "(IMAGE_ID, POINT2D_IDX)\n"
                 f"# Number of points: {POINTS}, mean track length: "
                 f"{np.mean([len(t) for t in tracks]):.1f}\n")
        for pid, (p, track) in enumerate(zip(pts, tracks)):
            fh.write(f"{pid + 1} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 128 128 "
                     f"128 0.5 {' '.join(track)}\n")

    np.save(os.path.join(dense, "dist_mat", "dist_mat.npy"),
            _overlap(depths, w2cs, k, rng))
    root = os.path.abspath(root)
    scene_dirs = [dict(scene_dir=sparse, image_dir=img_dir,
                       depth_dir=depth_dir)]
    rel = [[f"0000/dense0/imgs/{name}" for name in names]]
    for k in range(1, scenes):
        scene_dirs.append(_repeat_scene(dense, os.path.join(
            root, f"{k:04d}", "dense0")))
        rel.append([f"{k:04d}/dense0/imgs/{name}" for name in names])
    split = {"valid_list": sum(rel, []), "train": sum(rel, []),
             "val": rel[0][::2][:val_views]}
    for key, items in split.items():
        with open(os.path.join(root, f"{key}.json"), "w") as fh:
            json.dump(items, fh)
    config = dict(
        scenes_name_list=scene_dirs,
        valid_list_json=os.path.join(root, "valid_list.json"),
        train_json=os.path.join(root, "train.json"),
        val_json=os.path.join(root, "val.json"))
    path = os.path.join(root, "dataset.json")
    with open(path, "w") as fh:
        json.dump(config, fh, indent=1)
    return path


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--views", type=int, default=48)
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--val_views", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--image_format", default="npy", choices=["npy", "png"])
    ap.add_argument("--depth_format", default="bin", choices=["bin", "h5"])
    ap.add_argument("--scenes", type=int, default=1)
    args = ap.parse_args(argv)
    path = make_scene(args.root, args.views, args.height, args.width,
                      args.val_views, args.seed, args.image_format,
                      args.depth_format, args.scenes)
    print(path)
    return path


if __name__ == "__main__":
    main()
