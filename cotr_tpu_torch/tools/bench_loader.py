"""Measure the MegaDepth path's input pipeline on a generated scene
(counterpart of tools/bench_loader.py).

Writes a COLMAP scene on disk at a production-like scale, hundreds of
captures with images and depth maps (``generate_scene``), then drives
``PrefetchLoader`` + ``CotrDataset`` (image and depth reads, the 3-D lift,
the occlusion-checked reprojection in C++, trim, flip, normalize) and
reports batches and samples a second.

  python -m cotr_tpu_torch.tools.bench_loader --captures 500 --batches 20 \\
      --batch_size 24

Images are ``.npy`` uint8 arrays and depths COLMAP ``.geometric.bin``
files beside them: the card's machine has neither PIL nor h5py.
``generate_scene(..., image_format="jpg", depth_format="h5")`` writes the
JAX tool's files (JPEG at quality 92 through PIL, ``depths/*.h5`` through
h5py, both imported only then). The JAX tool's report holds a stage-1 device step
rate measured on a TPU; here ``device_steps_per_s`` appears only when
``--device_steps_per_s`` passes one in (e.g. the train twin's on the same
card).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np


def _scene_config(root, scene_dir, img_dir, depth_dir, use_ram):
    from cotr_tpu_torch.data.megadepth import DataConfig

    return DataConfig(
        scenes_name_list=[{
            "scene_dir": scene_dir,
            "image_dir": img_dir,
            "depth_dir": depth_dir,
        }],
        valid_list_json=os.path.join(root, "valid_list.json"),
        train_json=os.path.join(root, "train.json"),
        val_json=os.path.join(root, "val.json"),
        test_json=os.path.join(root, "val.json"),
        crop_cam="crop_center_and_resize",
        num_kp=100,
        use_ram=use_ram,
    )


def image_name(i: int, image_format: str = "npy") -> str:
    """The file name of capture ``i``."""
    return f"img_{i:04d}.{image_format}"


def generate_scene(root: str, n_caps: int, h: int, w: int, seed: int = 0,
                   use_ram: bool = False, skip_files: bool = False,
                   scene_name: str = "0001", write_jsons: bool = True,
                   image_format: str = "npy", depth_format: str = "bin"):
    """N cameras on a jittered grid viewing a textured slanted plane: every
    neighbouring pair shares most of its frustum, so kNN sampling and
    reprojection give dense valid correspondences, as MegaDepth pairs do.
    The plane's texture is rendered through each capture's camera, so the
    images move with the cameras. Draws from ``RandomState(seed)`` in the
    JAX tool's order, so both write the same scene.

    ``image_format``: "npy" (uint8 arrays) or "jpg" (PIL, quality 92);
    ``depth_format``: "bin" (COLMAP ``<image>.geometric.bin`` beside each
    image) or "h5" (``depths/<stem>.h5`` through h5py).
    ``skip_files=True`` builds only the DataConfig (the paths are
    deterministic) for a scene already on disk."""
    if image_format not in ("npy", "jpg") or depth_format not in ("bin",
                                                                  "h5"):
        raise ValueError(f"formats: image 'npy' or 'jpg', depth 'bin' or "
                         f"'h5'; got {image_format!r}, {depth_format!r}")
    rng = np.random.RandomState(seed)
    scene_dir = os.path.join(root, scene_name, "dense", "sparse")
    img_dir = os.path.join(root, scene_name, "dense", "imgs")
    depth_dir = os.path.join(root, scene_name, "dense", "depths") \
        if depth_format == "h5" else img_dir
    dm_dir = os.path.join(root, scene_name, "dense", "dist_mat")
    for d in (scene_dir, img_dir, depth_dir, dm_dir):
        os.makedirs(d, exist_ok=True)
    if skip_files:
        return _scene_config(root, scene_dir, img_dir, depth_dir, use_ram)

    from cotr_tpu_torch.data.synthetic import make_procedural_texture
    from cotr_tpu_torch.tools.generated_scene import write_colmap_array

    names = [image_name(i, image_format) for i in range(n_caps)]
    z0 = 3.0
    a_slope = 0.1  # mild slant about the X axis: depth varies by row
    f_len = 0.9 * w
    cx, cy = w / 2.0, h / 2.0
    side = int(np.ceil(np.sqrt(n_caps)))
    # camera grid (COLMAP T = -R C with R = I, so centre C = -(tx, ty, 0));
    # positions drawn first, so rendering and images.txt share them
    ix = np.arange(n_caps)
    txs = 0.12 * (ix % side - side / 2) + rng.uniform(-0.02, 0.02, n_caps)
    tys = 0.12 * (ix // side - side / 2) + rng.uniform(-0.02, 0.02, n_caps)

    tex_size = 1024
    tex = make_procedural_texture(rng, size=tex_size).astype(np.float32)
    # the world extent every camera's frustum (plus the grid span) fits in
    ext = (z0 + a_slope) / f_len * max(h, w) * 0.75 + 0.12 * side / 2 + 0.5

    xs = (np.arange(w, dtype=np.float64) - cx) / f_len          # (w,)
    ys = (np.arange(h, dtype=np.float64) - cy) / f_len          # (h,)

    def render(i, gain, offset, noise):
        cxw, cyw = -txs[i], -tys[i]
        # ray-plane intersection: t = (z0 + a*cyw) / (1 - a*(y-cy)/f)
        t = (z0 + a_slope * cyw) / (1.0 - a_slope * ys)[:, None]  # (h, 1)
        t = np.broadcast_to(t, (h, w))
        xw = cxw + t * xs[None, :]
        yw = cyw + t * ys[:, None]
        u = (xw + ext) / (2 * ext) * (tex_size - 1)
        v = (yw + ext) / (2 * ext) * (tex_size - 1)
        u0 = np.clip(np.floor(u).astype(int), 0, tex_size - 2)
        v0 = np.clip(np.floor(v).astype(int), 0, tex_size - 2)
        fu = np.clip(u - u0, 0, 1)[..., None]
        fv = np.clip(v - v0, 0, 1)[..., None]
        img = (tex[v0, u0] * (1 - fu) * (1 - fv) +
               tex[v0, u0 + 1] * fu * (1 - fv) +
               tex[v0 + 1, u0] * (1 - fu) * fv +
               tex[v0 + 1, u0 + 1] * fu * fv)
        img = np.clip(img * gain + offset + noise, 0, 255).astype(np.uint8)
        path = os.path.join(img_dir, names[i])
        depth = t.astype(np.float32)
        if image_format == "npy":
            np.save(path, img)
        else:
            import PIL.Image

            PIL.Image.fromarray(img).save(path, quality=92)
        if depth_format == "bin":
            write_colmap_array(path + ".geometric.bin", depth)
        else:
            import h5py

            with h5py.File(os.path.join(
                    depth_dir, os.path.splitext(names[i])[0] + ".h5"),
                    "w") as f:
                f.create_dataset("depth", data=depth)

    # mild photometric variation and sensor noise for each capture (moves no
    # content), drawn in capture order; the captures render in threads
    # (numpy's array loops release the interpreter lock), a chunk at a time
    chunk = 32
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for start in range(0, n_caps, chunk):
            draws = [(i, rng.uniform(0.9, 1.1, (1, 1, 3)),
                      rng.uniform(-8, 8), rng.randint(-6, 6, (h, w, 3)))
                     for i in range(start, min(start + chunk, n_caps))]
            list(pool.map(lambda d: render(*d), draws))

    with open(os.path.join(scene_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                "# Number of cameras: 1\n"
                f"1 PINHOLE {w} {h} {f_len} {f_len} {w / 2} {h / 2}\n")

    lines = [
        "# Image list with two lines of data per image:\n",
        "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n",
        "#   POINTS2D[] as (X, Y, POINT3D_ID)\n",
        f"# Number of images: {n_caps}, mean observations per image: 1.0\n",
    ]
    for i, name in enumerate(names):
        # the positions the captures were rendered from, at full precision
        # (a 1e-4 pose truncation is a reprojection error of pixels)
        lines.append(f"{i + 1} 1.0 0.0 0.0 0.0 {txs[i]:.10f} "
                     f"{tys[i]:.10f} 0.0 1 {name}\n")
        lines.append("10 10 1\n")  # every capture observes point 1
    with open(os.path.join(scene_dir, "images.txt"), "w") as f:
        f.write("".join(lines))

    track = " ".join(f"{i + 1} 0" for i in range(n_caps))
    with open(os.path.join(scene_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as "
                "(IMAGE_ID, POINT2D_IDX)\n"
                "# Number of points: 1, mean track length: 1.0\n"
                f"1 0.0 0.0 {z0} 200 100 50 0.5 {track}\n")

    rel = [f"{scene_name}/dense/imgs/{n}" for n in names]
    if write_jsons:
        with open(os.path.join(root, "valid_list.json"), "w") as f:
            json.dump(rel, f)
        with open(os.path.join(root, "train.json"), "w") as f:
            json.dump(rel, f)
        with open(os.path.join(root, "val.json"), "w") as f:
            json.dump(rel[:2], f)

    # overlap matrix from the grid distance (neighbours overlap most)
    gx, gy = ix % side, ix // side
    d2 = (gx[:, None] - gx[None]) ** 2 + (gy[:, None] - gy[None]) ** 2
    dist = np.exp(-0.5 * d2).astype(np.float32)
    np.save(os.path.join(dm_dir, "dist_mat.npy"), dist)

    return _scene_config(root, scene_dir, img_dir, depth_dir, use_ram)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--captures", type=int, default=500)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--batch_size", type=int, default=24)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "bench_loader_scene"))
    ap.add_argument("--device_synth", action="store_true",
                    help="emit the device-synth layout (candidates + camera "
                         "matrices; the reprojection and occlusion check "
                         "run in the train step) instead of host "
                         "supervision")
    ap.add_argument("--use_ram", action="store_true",
                    help="preload images and depths to RAM (reference "
                         "--use_ram)")
    ap.add_argument("--keep", action="store_true",
                    help="reuse and keep the generated scene directory")
    ap.add_argument("--device_steps_per_s", type=float, default=None,
                    help="a train step rate to report beside the loader's "
                         "(measured elsewhere on the same card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Generate (or reuse) the scene, time the loader; returns the report it
    prints. The loader runs on the host; nothing here uses the card."""
    from cotr_tpu_torch.data.dataset import CotrDataset
    from cotr_tpu_torch.data.loader import PrefetchLoader

    args = parse_args(argv)
    if not args.keep and os.path.isdir(args.root):
        shutil.rmtree(args.root)
    marker = os.path.join(args.root, "train.json")
    t0 = time.time()
    if not os.path.exists(marker):
        cfg = generate_scene(args.root, args.captures, args.height,
                             args.width, use_ram=args.use_ram)
        print(f"scene generated: {args.captures} captures "
              f"{args.height}x{args.width} in {time.time() - t0:.1f}s")
    else:
        cfg = generate_scene(args.root, args.captures, args.height,
                             args.width, use_ram=args.use_ram,
                             skip_files=True)
    t0 = time.time()
    ds = CotrDataset(cfg, "train", seed=0, device_synth=args.device_synth)
    print(f"dataset built: {len(ds)} samples in {time.time() - t0:.1f}s")

    loader = PrefetchLoader(ds, args.batch_size, num_workers=args.workers,
                            seed=0)

    def cycle():
        while True:
            for b in loader:
                yield b

    it = cycle()
    # warm: scene caches, first reads
    next(it)
    t0 = time.time()
    n = 0
    for _ in range(args.batches):
        batch = next(it)
        n += 1
    dt = time.time() - t0
    it.close()  # stops the loader's producer
    bps = n / dt
    result = {
        "metric": "megadepth-path loader throughput",
        "captures": args.captures,
        "image_hw": [args.height, args.width],
        "batch_size": args.batch_size,
        "use_ram": args.use_ram,
        "batches_timed": n,
        "batches_per_s": round(bps, 3),
        "samples_per_s": round(bps * args.batch_size, 1),
        "keys": sorted(batch.keys()),
    }
    if args.device_steps_per_s is not None:
        result["device_steps_per_s"] = args.device_steps_per_s
    result["device_synth"] = args.device_synth
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
