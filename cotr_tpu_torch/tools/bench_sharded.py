"""Sharded inference at two mesh sizes (counterpart of tools/bench_sharded.py).

Runs the two sharded inference paths, the squad stepper
(``GroupedStepper``) and the scan refiner (``BatchRefiner``), unsharded and
on a local mesh of N entries, and writes a JSON file with each run's wall
time, the work each mesh entry took (canvases, tasks) and the deviation of
the sharded outputs from the unsharded ones, which must be within
``STEPPER_TOL`` (raw stepper outputs) and within the "same refinement,
other dispatch composition" gate (the scan refiner's pixels).

The mesh lists the first N cards when there are N, else the one device N
times (``--devices`` names them). On one device listed N times the N shares
run one after another: the run proves that the squad and task axes split N
ways, each entry taking 1/N of the work, with the same outputs. It proves
no speed, and its wall times are recorded for completeness only.

  python -m cotr_tpu_torch.tools.bench_sharded --n 2 --out sharded.json

It runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

#: raw stepper outputs, sharded against unsharded (normalized coordinates)
STEPPER_TOL = 1e-4
#: the scan refiner's pixels: a sharded dispatch composes its batches
#: otherwise, and patch_box's floor turns rounding into whole-pixel box
#: shifts for a few tasks
SAME_WITHIN_1PX = 0.95
SAME_MEDIAN_PX = 0.1


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="sharded.json")
    ap.add_argument("--enc_layers", type=int, default=6)
    ap.add_argument("--dec_layers", type=int, default=6)
    ap.add_argument("--groups", type=int, default=16,
                    help="squads (grouped path) per dispatch; a multiple of "
                         "--n")
    ap.add_argument("--members", type=int, default=64,
                    help="queries per squad (grouped path); the scan path "
                         "refines groups x members tasks")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--n", type=int, default=8, help="mesh entries")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices of the mesh (default: the "
                         "first N cards, or the one device N times)")
    return ap.parse_args(argv)


def mesh_devices(args, device) -> list:
    from cotr_tpu_torch.utils.device import resolve_device

    if args.devices:
        devices = args.devices.split(",")
        if len(devices) != args.n:
            raise ValueError(f"--devices lists {len(devices)}, --n is "
                             f"{args.n}")
        return devices
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= args.n:
        return [f"cuda:{i}" for i in range(args.n)]
    return [str(dev)] * args.n


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, iters: int, device: torch.device):
    """(last output, seconds a call): one untimed call first on the card
    (kernel builds, cuDNN's choices), then ``iters`` calls."""
    if device.type == "cuda":
        fn()
        _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) / iters


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    args = parse_args(argv)
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.inference.grouped import GroupedStepper
    from cotr_tpu_torch.inference.refine import BatchRefiner
    from cotr_tpu_torch.inference.runner import ModelRunner
    from cotr_tpu_torch.models.cotr import build_model, init_weights
    from cotr_tpu_torch.parallel.mesh import make_mesh

    if args.groups % args.n:
        raise ValueError(f"--groups {args.groups} must be a multiple of "
                         f"--n {args.n}")
    devices = mesh_devices(args, device)
    model = build_model(COTRConfig(enc_layers=args.enc_layers,
                                   dec_layers=args.dec_layers, dropout=0.0))
    init_weights(model, torch.Generator().manual_seed(0))
    runner = ModelRunner(model, device=devices[0])
    dev = runner.device

    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.uniform(0, 1, (512, 512, 3))
                           .astype(np.float32)).to(dev)
    g, m = args.groups, args.members
    boxes = np.concatenate(
        [np.floor(rng.uniform(0, 256, (g, 2))).astype(np.float32),
         np.full((g, 2), 256.0, np.float32)], axis=1)
    queries = rng.uniform(0.05, 0.45, (g, m, 2)).astype(np.float32)
    tasks = g * m
    loc = rng.uniform(60.0, 450.0, (tasks, 2))
    zooms = [0.5, 0.25]

    result = {
        "kind": "sharded inference on a local mesh",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "mesh": devices,
        "model": {"enc_layers": args.enc_layers,
                  "dec_layers": args.dec_layers},
        "note": ("one device listed N times runs the N shares in turn: the "
                 "evidence is the N-way split of the squad and task axes "
                 "with equal outputs, not a speed"),
        "configs": {},
    }
    outs = {}
    for n in (1, args.n):
        mesh = make_mesh(devices=devices) if n > 1 else None
        stepper = GroupedStepper(runner, mesh=mesh)
        out, wall = _timed(lambda: stepper(img, img, boxes, boxes, queries),
                           args.iters, dev)
        outs[("grouped", n)] = out
        calls = stepper.dispatch_count
        result["configs"][f"grouped_n{n}"] = {
            "squads": g, "queries_per_squad": m,
            "canvases_per_device": [c // calls for c in
                                    stepper.device_canvas_count],
            "queries_per_dispatch": g * m, "wall_s": wall,
            "q_s_wall": g * m / wall}

        refiner = BatchRefiner(runner, mesh=mesh)
        hw = tuple(img.shape[:2])
        hist, wall = _timed(lambda: refiner.refine(
            img, hw, img, hw, loc.copy(), loc.copy(), 1.0, 1.0, zooms),
            args.iters, dev)
        outs[("scan", n)] = hist
        calls = sum(refiner.device_task_count) // tasks
        result["configs"][f"scan_n{n}"] = {
            "tasks": tasks, "zoom_depth": len(zooms),
            "tasks_per_device": [c // calls for c in
                                 refiner.device_task_count],
            "wall_s": wall, "q_s_wall": tasks / wall}

    n = args.n
    dev_grouped = float(np.max(np.abs(outs[("grouped", n)]
                                      - outs[("grouped", 1)])))
    result["configs"][f"grouped_n{n}"]["max_abs_dev_vs_n1"] = dev_grouped
    px = np.linalg.norm(outs[("scan", n)][-1] - outs[("scan", 1)][-1],
                        axis=-1)
    result["configs"][f"scan_n{n}"].update(
        max_px_dev_vs_n1=float(px.max()),
        share_within_1px=float(np.mean(px <= 1.0)),
        median_px_dev=float(np.median(px)))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    if dev_grouped > STEPPER_TOL:
        raise AssertionError(f"sharded stepper off by {dev_grouped:.3e} "
                             f"(gate {STEPPER_TOL})")
    if np.mean(px <= 1.0) < SAME_WITHIN_1PX or \
            np.median(px) > SAME_MEDIAN_PX:
        raise AssertionError(f"sharded scan refiner: {np.mean(px <= 1.0):.1%}"
                             f" within 1 px, median {np.median(px):.3f} px")
    return result


if __name__ == "__main__":
    main()
