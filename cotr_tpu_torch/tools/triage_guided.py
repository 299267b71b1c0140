"""Tell the card's own variation from the engine's in the guided-matching
job (counterpart of tools/triage_guided.py).

For ``--rounds`` rounds in one process, interleaved:

  1. a probe: a chained bfloat16 1024^3 matrix product
     (``utils/profiling.chained_op_time``), the card's throughput with no
     host or engine code in the way;
  2. the guided job: both directions of one image pair, 4 zoom levels, the
     keypoints of each image as queries, through ``FasterSparseEngine`` in
     one multi-pair call;
  3. the same job as two serial ``cotr_corr_multiscale`` calls.

If the guided walls follow the probe across rounds, their spread is the
card's, not the engine's: the report gives medians, IQRs and the
probe-vs-wall correlations. Writes ``--out``.

The JAX tool reads the reference's two MegaDepth sample images and their
DISK keypoints; ``--img_a --img_b --kpts_a --kpts_b`` name other inputs
(images as ``.npy`` uint8 (H, W, 3) arrays, or image files where imageio
is installed; keypoints as ``.npy`` (N, 2) pixel arrays) and default to
those files. ``speedup_vs_ref_79s`` divides the reference's 79 s on its
own images (a GTX 1080 Ti, BASELINE.md) by the multi-pair wall; on other
inputs it is ``null`` and ``reading`` says why.

  python -m cotr_tpu_torch.tools.triage_guided --rounds 8

It runs on the card; ``main(argv, device="cpu")`` runs it on the CPU and
returns the summary.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

from cotr_tpu_torch.demos.demo_utils import SAMPLE_DIR

#: the reference's guided-matching inputs
REF_INPUTS = {
    "img_a": f"{SAMPLE_DIR}/imgs/21526113_4379776807.jpg",
    "img_b": f"{SAMPLE_DIR}/imgs/21126421_4537535153.jpg",
    "kpts_a": f"{SAMPLE_DIR}/21526113_4379776807.jpg.disk.kpts.npy",
    "kpts_b": f"{SAMPLE_DIR}/21126421_4537535153.jpg.disk.kpts.npy",
}

#: the reference's guided-matching wall on its own images, in seconds
REF_WALL_S = 79.0

READING = ("probe-vs-wall correlation >~0.6 with a wide probe spread "
           "attributes the round-to-round drift of the guided walls to the "
           "card's own variation (clocks, power, other work); near-zero "
           "correlation with a tight probe spread would indicate a real "
           "engine-side regression instead")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--ckpt", default="checkpoints/flagship.npz")
    ap.add_argument("--out", default="out/triage_guided.json")
    for key, path in REF_INPUTS.items():
        ap.add_argument(f"--{key}", default=path)
    return ap.parse_args(argv)


def stats(v) -> dict:
    s = np.sort(v)
    n = len(s)
    return {"median": round(float(s[n // 2]), 3),
            "iqr": [round(float(s[n // 4]), 3),
                    round(float(s[(3 * n) // 4]), 3)],
            "min": round(float(s[0]), 3), "max": round(float(s[-1]), 3)}


def corr(a, b):
    if len(a) < 3 or a.std() == 0 or b.std() == 0:
        return None
    return round(float(np.corrcoef(a, b)[0, 1]), 3)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    import torch

    from cotr_tpu_torch.demos.demo_utils import load_image
    from cotr_tpu_torch.inference.engine import FasterSparseEngine
    from cotr_tpu_torch.tools.triage_dense import flagship_runner
    from cotr_tpu_torch.utils.device import resolve_device
    from cotr_tpu_torch.utils.profiling import chained_op_time

    args = parse_args(argv)
    dev = resolve_device(device)
    engine = FasterSparseEngine(flagship_runner(args.ckpt, args.dtype, dev),
                                mode="tile")

    g_a, g_b = load_image(args.img_a), load_image(args.img_b)
    kp_a, kp_b = np.load(args.kpts_a), np.load(args.kpts_b)
    zoom4 = list(np.linspace(0.5, 0.0625, 4))
    answers = {}

    def guided_multipair():
        answers["multipair"] = engine.cotr_corr_multiscale_multipair(
            [(g_a, g_b), (g_b, g_a)], zoom_ins=zoom4, converge_iters=1,
            max_corrs=[kp_a.shape[0], kp_b.shape[0]],
            queries_list=[kp_a.astype(np.float64),
                          kp_b.astype(np.float64)], force=True)

    def guided_serial():
        answers["serial"] = [engine.cotr_corr_multiscale(
            img, other, zoom_ins=zoom4, converge_iters=1,
            max_corrs=kp.shape[0], queries_a=kp.astype(np.float64),
            force=True) for img, other, kp in ((g_a, g_b, kp_a),
                                               (g_b, g_a, kp_b))]

    # probe: a bf16 1024^3 product consuming the chain scalar, about
    # 2.1 GFLOP a call: long enough to see the card's own variation, short
    # enough to sample every round
    m = torch.ones((1024, 1024), dtype=torch.bfloat16, device=dev)

    def probe_fn(acc, m):
        return (m @ (m * (1.0 + acc * 0.0))).sum().float()

    def probe_ms():
        return chained_op_time(probe_fn, m, iters=30)

    probe_ms()          # warm
    guided_multipair()  # warm every engine shape
    guided_serial()

    rounds = []
    for _ in range(args.rounds):
        p0 = probe_ms()
        t0 = time.perf_counter()
        guided_multipair()
        mp_wall = time.perf_counter() - t0
        p1 = probe_ms()
        t0 = time.perf_counter()
        guided_serial()
        ser_wall = time.perf_counter() - t0
        p2 = probe_ms()
        rounds.append({"probe_ms": [round(p, 3) for p in (p0, p1, p2)],
                       "multipair_wall_s": round(mp_wall, 3),
                       "serial_wall_s": round(ser_wall, 3)})
        print(json.dumps(rounds[-1]), flush=True)
    for name, out in answers.items():
        if not all(np.isfinite(c).all() for c in out):
            raise ValueError(f"the {name} guided job returned non-finite "
                             "correspondences")

    mp = np.array([r["multipair_wall_s"] for r in rounds])
    ser = np.array([r["serial_wall_s"] for r in rounds])
    pr = np.array([np.mean(r["probe_ms"]) for r in rounds])

    on_ref = all(os.path.abspath(getattr(args, key)) == os.path.abspath(path)
                 for key, path in REF_INPUTS.items())
    if on_ref:
        speedup = {"median": round(REF_WALL_S / float(np.median(mp)), 2),
                   "at_min_wall": round(REF_WALL_S / float(mp.min()), 2),
                   "at_max_wall": round(REF_WALL_S / float(mp.max()), 2)}
        reading = READING
    else:
        speedup = None
        reading = (READING + ". speedup_vs_ref_79s is null: the reference's "
                   "79 s was measured on its own two images and keypoints, "
                   "and these inputs are others")
    summary = {
        "rounds": rounds,
        "probe_ms": stats(pr),
        "multipair": {**stats(mp), "speedup_vs_ref_79s": speedup},
        "serial": stats(ser),
        "corr_probe_vs_multipair": corr(pr, mp),
        "corr_probe_vs_serial": corr(pr, ser),
        "reading": reading,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: summary[k] for k in
                      ("probe_ms", "multipair", "serial",
                       "corr_probe_vs_multipair")}))
    print(f"wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
