"""Write the demo twins' golden images (counterpart of
tools/make_demo_goldens.py), and the rule a demo's output is held to
against its golden (``compare_to_golden``, the JAX package's
tests/test_demo_goldens.py).

Runs each demo twin (``python -m cotr_tpu_torch.demos.<name>``) with the
given weights and writes ``<name>.png`` under ``--out_dir``. The default
directory is ``tests/golden/torch_demos/``, beside the JAX package's
goldens (``tests/golden/demos/``), never in it. The demos' default inputs
are the reference's sample images; arguments after ``--`` are passed to
every demo (e.g. ``-- --img_a a.npy --img_b b.npy``), so other inputs can
stand in. The demos run from the caller's directory, where relative paths
resolve and side outputs (``dense_output.png``) land.

  python -m cotr_tpu_torch.tools.make_demo_goldens \\
      --weights checkpoints/flagship.npz [--only demo_wbs] [-- ARGS]

The demos run on the card; ``main(argv, device="cpu")`` runs them on the
CPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEMOS = [
    ("demo_single_pair", []),
    ("demo_face", []),
    ("demo_homography", []),
    ("demo_guided_matching", []),
    ("demo_reconstruction", []),
    ("demo_wbs", []),
]

#: a pixel is off when a channel differs by more than this (of 255): below
#: it, sub-pixel shifts of the predictions move anti-aliased overlay edges
PIXEL_OFF = 40
#: the share of pixels off must stay below this, and the mean of every
#: pixel's largest channel difference below MEAN_DEV_MAX
FRAC_OFF_MAX = 0.02
MEAN_DEV_MAX = 3.0


def compare_to_golden(got: np.ndarray, want: np.ndarray) -> dict:
    """Hold a demo's output against its golden, both uint8 images (grey,
    RGB or RGBA, compared as RGB): equal shapes, under ``FRAC_OFF_MAX`` of
    the pixels off by more than ``PIXEL_OFF``, and a mean deviation under
    ``MEAN_DEV_MAX``. A share alone, not a global mean: a mean could hide a
    visibly different set of correspondences. Returns {"ok", "frac_off",
    "mean_dev", "shapes"}."""
    from cotr_tpu_torch.demos.demo_utils import to_rgb

    got = to_rgb(got).astype(np.float32)
    want = to_rgb(want).astype(np.float32)
    if got.shape != want.shape:
        return dict(ok=False, frac_off=None, mean_dev=None,
                    shapes=[got.shape, want.shape])
    diff = np.abs(got - want).max(axis=-1)  # each pixel's largest channel
    frac_off = float((diff > PIXEL_OFF).mean())
    mean_dev = float(diff.mean())
    return dict(ok=frac_off < FRAC_OFF_MAX and mean_dev < MEAN_DEV_MAX,
                frac_off=frac_off, mean_dev=mean_dev,
                shapes=[got.shape, want.shape])


def parse_args(argv: Optional[Sequence[str]] = None):
    """(options, the arguments after ``--``)."""
    argv = list(argv) if argv is not None else None
    if argv is None:
        import sys

        argv = sys.argv[1:]
    passthrough = []
    if "--" in argv:
        cut = argv.index("--")
        argv, passthrough = argv[:cut], argv[cut + 1:]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", required=True,
                    help="weights the demos load ('none': fresh weights "
                         "drawn from a seed)")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--only", default=None,
                    help="comma-separated demo names to regenerate")
    ap.add_argument("--out_dir",
                    default=os.path.join(REPO, "tests", "golden",
                                         "torch_demos"))
    return ap.parse_args(argv), passthrough


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> list:
    """Run the demos; returns the paths written."""
    from cotr_tpu_torch.utils.device import module_command

    args, passthrough = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    only = set(args.only.split(",")) if args.only else None
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])

    # 'none': the demos draw fresh weights
    weights = args.weights if args.weights.lower() == "none" else \
        os.path.abspath(args.weights)
    written = []
    for name, extra in DEMOS:
        if only and name not in only:
            continue
        out = os.path.abspath(os.path.join(args.out_dir, f"{name}.png"))
        cmd = module_command(f"cotr_tpu_torch.demos.{name}", device) + [
            "--load_weights_path", weights,
            "--dtype", args.dtype, "--out", out] + extra + passthrough
        if name == "demo_reconstruction":
            # keep the point-cloud side output out of the repository
            cmd += ["--out_pcd", os.path.join(tempfile.gettempdir(),
                                              "reconstruction.npy")]
        print("::", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True, env=env)
        if not os.path.exists(out):
            raise FileNotFoundError(f"{name} wrote no {out}")
        print(f":: wrote {out}", flush=True)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
