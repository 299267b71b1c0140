"""Publish a trained checkpoint as the committed flagship weights
(counterpart of tools/publish_flagship.py).

Converts any weight file ``load_params`` reads (a port ``Trainer`` ``.pt``,
an ``.npz``, a reference ``.pth``/``.tar``) into the repo's committable
``.npz`` release format (bf16 bit patterns,
``models/checkpoint_io.save_params_npz``) plus a provenance JSON next to
it. Format conversion only, on the host.

    python -m cotr_tpu_torch.tools.publish_flagship \\
        --ckpt out/run/checkpoints/final.pt --eval_json out/eval/eval_pair.json
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from cotr_tpu_torch.data.synthetic import SyntheticHomographyDataset
from cotr_tpu_torch.models.checkpoint_io import load_params, save_params_npz


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--eval_json", action="append", default=None,
                    help="eval_synthetic_pair metrics to embed as "
                         "provenance (repeatable: one per held-out eval "
                         "texture, keyed by image name)")
    ap.add_argument("--out", default="checkpoints/flagship.npz")
    ap.add_argument("--note", default=None,
                    help="free-text provenance note (training history, "
                         "warm-start lineage) embedded in the JSON")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the provenance written beside ``--out``."""
    args = parse_args(argv)
    params = load_params(args.ckpt, None)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_params_npz(params, args.out)
    size_mb = os.path.getsize(args.out) / 1e6

    meta = {"source": os.path.abspath(args.ckpt), "format": "npz-bf16",
            "size_mb": round(size_mb, 1)}
    # the run's training config, so the provenance is verifiable from the
    # committed file alone: params.json lives two levels above
    # .../checkpoints/<name>
    run_dir = os.path.dirname(os.path.dirname(os.path.abspath(args.ckpt)))
    params_json = os.path.join(run_dir, "params.json")
    if os.path.exists(params_json):
        with open(params_json) as f:
            meta["training"] = json.load(f)
    meta["eval_textures_excluded_from_training"] = list(
        SyntheticHomographyDataset.EVAL_TEXTURES)
    if args.note:
        meta["note"] = args.note
    evals = {}
    for pth in (args.eval_json or []):
        if os.path.exists(pth):
            with open(pth) as f:
                e = json.load(f)
            evals[e.get("image", os.path.basename(pth))] = e
    if len(evals) == 1:
        meta["eval"] = next(iter(evals.values()))
    elif evals:
        meta["eval"] = evals
    with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta))
    print(f"wrote {args.out} ({size_mb:.1f} MB)")
    return meta


if __name__ == "__main__":
    main()
