"""Convert a reference PyTorch COTR checkpoint to the ``.npz`` weight file
that both packages read (counterpart of tools/convert_checkpoint.py, which
writes an Orbax checkpoint; there is no Orbax here).

    python -m cotr_tpu_torch.tools.convert_checkpoint \\
        --torch checkpoint.pth.tar --out converted.npz [--verify]

The weights are stored in float32, as the JAX tool keeps them. With
``--verify`` the model runs once from the ``.pth`` and once from the
``.npz`` it wrote, on the same seeded canvas and queries, and the two
outputs must be equal.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from cotr_tpu_torch.config import COTRConfig
from cotr_tpu_torch.models.checkpoint_io import load_model, save_params_npz
from cotr_tpu_torch.models.torch_convert import load_torch_checkpoint
from cotr_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--torch", required=True, dest="torch_path")
    ap.add_argument("--out", required=True)
    ap.add_argument("--verify", action="store_true")
    return ap.parse_args(argv)


def verify_inputs() -> tuple:
    """The JAX tool's check inputs: a canvas and 8 queries from
    ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    canvas = rng.uniform(-1, 1, (1, 256, 512, 3)).astype(np.float32)
    queries = rng.uniform(0.05, 0.95, (1, 8, 2)).astype(np.float32)
    return canvas, queries


@torch.inference_mode()
def forward(model, device) -> np.ndarray:
    canvas, queries = verify_inputs()
    return model(torch.from_numpy(canvas).to(device),
                 torch.from_numpy(queries).to(device)).cpu().numpy()


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Returns ``parameters`` and, with ``--verify``, ``max_abs_dev`` and
    the two outputs."""
    args = parse_args(argv)
    dev = resolve_device(device)
    cfg = COTRConfig()
    model = load_torch_checkpoint(args.torch_path, cfg, device=dev)
    n = sum(p.numel() for p in model.state_dict().values())
    print(f"converted {n:,} parameters")
    save_params_npz(model, args.out, dtype="float32")
    print(f"wrote npz weights: {args.out}")
    result = {"parameters": n}

    if args.verify:
        from_pth = forward(model, dev)
        from_npz = forward(load_model(args.out, cfg, device=dev), dev)
        dev_max = float(np.abs(from_pth - from_npz).max())
        print("forward from the .pth:", from_pth[0, :3])
        print(f"max deviation of the forward from the .npz: {dev_max:.3e}")
        if not np.array_equal(from_pth, from_npz):
            raise AssertionError(f"the .npz forward differs from the .pth "
                                 f"one by up to {dev_max}")
        result.update(max_abs_dev=dev_max, from_pth=from_pth,
                      from_npz=from_npz)
    return result


if __name__ == "__main__":
    main()
