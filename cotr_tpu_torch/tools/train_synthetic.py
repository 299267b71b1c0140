"""Train on the synthetic homography task and report held-out accuracy
(counterpart of tools/train_synthetic.py).

The whole training path runs: texture pool -> SyntheticHomographyDataset ->
PrefetchLoader -> Trainer (cycle loss, Adam groups, validation through the
attention kernels, checkpoints and resume), with the mean correspondence
error on a held-out batch before and after.

  python -m cotr_tpu_torch.tools.train_synthetic --steps 2000 \\
      --batch_size 24 --proc_textures 64 --tex_aug \\
      --textures 'textures/*.npy' --out out/synthetic_run

The flags and defaults are the JAX tool's, plus ``--textures`` (paths or
globs of image or ``.npy`` texture files; by default the JAX package's
texture glob) and ``--num_devices``. It runs on the card;
``main(argv, device="cpu")`` runs it on the CPU.

Data-parallel over N cards of a node (``--batch_size`` stays the global
batch; each rank's loader makes its rows, rank 0 writes the files and the
report, and a warm start takes rank 0's weights):

  torchrun --nproc_per_node N -m cotr_tpu_torch.tools.train_synthetic \
      --num_devices N ...
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _yes_no(v) -> bool:
    return str(v).lower() not in ("no", "false", "0")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch_size", type=int, default=24)
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--lr_backbone", type=float, default=1e-4,
                    help="the reference freezes its ImageNet-pretrained "
                         "backbone; training from scratch needs it on")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--lr_schedule", default="constant",
                    choices=["constant", "cosine"],
                    help="cosine decays every group's rate to "
                         "lr*lr_final_frac over --lr_decay_steps "
                         "(default: --steps)")
    ap.add_argument("--lr_decay_steps", type=int, default=0)
    ap.add_argument("--lr_final_frac", type=float, default=0.03)
    ap.add_argument("--enc_layers", type=int, default=6)
    ap.add_argument("--dec_layers", type=int, default=6)
    ap.add_argument("--num_kp", type=int, default=100)
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="0 by default: with a trainable backbone from "
                         "scratch, dropout 0.1 made the net co-adapt to the "
                         "noise")
    ap.add_argument("--epoch_len", type=int, default=65536,
                    help="unique synthetic samples; keep above "
                         "steps*batch to avoid memorization")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--device_warp", default=True, type=_yes_no,
                    help="warp the B side on the device inside the step "
                         "(default yes): halves the host's synthesis work")
    ap.add_argument("--zoom", action="store_true",
                    help="zoom-crop pairs: trains the scales the zoom "
                         "engine queries")
    ap.add_argument("--zoom_prob", type=float, default=1.0,
                    help="share of zoomed samples with --zoom")
    ap.add_argument("--rot_deg", type=float, default=0.0,
                    help="compose +/- this in-plane rotation (degrees) into "
                         "the pair homography")
    ap.add_argument("--scale_lo", type=float, default=0.0,
                    help="with --scale_hi: log-uniform relative scale "
                         "composed into the pair homography")
    ap.add_argument("--scale_hi", type=float, default=0.0)
    ap.add_argument("--proc_textures", type=int, default=0,
                    help="procedural textures appended to the texture pool")
    ap.add_argument("--tex_aug", action="store_true",
                    help="per-sample channel permutation and flips of the "
                         "texture crop (geometry unchanged)")
    ap.add_argument("--photo_jitter", type=float, default=0.0,
                    help="independent per-side photometric gain/bias")
    ap.add_argument("--textures", nargs="+", default=None,
                    help="texture files or globs (images, or .npy uint8 "
                         "(H, W, 3) arrays); default: the JAX package's "
                         "texture glob")
    ap.add_argument("--out", default="out/synthetic_run")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--init_weights", default=None,
                    help="warm-start the weights from a file that "
                         "checkpoint_io.load_params reads (.npz, .pth/.tar, "
                         "a Trainer .pt); the optimizer starts fresh")
    ap.add_argument("--valid_iter", type=int, default=0,
                    help="validation/checkpoint cadence (0 = steps//10, at "
                         "least 50)")
    ap.add_argument("--num_devices", type=int, default=None,
                    help="data-parallel ranks (torchrun --nproc_per_node); "
                         "must be the world size")
    return ap.parse_args(argv)


def texture_paths(specs: Optional[Sequence[str]]) -> Optional[List[str]]:
    """``--textures`` expanded: each entry a file or a glob, in order; None
    keeps the dataset's default."""
    if specs is None:
        return None
    paths: List[str] = []
    for spec in specs:
        hits = sorted(glob.glob(spec))
        if not hits:
            raise ValueError(f"--textures: nothing matches {spec!r}")
        paths.extend(hits)
    return paths


def build_datasets(args: argparse.Namespace):
    """(train, validation) datasets as the JAX tool builds them: seeds 1 and
    777, the validation set four batches long."""
    from cotr_tpu_torch.data.synthetic import SyntheticHomographyDataset

    paths = texture_paths(args.textures)
    aug = dict(rot_deg=args.rot_deg,
               scale_range=((args.scale_lo, args.scale_hi)
                            if args.scale_lo and args.scale_hi else None),
               photo_jitter=args.photo_jitter,
               proc_textures=args.proc_textures, tex_aug=args.tex_aug,
               device_warp=args.device_warp, zoom=args.zoom,
               zoom_prob=args.zoom_prob, num_kp=args.num_kp)
    train_ds = SyntheticHomographyDataset(paths, length=args.epoch_len,
                                          seed=1, **aug)
    val_ds = SyntheticHomographyDataset(paths, length=args.batch_size * 4,
                                        seed=777, **aug)
    return train_ds, val_ds


def build_trainer(args: argparse.Namespace, train_ds, val_ds,
                  device="cuda"):
    """A Trainer at step 0 with fresh weights (seed 0), or the weights of
    ``--init_weights``, its loaders prefetching from the two datasets."""
    from cotr_tpu_torch.config import COTRConfig, TrainConfig
    from cotr_tpu_torch.data.loader import PrefetchLoader
    from cotr_tpu_torch.models.checkpoint_io import load_params
    from cotr_tpu_torch.models.cotr import build_model
    from cotr_tpu_torch.parallel.mesh import process_shard, replicate
    from cotr_tpu_torch.training.trainer import Trainer

    model_cfg = COTRConfig(dtype=args.dtype, enc_layers=args.enc_layers,
                           dec_layers=args.dec_layers, dropout=args.dropout)
    train_cfg = TrainConfig(learning_rate=args.learning_rate,
                            lr_backbone=args.lr_backbone,
                            lr_schedule=args.lr_schedule,
                            lr_decay_steps=(args.lr_decay_steps
                                            or args.steps),
                            lr_final_frac=args.lr_final_frac,
                            batch_size=args.batch_size, max_iter=args.steps,
                            valid_iter=(args.valid_iter
                                        or max(args.steps // 10, 50)),
                            num_kp=args.num_kp, num_devices=args.num_devices,
                            out_dir=args.out, suffix="synthetic")
    shard = process_shard()
    trainer = Trainer(
        build_model(model_cfg), model_cfg, train_cfg,
        train_loader=PrefetchLoader(train_ds, args.batch_size,
                                    num_workers=args.workers, seed=1,
                                    shard=shard),
        val_loader=PrefetchLoader(val_ds, args.batch_size, shuffle=False,
                                  num_workers=args.workers, shard=shard),
        out_dir=args.out, device=device)
    trainer.initialize(seed=0)
    if args.init_weights:
        trainer.state.model.load_state_dict(
            load_params(args.init_weights, model_cfg), strict=True)
        if trainer.mesh is not None:
            replicate(trainer.state.model, trainer.mesh)
        _say(f"warm-started params from {args.init_weights}")
    return trainer


def _say(msg: str) -> None:
    from cotr_tpu_torch.parallel.mesh import is_rank_zero

    if is_rank_zero():
        print(msg)


def heldout_sample(val_ds, batch_size: int) -> Dict[str, np.ndarray]:
    """The held-out batch: the validation set's first."""
    from cotr_tpu_torch.data.loader import PrefetchLoader

    return next(iter(PrefetchLoader(val_ds, batch_size, num_workers=2,
                                    shuffle=False)))


def heldout_error(model, sample: Dict[str, np.ndarray]
                  ) -> Tuple[float, float]:
    """(mean, median) correspondence error on ``sample`` in pixels of the
    256-square halves: one deterministic forward on the model's device."""
    from cotr_tpu_torch.training.train_step import batch_canvas

    dev = next(model.parameters()).device
    batch = {k: torch.as_tensor(v).to(dev) for k, v in sample.items()
             if k in ("image", "crop", "h_mat", "photo", "queries")}
    model.eval()
    with torch.no_grad():
        pred = model(batch_canvas(batch), batch["queries"])
    err = np.linalg.norm(pred.cpu().numpy() - sample["targets"], axis=-1)
    # normalized canvas units -> pixels on the 256-square halves
    return float(err.mean() * 2 * 256), float(np.median(err) * 2 * 256)


def train_and_report(args: argparse.Namespace, trainer,
                     sample: Dict[str, np.ndarray]) -> dict:
    """Held-out error, training (resumed with ``--resume``), held-out error
    again, and the ``final`` checkpoint."""
    e0 = heldout_error(trainer.state.model, sample)
    _say(f"held-out corr error BEFORE: mean {e0[0]:.1f}px "
         f"median {e0[1]:.1f}px")
    t0 = time.time()
    trainer.train(resume=args.resume)
    seconds = time.time() - t0
    _say(f"trained {args.steps} steps in {seconds:.0f}s")
    e1 = heldout_error(trainer.state.model, sample)
    _say(f"held-out corr error AFTER:  mean {e1[0]:.1f}px "
         f"median {e1[1]:.1f}px")
    trainer.save_checkpoint("final")
    path = trainer._path("final")
    _say(f"checkpoint: {path}")
    return dict(before_px=e0, after_px=e1, train_s=seconds,
                step=trainer.state.step, checkpoint=path)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Train and report; under ``torchrun`` each rank joins the process
    group first and leaves it at the end."""
    from cotr_tpu_torch.parallel.mesh import init_distributed

    args = parse_args(argv)
    started = init_distributed(device)
    try:
        train_ds, val_ds = build_datasets(args)
        trainer = build_trainer(args, train_ds, val_ds, device=device)
        sample = heldout_sample(val_ds, args.batch_size)
        return train_and_report(args, trainer, sample)
    finally:
        if started:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
