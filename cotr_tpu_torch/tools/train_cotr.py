"""Train COTR on MegaDepth (counterpart of train_cotr.py): the paper's
three-stage recipe.

  stage 1: frozen backbone, bs 24, 300k iters
  stage 2: --lr_backbone 1e-5, bs 16, 2M iters (resume from stage 1)
  stage 3: --enable_zoom yes --crop_cam no_crop, bs 16, 300k iters

  python -m cotr_tpu_torch.tools.train_cotr --dataset_config md.json \\
      --load_weights_path checkpoints/flagship.npz --max_iter 1000

The flags and defaults are the JAX script's. Batches come from
``PrefetchLoader`` (half the host's cores, at least 2) and feed the port's
``Trainer``; checkpoints are the Trainer's ``.pt`` files; a ``params.json``
that disagrees with the options refuses the run unless ``--resume`` or a
``--suffix``. ``--device_synth yes`` sends the candidate layout of
``data.device_synth`` and synthesizes the supervision inside the train step
(stage 1/2 only). It runs on the card; ``main(argv, device="cpu")`` runs it
on the CPU.

Data-parallel over N cards of a node: ``torchrun --nproc_per_node N -m
cotr_tpu_torch.tools.train_cotr --num_devices N ...``. ``--batch_size``
stays the global batch; each rank's loader makes its rows, from datasets
whose random streams are seeded apart for each rank (a MegaDepth sample
draws from its dataset's stream, so the rows are not the one-process
batch's); rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


def str2bool(v: str) -> bool:
    return str(v).lower() in ("yes", "true", "y", "1")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # general
    ap.add_argument("--confirm", type=str2bool, default=True)
    ap.add_argument("--use_cc", type=str2bool, default=False,
                    help="cluster mode: auto-resume from last checkpoint")
    # dataset
    ap.add_argument("--dataset_config", default=None,
                    help="JSON file with scenes_name_list/valid_list/splits")
    ap.add_argument("--shuffle_data", type=str2bool, default=True)
    ap.add_argument("--use_ram", type=str2bool, default=False)
    ap.add_argument("--device_synth", type=str2bool, default=False,
                    help="synthesize supervision inside the train step "
                         "(data.device_synth): the loader emits candidate "
                         "depth pixels + camera matrices instead of running "
                         "reprojection/occlusion on the host. Stage-1/2 "
                         "(crop_center_and_resize) only.")
    ap.add_argument("--crop_cam", default="crop_center_and_resize")
    ap.add_argument("--scene_file", default=None)
    # kNN
    ap.add_argument("--pool_size", type=int, default=20)
    ap.add_argument("--k_size", type=int, default=1)
    # model
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--hidden_dim", type=int, default=256)
    ap.add_argument("--dim_feedforward", type=int, default=None)
    ap.add_argument("--nheads", type=int, default=8)
    ap.add_argument("--layer", default="layer3")
    ap.add_argument("--enc_layers", type=int, default=6)
    ap.add_argument("--dec_layers", type=int, default=6)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--position_embedding", default="lin_sine")
    ap.add_argument("--dilation", type=str2bool, default=False)
    # training
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--lr_backbone", type=float, default=0.0)
    ap.add_argument("--batch_size", type=int, default=24)
    ap.add_argument("--max_iter", type=int, default=300_000)
    ap.add_argument("--valid_iter", type=int, default=1000)
    ap.add_argument("--num_kp", type=int, default=100)
    ap.add_argument("--kp_pool", type=int, default=100)
    ap.add_argument("--bidirectional", type=str2bool, default=True)
    ap.add_argument("--cycle_consis", type=str2bool, default=True)
    ap.add_argument("--need_rotation", type=str2bool, default=False)
    ap.add_argument("--max_rotation", type=float, default=0.0)
    ap.add_argument("--rotation_chance", type=float, default=0.0)
    ap.add_argument("--enable_zoom", type=str2bool, default=False)
    ap.add_argument("--zoom_start", type=float, default=1.0)
    ap.add_argument("--zoom_end", type=float, default=0.1)
    ap.add_argument("--zoom_levels", type=int, default=10)
    ap.add_argument("--zoom_jitter", type=float, default=0.5)
    ap.add_argument("--out_dir", default="out")
    ap.add_argument("--suffix", default="")
    ap.add_argument("--resume", type=str2bool, default=False)
    ap.add_argument("--load_weights_path", default=None)
    ap.add_argument("--num_devices", type=int, default=None,
                    help="data-parallel ranks (torchrun --nproc_per_node); "
                         "must be the world size")
    ap.add_argument("--dtype", default="float32")
    return ap


def configs(args: argparse.Namespace):
    """(model config, train config) of the options."""
    from cotr_tpu_torch.config import COTRConfig, TrainConfig

    model_cfg = COTRConfig(
        backbone=args.backbone, layer=args.layer, hidden_dim=args.hidden_dim,
        nheads=args.nheads, enc_layers=args.enc_layers,
        dec_layers=args.dec_layers, dropout=args.dropout,
        dilation=args.dilation, position_embedding=args.position_embedding,
        dtype=args.dtype)
    train_cfg = TrainConfig(
        learning_rate=args.learning_rate, lr_backbone=args.lr_backbone,
        batch_size=args.batch_size, max_iter=args.max_iter,
        valid_iter=args.valid_iter, num_kp=args.num_kp,
        bidirectional=args.bidirectional, cycle_consis=args.cycle_consis,
        num_devices=args.num_devices, out_dir=args.out_dir,
        suffix=args.suffix)
    return model_cfg, train_cfg


def data_config(args: argparse.Namespace):
    """The ``DataConfig`` of ``--dataset_config`` and the options."""
    from cotr_tpu_torch.data.megadepth import DataConfig

    if not args.dataset_config:
        raise ValueError("--dataset_config JSON is required")
    with open(args.dataset_config) as f:
        raw = json.load(f)
    return DataConfig(
        scenes_name_list=raw["scenes_name_list"],
        valid_list_json=raw["valid_list_json"],
        train_json=raw["train_json"], val_json=raw["val_json"],
        test_json=raw.get("test_json", raw["val_json"]),
        crop_cam=args.crop_cam, use_ram=args.use_ram,
        pool_size=args.pool_size, k_size=args.k_size, num_kp=args.num_kp,
        kp_pool=args.kp_pool, bidirectional=args.bidirectional,
        need_rotation=args.need_rotation, max_rotation=args.max_rotation,
        rotation_chance=args.rotation_chance, zoom_start=args.zoom_start,
        zoom_end=args.zoom_end, zoom_levels=args.zoom_levels,
        zoom_jitter=args.zoom_jitter)


#: the datasets' seeds of rank r are the one-process seeds plus r times this
RANK_SEED_STRIDE = 1000


def build_datasets(args: argparse.Namespace, seed: int = 0):
    """(train, validation) datasets as the JAX script builds them: seeds
    ``seed`` and ``seed + 100``; the validation set in the host layout. In a
    process group each rank adds ``RANK_SEED_STRIDE`` times its rank to
    both."""
    from cotr_tpu_torch.parallel.mesh import process_shard

    seed += RANK_SEED_STRIDE * process_shard()[0]
    from cotr_tpu_torch.data.dataset import CotrDataset, CotrZoomDataset

    data_cfg = data_config(args)
    ds_cls = CotrZoomDataset if args.enable_zoom else CotrDataset
    ds_kw = {}
    if args.device_synth:
        if args.enable_zoom or args.crop_cam != "crop_center_and_resize":
            raise ValueError("--device_synth serves the stage-1/2 "
                             "pre-cropped layout (crop_center_and_resize, "
                             "no zoom)")
        ds_kw["device_synth"] = True
    train_ds = ds_cls(data_cfg, "train", seed=seed, **ds_kw)
    val_ds = ds_cls(data_cfg, "val", seed=seed + 100)
    _say(f"train queries: {len(train_ds)}, val queries: {len(val_ds)}")
    return train_ds, val_ds


def load_weights(model, path: str, model_cfg) -> None:
    """Warm-start ``model`` from ``path``: a reference ``.pth``/``.tar``
    through ``models.torch_convert``, anything else through
    ``load_params`` (an ``.npz``, a Trainer ``.pt``)."""
    if path.endswith((".pth", ".tar")):
        from cotr_tpu_torch.models.torch_convert import load_torch_checkpoint

        state = load_torch_checkpoint(path, model_cfg,
                                      device="cpu").state_dict()
        _say(f"loaded torch weights: {path}")
    else:
        from cotr_tpu_torch.models.checkpoint_io import load_params

        state = load_params(path, model_cfg)
        _say(f"loaded weights: {path}")
    model.load_state_dict(state, strict=True)


def _say(msg: str) -> None:
    from cotr_tpu_torch.parallel.mesh import is_rank_zero

    if is_rank_zero():
        print(msg)


def build_trainer(args: argparse.Namespace, train_ds, val_ds, run_dir: str,
                  device="cuda"):
    """A Trainer at step 0 (weights drawn from the train config's seed, or
    those of ``--load_weights_path``; the optimizer fresh), its loaders
    prefetching from the two datasets."""
    from cotr_tpu_torch.data.loader import PrefetchLoader
    from cotr_tpu_torch.models.cotr import build_model
    from cotr_tpu_torch.parallel.mesh import process_shard, replicate
    from cotr_tpu_torch.training.trainer import Trainer

    model_cfg, train_cfg = configs(args)
    workers = max((os.cpu_count() or 2) // 2, 2)
    shard = process_shard()
    trainer = Trainer(
        build_model(model_cfg), model_cfg, train_cfg,
        train_loader=PrefetchLoader(train_ds, args.batch_size,
                                    num_workers=workers,
                                    seed=train_cfg.seed, shard=shard),
        val_loader=PrefetchLoader(val_ds, args.batch_size, shuffle=False,
                                  num_workers=workers, shard=shard),
        out_dir=run_dir, device=device)
    trainer.initialize(seed=train_cfg.seed)
    if args.load_weights_path:
        load_weights(trainer.state.model, args.load_weights_path, model_cfg)
        if trainer.mesh is not None:
            replicate(trainer.state.model, trainer.mesh)
    return trainer


def run_dir_of(args: argparse.Namespace) -> str:
    """``out_dir/<compact name>``; exits when its params.json holds other
    options and neither ``--resume`` nor ``--use_cc`` is given."""
    from cotr_tpu_torch.config import check_params_json, compact_name

    model_cfg, train_cfg = configs(args)
    run_dir = os.path.join(args.out_dir, compact_name(model_cfg, train_cfg))
    params_json = os.path.join(run_dir, "params.json")
    if os.path.exists(params_json) and not (args.resume or args.use_cc):
        if not check_params_json(params_json, model_cfg, train_cfg):
            print("ERROR: params.json mismatch with a previous run at "
                  f"{run_dir}; refusing to silently drift. Use --resume or "
                  "a --suffix.")
            sys.exit(1)
    return run_dir


def main(argv: Optional[Sequence[str]] = None, device="cuda"):
    """Train; returns the trainer after its last step. Under ``torchrun``
    each rank joins the process group first and leaves it at the end."""
    from cotr_tpu_torch.parallel.mesh import init_distributed, is_rank_zero

    args = build_parser().parse_args(argv)
    started = init_distributed(device)
    try:
        return _train(args, device, is_rank_zero())
    finally:
        if started:
            import torch

            torch.distributed.destroy_process_group()


def _train(args: argparse.Namespace, device, is_main: bool):
    if args.confirm and not args.use_cc and is_main:
        from cotr_tpu_torch.utils.misc import confirm, print_notification

        print_notification([f"{k.rjust(25)}  {v}"
                            for k, v in sorted(vars(args).items())],
                           "OPTIONS")
        if sys.stdin.isatty() and not confirm():
            sys.exit(1)
    run_dir = run_dir_of(args)
    _, train_cfg = configs(args)
    train_ds, val_ds = build_datasets(args, seed=train_cfg.seed)
    trainer = build_trainer(args, train_ds, val_ds, run_dir, device=device)
    trainer.train(resume=args.resume or args.use_cc)
    return trainer


if __name__ == "__main__":
    main()
