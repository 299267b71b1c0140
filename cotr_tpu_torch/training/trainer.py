"""Training loop: iteration-driven epochs, periodic validation, checkpoint
and resume, TensorBoard metrics (counterpart of
cotr_tpu/training/trainer.py).

* epochs run until ``max_iter`` steps are taken;
* every ``valid_iter`` steps: validate, save the rolling ``checkpoint``, and
  every 10*valid_iter an archive ``ckpt_{step}``;
* resume restores step, weights and optimizer state, the skip's counters
  included; each step's dropout generator is seeded from (seed, step), so a
  resumed run repeats an unbroken one;
* TensorBoard (optional): train loss and cycle loss scalars, pred/target
  histograms, validation loss and correspondence renderings.

Checkpoints are ``torch.save`` files of ``{version, step, params,
opt_state}``, all tensors on the CPU.

Inside an initialized ``torch.distributed`` process group (``torchrun``)
the trainer is data-parallel over every rank (``parallel.mesh``): each rank
takes its rows of every global batch (or the rows a sharded loader made for
it), draws its dropout masks from a generator seeded apart, and validates
with the loss's global normalization; only rank 0 writes checkpoints,
``params.json`` and TensorBoard files. A checkpoint holds the full weights
and moments, so a run resumes at another world size.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from cotr_tpu_torch.config import (COTRConfig, TrainConfig, compact_name,
                                   save_params_json)
from cotr_tpu_torch.models.cotr import COTRModel
from cotr_tpu_torch.parallel.mesh import data_rows, is_rank_zero, make_mesh
from cotr_tpu_torch.training.train_step import (TrainState, batch_canvas,
                                                create_train_state,
                                                make_eval_step,
                                                make_train_step)
from cotr_tpu_torch.utils.device import resolve_device

#: batch keys the steps consume, across all layouts (host canvas, synthetic
#: device warp, device-synthesized supervision; see train_step.batch_views)
KEEP_KEYS = ("image", "queries", "targets", "crop", "h_mat", "photo",
             "cand", "qdepth", "qscale", "kinv_nn", "c2w_nn", "proj_q",
             "flip", "skey")


#: unsigned host dtypes torch computes little in: uploaded as the signed
#: type of their width and widened on the device, bits kept
_WIDEN = {np.dtype(np.uint16): (np.int16, torch.int32, 0xFFFF),
          np.dtype(np.uint32): (np.int32, torch.int64, 0xFFFFFFFF)}


def upload(array, device) -> torch.Tensor:
    """One batch field (numpy or a tensor) on ``device``. uint16 (the
    quantized depth) becomes int32 and uint32 (the sample key) int64 there,
    so the step computes in types torch supports; the bytes sent stay the
    narrow ones."""
    if torch.is_tensor(array):
        return array.to(device)
    array = np.asarray(array)
    if array.dtype not in _WIDEN:
        return torch.as_tensor(array).to(device)
    signed, wide, mask = _WIDEN[array.dtype]
    bits = torch.from_numpy(
        np.ascontiguousarray(array).view(signed).reshape(array.shape))
    return bits.to(device).to(wide) & mask


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


class Trainer:
    #: checkpoint payload layout version; bumped on structural changes so a
    #: stale restore fails loudly instead of misassigning state
    CKPT_VERSION = 1

    def __init__(self, model: COTRModel, model_cfg: COTRConfig,
                 train_cfg: TrainConfig,
                 train_loader: Callable[[], Iterable[Dict[str, np.ndarray]]],
                 val_loader: Optional[Callable[[], Iterable]] = None,
                 out_dir: Optional[str] = None, use_tensorboard: bool = True,
                 device="cuda", zero1_axis: Optional[str] = None):
        """``device``: the card (``cuda:LOCAL_RANK`` in a process group)
        unless the caller asks for the CPU. ``train_cfg.num_devices``, if
        given, must be the world size (1 without a process group) and divide
        the batch. ``zero1_axis="data"`` splits the moments of the
        parameters over the ranks (ZeRO-1)."""
        self.model = model
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.zero1_axis = zero1_axis
        self.mesh = make_mesh(train_cfg.num_devices) \
            if dist.is_initialized() else None
        world = 1 if self.mesh is None else self.mesh.size
        if train_cfg.num_devices not in (None, world):
            raise ValueError(f"num_devices={train_cfg.num_devices}, but "
                             f"{world} rank(s) run: start them with torchrun "
                             "--nproc_per_node N")
        if train_cfg.batch_size % world:
            raise ValueError(f"batch_size={train_cfg.batch_size} does not "
                             f"split over {world} ranks")
        self.device = resolve_device(device)
        if self.mesh is not None:
            if self.mesh.device.type != self.device.type:
                raise ValueError(f"device {device!r}, but the process "
                                 f"group runs on {self.mesh.device.type}")
            self.device = self.mesh.device
        #: whether this process writes the run's files
        self.is_main = is_rank_zero()
        self.out_dir = out_dir or os.path.join(
            train_cfg.out_dir, compact_name(model_cfg, train_cfg))
        os.makedirs(self.out_dir, exist_ok=True)
        if self.is_main:
            save_params_json(os.path.join(self.out_dir, "params.json"),
                             model_cfg, train_cfg)

        self._tb = None
        if use_tensorboard and self.is_main:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass  # no writer installed: train without TensorBoard
            else:
                self._tb = SummaryWriter(os.path.join(self.out_dir, "tb"))

        self._ckpt_dir = os.path.join(self.out_dir, "checkpoints")
        os.makedirs(self._ckpt_dir, exist_ok=True)

        self.state: Optional[TrainState] = None
        self._train_step = None
        self._eval_step = None

    # ------------------------------------------------------------- lifecycle

    def initialize(self, seed: Optional[int] = 0):
        """Step 0 on the trainer's device. The weights are drawn afresh from
        ``seed``; with ``seed=None`` the model keeps the weights it holds."""
        generator = None if seed is None else \
            torch.Generator().manual_seed(seed)
        self.state = create_train_state(self.model, self.cfg, generator,
                                        self.device, self.mesh,
                                        self.zero1_axis)
        self._train_step = make_train_step(self.cfg, self.mesh)
        self._eval_step = make_eval_step(self.cfg, self.mesh)

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of a batch, on its device: the rows of a global
        batch (``batch_size`` rows), or a batch that a sharded loader made
        for this rank alone (``batch_size / world`` rows)."""
        batch = {k: batch[k] for k in KEEP_KEYS if k in batch}
        if self.mesh is not None:
            rows = len(next(iter(batch.values())))
            if rows == self.cfg.batch_size:
                batch = {k: data_rows(v, self.mesh) for k, v in batch.items()}
            elif rows * self.mesh.size != self.cfg.batch_size:
                raise ValueError(f"a batch of {rows} rows is neither the "
                                 f"global batch ({self.cfg.batch_size}) nor "
                                 "one rank's share")
        return {k: upload(v, self.device) for k, v in batch.items()}

    # ----------------------------------------------------------- checkpoints

    def _path(self, tag: str) -> str:
        return os.path.join(self._ckpt_dir, f"{tag}.pt")

    def save_checkpoint(self, tag: str = "checkpoint"):
        """Every rank calls it (the moments are gathered); rank 0 writes."""
        payload = {
            "version": self.CKPT_VERSION,
            "step": self.state.step,
            "params": _to_cpu(self.state.model.state_dict()),
            "opt_state": _to_cpu(self.state.optimizer.state_dict()),
        }
        if not self.is_main:
            return
        tmp = self._path(tag) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(tag))

    def load_checkpoint(self, tag: str = "checkpoint") -> bool:
        path = self._path(tag)
        if not os.path.exists(path):
            return False
        restored = torch.load(path, map_location="cpu", weights_only=True)
        version = int(restored.get("version", -1))
        if version != self.CKPT_VERSION:
            raise ValueError(
                f"checkpoint at {path} has layout version {version}, "
                f"this trainer writes {self.CKPT_VERSION}; refusing a "
                "structurally ambiguous restore")
        model, optimizer = self.state.model, self.state.optimizer
        model.load_state_dict(restored["params"], strict=True)
        optimizer.load_state_dict(restored["opt_state"])
        self.state = TrainState(int(restored["step"]), model, optimizer)
        return True

    # -------------------------------------------------------------- training

    def validate(self) -> float:
        if self.val_loader is None:
            return float("nan")
        losses = []
        first = None
        for batch in self.val_loader():
            batch = self._batch(batch)
            out = self._eval_step(self.state.model, batch)
            losses.append(float(out["val_loss"]))
            if first is None and "queries" in batch and "targets" in batch:
                first = (batch, out["pred"])
        val = float(np.mean(losses)) if losses else float("nan")
        if self._tb is not None and np.isfinite(val):
            self._tb.add_scalar("loss/val", val, self.state.step)
            if first is not None:
                # ground-truth and predicted correspondence renderings
                from cotr_tpu_torch.training.tb import draw_corrs

                batch, pred = first
                img = batch_canvas({k: v[:4] for k, v in batch.items()})
                q = batch["queries"][:4]
                gt = torch.cat([q, batch["targets"][:4]], dim=-1)
                pd = torch.cat([q, pred[:4]], dim=-1)
                img, gt, pd = (t.cpu().numpy() for t in (img, gt, pd))
                self._tb.add_image("image/gt_corrs",
                                   draw_corrs(img, gt, (0, 255, 0))[0],
                                   self.state.step, dataformats="HWC")
                self._tb.add_image("image/pred_corrs",
                                   draw_corrs(img, pd, (255, 0, 0))[0],
                                   self.state.step, dataformats="HWC")
        return val

    def train(self, resume: bool = False) -> TrainState:
        if self.state is None:
            raise RuntimeError("call initialize() first")
        if resume:
            self.load_checkpoint()
        generator = torch.Generator(device=self.device)
        # each data rank draws its own masks; rank 0 those of one process
        rank_seed = 0 if self.mesh is None else \
            self.mesh.coordinate("data") << 40
        step = self.state.step
        t0 = time.time()
        while step < self.cfg.max_iter:
            for batch in self.train_loader():
                if step >= self.cfg.max_iter:
                    break
                # seeded from (seed, step): a resumed run draws the masks an
                # unbroken one would
                generator.manual_seed((self.cfg.seed + 1) * 1_000_003 + step
                                      + rank_seed)
                self.state, metrics = self._train_step(
                    self.state, self._batch(batch), generator)
                step += 1
                if (self._tb is not None and self.cfg.tb_iter > 0
                        and step % self.cfg.tb_iter == 0):
                    self._tb.add_scalar("loss/train", float(metrics["loss"]),
                                        step)
                    self._tb.add_scalar("loss/cycle",
                                        float(metrics["cycle_loss"]), step)
                    self._tb.add_histogram("distribution/pred",
                                           metrics["pred"].cpu().numpy(),
                                           step)
                    self._tb.add_histogram("distribution/target",
                                           metrics["target"].cpu().numpy(),
                                           step)
                if step % self.cfg.valid_iter == 0:
                    val = self.validate()
                    self.save_checkpoint()
                    if step % (10 * self.cfg.valid_iter) == 0:
                        self.save_checkpoint(f"ckpt_{step}")
                    dt = time.time() - t0
                    if self.is_main:
                        print(f"iter {step}: "
                              f"loss={float(metrics['loss']):.5f} "
                              f"val={val:.5f} ({dt:.0f}s)")
        return self.state
