"""TensorBoard helpers: datapack/pusher pattern and correspondence
renderings (counterpart of cotr_tpu/training/tb.py), numpy only."""

from __future__ import annotations

from typing import Dict

import numpy as np

from cotr_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD


class TensorboardDatapack:
    """Typed payload dictionary."""

    def __init__(self):
        self.training = True
        self.iteration = 0
        self.scalar: Dict[str, float] = {}
        self.histogram: Dict[str, np.ndarray] = {}
        self.image: Dict[str, np.ndarray] = {}
        self.text: Dict[str, str] = {}

    def set_training(self, training: bool):
        self.training = training

    def set_iteration(self, it: int):
        self.iteration = it

    def add_scalar(self, d: Dict[str, float]):
        self.scalar.update(d)

    def add_histogram(self, d: Dict[str, np.ndarray]):
        self.histogram.update(d)

    def add_image(self, d: Dict[str, np.ndarray]):
        self.image.update(d)

    def add_text(self, d: Dict[str, str]):
        self.text.update(d)


class TensorboardPusher:
    """Writes datapacks through tensorboardX."""

    def __init__(self, log_dir: str):
        from tensorboardX import SummaryWriter

        self.writer = SummaryWriter(log_dir)

    def push_to_tensorboard(self, pack: TensorboardDatapack):
        for k, v in pack.scalar.items():
            self.writer.add_scalar(k, v, pack.iteration)
        for k, v in pack.histogram.items():
            self.writer.add_histogram(k, v, pack.iteration)
        for k, v in pack.image.items():
            self.writer.add_image(k, v, pack.iteration, dataformats="HWC")
        for k, v in pack.text.items():
            self.writer.add_text(k, v, pack.iteration)
        self.writer.flush()


def draw_corrs(canvases: np.ndarray, corrs: np.ndarray,
               color=(255, 0, 0)) -> np.ndarray:
    """Render correspondence lines onto normalized canvases.

    canvases: (B, 256, 512, 3) ImageNet-normalized; corrs: (B, N, 4)
    normalized canvas coords. Returns uint8 (B, 256, 512, 3)."""
    mean = np.asarray(IMAGENET_MEAN, dtype=np.float32)
    std = np.asarray(IMAGENET_STD, dtype=np.float32)
    out = []
    h, w = canvases.shape[1:3]
    for canvas, cs in zip(canvases, corrs):
        img = np.asarray(canvas, dtype=np.float32) * std + mean
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8).copy()
        for x0, y0, x1, y1 in cs:
            p0 = np.array([x0 * w, y0 * h])
            p1 = np.array([x1 * w, y1 * h])
            n = int(max(np.abs(p1 - p0).max(), 1))
            ts = np.linspace(0, 1, n + 1)
            pts = (p0[None] * (1 - ts[:, None]) + p1[None] * ts[:, None])
            xs = np.clip(pts[:, 0].astype(int), 0, w - 1)
            ys = np.clip(pts[:, 1].astype(int), 0, h - 1)
            img[ys, xs] = color
        out.append(img)
    return np.stack(out)
