"""Host helpers that turn correspondences into fixed-shape training samples
(counterpart of the helpers of cotr_tpu/data/dataset.py): resample to
``num_kp``, flip augmentation, canvas normalization, bidirectional doubling,
and batching. numpy only; the MegaDepth datasets are not here yet."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from cotr_tpu_torch.utils.constants import (IMAGENET_MEAN, IMAGENET_STD,
                                           MAX_SIZE)


def two_images_side_by_side(img_a: np.ndarray,
                            img_b: np.ndarray) -> np.ndarray:
    """Concatenate two equal-shaped HWC images along width."""
    if img_a.shape != img_b.shape:
        raise ValueError(f"{img_a.shape} vs {img_b.shape}")
    return np.concatenate([img_a, img_b], axis=1)


def normalize_canvas(canvas: np.ndarray) -> np.ndarray:
    """uint8 or float (N)HWC canvas -> ImageNet-normalized float32 (uint8 is
    scaled by 1/255 first)."""
    x = np.asarray(canvas, dtype=np.float32)
    if canvas.dtype == np.uint8:
        x = x / 255.0
    mean = np.asarray(IMAGENET_MEAN, dtype=np.float32)
    std = np.asarray(IMAGENET_STD, dtype=np.float32)
    return (x - mean) / std


def _trim_corrs(corrs: np.ndarray, num_kp: int,
                rng: np.random.RandomState) -> np.ndarray:
    """Resample with replacement to exactly num_kp rows."""
    n = corrs.shape[0]
    if n >= num_kp:
        return corrs[rng.choice(n, num_kp)]
    extra = corrs[rng.choice(n, num_kp - n)]
    return np.concatenate([corrs, extra], axis=0)


def _package(query_img: np.ndarray, nn_img: np.ndarray, corrs: np.ndarray,
             bidirectional: bool, rng: np.random.RandomState,
             raw_uint8: bool = False) -> Dict[str, np.ndarray]:
    """Flip augmentation + canvas normalization + bidirectional doubling.

    With ``raw_uint8`` the canvas stays uint8 and is normalized on the
    device inside the step (a quarter of the bytes to upload)."""
    corrs = corrs.astype(np.float64).copy()
    if rng.uniform() < 0.5:
        corrs[:, 0] = MAX_SIZE - 1 - corrs[:, 0]
        corrs[:, 2] = MAX_SIZE - 1 - corrs[:, 2]
        sbs = two_images_side_by_side(np.fliplr(query_img), np.fliplr(nn_img))
    else:
        sbs = two_images_side_by_side(query_img, nn_img)
    corrs[:, 2] += MAX_SIZE
    corrs /= np.array([MAX_SIZE * 2, MAX_SIZE, MAX_SIZE * 2, MAX_SIZE])
    if not ((0.0 <= corrs[:, 0]).all() and (corrs[:, 0] <= 0.5).all()
            and (0.0 <= corrs[:, 1]).all() and (corrs[:, 1] <= 1.0).all()
            and (0.5 <= corrs[:, 2]).all() and (corrs[:, 2] <= 1.0).all()
            and (0.0 <= corrs[:, 3]).all() and (corrs[:, 3] <= 1.0).all()):
        raise ValueError("correspondences outside their canvas halves")
    sbs = np.ascontiguousarray(sbs)
    out = {
        "image": (sbs.astype(np.uint8) if raw_uint8
                  else normalize_canvas(sbs)),
        "corrs": corrs.astype(np.float32),
    }
    if bidirectional:
        out["queries"] = np.concatenate([corrs[:, :2], corrs[:, 2:]],
                                        axis=0).astype(np.float32)
        out["targets"] = np.concatenate([corrs[:, 2:], corrs[:, :2]],
                                        axis=0).astype(np.float32)
    else:
        out["queries"] = corrs[:, :2].astype(np.float32)
        out["targets"] = corrs[:, 2:].astype(np.float32)
    return out


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Stack dataset samples into fixed-shape batches, in one thread (the
    prefetching version is ``data.loader.PrefetchLoader``)."""
    order = np.arange(len(dataset))
    rng = np.random.RandomState(seed)
    if shuffle:
        rng.shuffle(order)
    batch = []
    for idx in order:
        batch.append(dataset[int(idx)])
        if len(batch) == batch_size:
            yield {k: np.stack([s[k] for s in batch]) for k in batch[0]}
            batch = []
    if batch and not drop_last:
        yield {k: np.stack([s[k] for s in batch]) for k in batch[0]}
