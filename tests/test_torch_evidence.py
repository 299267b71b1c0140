"""Evidence behind two gates of chip_smoke.py, at full width on the CPU
(slow: minutes each; run with ``-m slow``).

* The squad engine: both packages' ``FasterSparseEngine`` on one generated
  480 x 640 pair with the flagship's weights and the same seeds answer the
  same queries within chip_smoke's dispatch gate (SAME_WITHIN_1PX of them
  within 1 px, median at most SAME_MEDIAN_PX), so the squad engine's
  accuracy cost on the card is the algorithm's, not the port's.
* The training gradient: the port's ``cotr_loss`` backward in float32
  against the same model in float64 (batch 2, dropout 0, targets displaced
  as in ``[train-parity]``) differs within chip_smoke's gradient gates, so
  float32 rounding alone is as large on the CPU as between the card and
  the CPU.

Each prints its numbers; PERF.md records them.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import chip_smoke

from tests.test_torch_common import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.slow

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(_ROOT, "checkpoints", "flagship.npz")
ZOOMS = [float(z) for z in np.linspace(0.5, 0.0625, 4)]


def _pair_and_queries():
    """chip_smoke's 480 x 640 generated pair (image B a known homography of
    image A) and 32 queries in 8 tight clusters of 4: at most 8 squads a
    level, so every dispatch is one small group (8 canvases) in both
    packages."""
    rng = np.random.RandomState(21)
    img_a, img_b, hmat = chip_smoke.make_pair(rng, (480, 640), 3.0, 1.02,
                                              (10, -6))
    centers = np.stack([rng.uniform(120, 520, 8), rng.uniform(100, 380, 8)],
                       axis=1)
    queries = (centers[:, None, :]
               + rng.uniform(-3, 3, (8, 4, 2))).reshape(-1, 2)
    return img_a, img_b, hmat, queries


def test_squad_engines_of_both_packages_agree_at_full_width():
    from cotr_tpu import COTRConfig as JaxConfig
    from cotr_tpu import build_model as jax_build_model
    from cotr_tpu.inference import ModelRunner as JaxRunner
    from cotr_tpu.inference.engine import FasterSparseEngine as JaxEngine
    from cotr_tpu.models.checkpoint_io import load_params as jax_load_params
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.inference.engine import FasterSparseEngine
    from cotr_tpu_torch.inference.runner import ModelRunner
    from cotr_tpu_torch.models.checkpoint_io import load_model

    img_a, img_b, hmat, queries = _pair_and_queries()
    kw = dict(zoom_ins=ZOOMS, queries_a=queries, force=True,
              max_corrs=len(queries))
    jax_cfg = JaxConfig()
    jax_engine = JaxEngine(JaxRunner(jax_build_model(jax_cfg),
                                     jax_load_params(FLAGSHIP, jax_cfg)),
                           mode="tile", max_load=256, seed=0)
    want = np.asarray(jax_engine.cotr_corr_multiscale(img_a, img_b, **kw))
    port_engine = FasterSparseEngine(
        ModelRunner(load_model(FLAGSHIP, COTRConfig(), device="cpu"),
                    device="cpu"), mode="tile", max_load=256, seed=0)
    got = port_engine.cotr_corr_multiscale(img_a, img_b, **kw)

    assert got.shape == want.shape == (len(queries), 4)
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-9)
    diff = np.linalg.norm(got[:, 2:] - want[:, 2:], axis=1)
    truth = chip_smoke.apply_h(hmat, queries)
    err = {name: np.linalg.norm(c[:, 2:] - truth, axis=1)
           for name, c in (("port", got), ("jax", want))}
    print(f"\n[squad evidence] {len(queries)} queries, 480x640, flagship "
          f"float32 on the CPU: port vs JAX median {np.median(diff):.2e} px, "
          f"95th percentile {np.percentile(diff, 95):.2e} px, max "
          f"{diff.max():.2e} px, {np.mean(diff <= 1.0):.1%} within 1 px; "
          f"median error vs the known homography: port "
          f"{np.median(err['port']):.3f} px, JAX {np.median(err['jax']):.3f}"
          f" px")
    assert np.mean(diff <= 1.0) >= chip_smoke.SAME_WITHIN_1PX
    assert np.median(diff) <= chip_smoke.SAME_MEDIAN_PX


def _float64_patches(monkeypatch):
    """The three places where the model computes in float32 whatever its
    dtype (the head, layer norm, the softmax) compute in the input's dtype
    instead, so a float64 model is float64 throughout but for its input
    embeddings."""
    import torch.nn.functional as F

    from cotr_tpu_torch.models import cotr, layers, transformer
    from cotr_tpu_torch.ops.attention import _check

    def head(self, x):
        return self.fc2(F.relu(self.fc1(F.relu(self.fc0(x)))))

    def layer_norm(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)

    def attention(q, k, v, key_padding_mask=None, dropout_p=0.0,
                  training=False, generator=None):
        _check(q, k, v)
        assert key_padding_mask is None and dropout_p == 0.0
        logits = torch.einsum("bqhd,bkhd->bhqk",
                              q / math.sqrt(q.shape[-1]), k)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)

    monkeypatch.setattr(cotr.CorrHead, "forward", head)
    monkeypatch.setattr(layers.LayerNorm, "forward", layer_norm)
    monkeypatch.setattr(transformer, "einsum_attention", attention)


def _loss_and_grads(dtype, monkeypatch):
    from cotr_tpu_torch.config import COTRConfig, TrainConfig
    from cotr_tpu_torch.models.checkpoint_io import load_model
    from cotr_tpu_torch.training import loss as loss_mod
    from cotr_tpu_torch.training import train_step

    batch = chip_smoke.make_train_batch(np.random.RandomState(8), 2, 50)
    batch["targets"] = batch["targets"] + np.float32(
        chip_smoke.TRAIN_PARITY_SHIFT)
    cfg = dataclasses.replace(COTRConfig(), dropout=0.0)
    model = load_model(FLAGSHIP, cfg, device="cpu").train()
    with monkeypatch.context() as patch:
        if dtype == torch.float64:
            _float64_patches(patch)
            model = model.double()
            model.dtype = torch.float64
        views = train_step.batch_views(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            TrainConfig())
        loss, _ = loss_mod.cotr_loss(model, *views[:3])
        loss.backward()
    return float(loss.detach()), {k: p.grad.double().numpy()
                                  for k, p in model.named_parameters()}


def test_float32_gradient_against_float64_at_full_width(monkeypatch,
                                                        few_torch_threads):
    loss32, g32 = _loss_and_grads(torch.float32, monkeypatch)
    loss64, g64 = _loss_and_grads(torch.float64, monkeypatch)

    def norm(arrays):
        return float(np.sqrt(sum(np.square(a).sum() for a in arrays)))

    whole = norm(g64.values())
    grad_err = norm(g32[k] - g for k, g in g64.items()) / whole
    worst, worst_key = 0.0, ""
    for key, g in g64.items():
        err = norm([g32[key] - g]) / max(
            norm([g]), chip_smoke.TRAIN_TENSOR_FLOOR * whole)
        if err > worst:
            worst, worst_key = err, key
    loss_err = abs(loss32 - loss64) / abs(loss64)
    print(f"\n[gradient evidence] full width, batch 2, 100 queries, CPU "
          f"float32 vs float64: loss rel err {loss_err:.2e}; whole gradient "
          f"relative L2 {grad_err:.2e}; worst tensor {worst:.2e} of its "
          f"norm at {worst_key}")
    assert loss_err <= chip_smoke.TRAIN_LOSS_RTOL
    assert grad_err <= chip_smoke.TRAIN_GRAD_RTOL
    assert worst <= chip_smoke.TRAIN_TENSOR_RTOL
