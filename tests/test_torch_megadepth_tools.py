"""train_cotr.py and eval_megadepth.py against their twins in the port
(cotr_tpu_torch/tools/{train_cotr,eval_megadepth}.py) on a generated COLMAP
scene.

* Training: each script run whole for 2 float32 steps, 1+1 layers at full
  width, dropout 0, from the same ``.npz`` weights, on the same scene and
  dataset seeds. The loaders run one worker each: the dataset's random
  streams are shared by whatever builds batches, so with several workers
  the samples depend on the threads' timing (in both packages). The JAX
  script draws a sample batch for its Trainer's ``initialize`` before
  training, which advances the dataset's streams; the port's Trainer needs
  none, so here the JAX script draws it from a copy of the dataset.
  Tolerances: step losses 1e-4 relative at step 1, 1e-3 at step 2 (Adam's
  first step moves every weight by about the rate whatever its gradient's
  rounding), the validation loss at step 2 1e-3.
* Evaluation: the twin's ``prepare_pair`` gives the JAX script's images and
  query grid, and as ground truth the flow the JAX package's
  ``optical_flow_from_a_to_b`` gives from the query to the neighbour (the
  JAX script reads it the other way round, which the last test shows
  against the depth reprojection); ``evaluate_batch`` of both scripts on the
  same prepared pairs, on the identity stub through
  ``FasterSparseEngine``'s multi-pair call (the twin's default; EPE equal,
  the stub's arithmetic is exact) and on a small real model with shared
  weights through ``SparseEngine`` (``--faster_infer no``; median EPE
  within 1e-3 px)."""

import copy
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from cotr_tpu_torch.tools import eval_megadepth as eval_twin
from cotr_tpu_torch.tools import train_cotr as train_twin
from cotr_tpu_torch.tools.generated_scene import make_scene

from tests.test_torch_common import few_torch_threads  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(dataset config path, its dict): 10 views of 96 x 128, 2 of them the
    validation split (.png images and .h5 depths, which both packages
    read)."""
    root = tmp_path_factory.mktemp("md_tools")
    path = make_scene(str(root), views=10, height=96, width=128, val_views=2,
                      seed=5, image_format="png", depth_format="h5")
    with open(path) as f:
        return path, json.load(f)


def _argv(config, out_dir, weights):
    return ["--dataset_config", config, "--confirm", "no",
            "--enc_layers", "1", "--dec_layers", "1", "--dropout", "0",
            "--batch_size", "2", "--num_kp", "12", "--pool_size", "5",
            "--max_iter", str(STEPS), "--valid_iter", str(STEPS),
            "--load_weights_path", weights, "--out_dir", out_dir]


def _spy(monkeypatch, trainer_cls, record):
    """Record every step's loss and every validation's, and force one
    loader worker."""
    init = trainer_cls.initialize
    validate = trainer_cls.validate

    def initialize(self, *args, **kw):
        init(self, *args, **kw)
        step = self._train_step

        def recorded(*a):
            state, metrics = step(*a)
            record["loss"].append(float(metrics["loss"]))
            return state, metrics

        self._train_step = recorded

    def recorded_validate(self):
        val = validate(self)
        record["val"].append(val)
        return val

    monkeypatch.setattr(trainer_cls, "initialize", initialize)
    monkeypatch.setattr(trainer_cls, "validate", recorded_validate)


def _one_worker(monkeypatch, loader_mod):
    base = loader_mod.PrefetchLoader

    class OneWorker(base):
        def __init__(self, dataset, batch_size, **kw):
            kw["num_workers"] = 1
            super().__init__(dataset, batch_size, **kw)

    monkeypatch.setattr(loader_mod, "PrefetchLoader", OneWorker)


@pytest.fixture(scope="module")
def both_runs(scene, tmp_path_factory):
    from cotr_tpu import data as jax_data
    from cotr_tpu.data import loader as jax_loader
    from cotr_tpu.training import trainer as jax_trainer
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.data import loader as port_loader
    from cotr_tpu_torch.models.checkpoint_io import save_params_npz
    from cotr_tpu_torch.models.cotr import build_model, init_weights
    from cotr_tpu_torch.training import trainer as port_trainer

    tmp = tmp_path_factory.mktemp("md_runs")
    config, _ = scene
    model = build_model(COTRConfig(enc_layers=1, dec_layers=1))
    init_weights(model, torch.Generator().manual_seed(9))
    weights = str(tmp / "init.npz")
    save_params_npz(model, weights)

    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as mp:
            out["port"] = {"loss": [], "val": []}
            _spy(mp, port_trainer.Trainer, out["port"])
            _one_worker(mp, port_loader)
            trainer = train_twin.main(_argv(config, str(tmp / "port"),
                                            weights), device="cpu")
            out["port_step"] = trainer.state.step
    finally:
        torch.set_num_threads(threads)

    sys.path.insert(0, _ROOT)
    import train_cotr

    with pytest.MonkeyPatch.context() as mp:
        out["jax"] = {"loss": [], "val": []}
        _spy(mp, jax_trainer.Trainer, out["jax"])
        _one_worker(mp, jax_loader)
        draw = jax_data.batch_iterator
        mp.setattr(jax_data, "batch_iterator",
                   lambda ds, *a, **kw: draw(copy.deepcopy(ds), *a, **kw))
        train_cotr.main(_argv(config, str(tmp / "jax"), weights))
    return out


def test_train_twin_step_losses_match_train_cotr(both_runs):
    port, jax_run = both_runs["port"], both_runs["jax"]
    assert len(port["loss"]) == len(jax_run["loss"]) == STEPS
    assert both_runs["port_step"] == STEPS
    np.testing.assert_allclose(port["loss"][0], jax_run["loss"][0],
                               rtol=1e-4)
    np.testing.assert_allclose(port["loss"][1], jax_run["loss"][1],
                               rtol=1e-3)


def test_train_twin_validation_loss_matches_train_cotr(both_runs):
    port, jax_run = both_runs["port"], both_runs["jax"]
    assert len(port["val"]) == len(jax_run["val"]) == 1
    assert np.isfinite(port["val"][0])
    np.testing.assert_allclose(port["val"][0], jax_run["val"][0], rtol=1e-3)


def test_train_twin_refuses_a_drifted_run_and_checks_device_synth(
        scene, tmp_path):
    """A params.json of other options refuses the run (exit 1) unless
    --resume; --device_synth with the zoom dataset raises."""
    from cotr_tpu_torch.config import COTRConfig, TrainConfig, compact_name
    from cotr_tpu_torch.config import save_params_json

    config, _ = scene
    argv = _argv(config, str(tmp_path), "none")
    args = train_twin.build_parser().parse_args(argv)
    model_cfg, train_cfg = train_twin.configs(args)
    run_dir = tmp_path / compact_name(model_cfg, train_cfg)
    run_dir.mkdir()
    save_params_json(str(run_dir / "params.json"),
                     COTRConfig(enc_layers=3), TrainConfig())
    with pytest.raises(SystemExit):
        train_twin.run_dir_of(args)
    args.resume = True
    assert train_twin.run_dir_of(args) == str(run_dir)
    bad = train_twin.build_parser().parse_args(
        argv + ["--device_synth", "yes", "--enable_zoom", "yes"])
    with pytest.raises(ValueError, match="device_synth"):
        train_twin.build_datasets(bad)


# ------------------------------------------------------------ evaluation

def _val_pairs(scene, n=2):
    """The first ``n`` validation (query, neighbour) pairs in both
    packages, on full frames."""
    from cotr_tpu.data import megadepth as jmd
    from cotr_tpu_torch.data import megadepth as tmd

    config, _ = scene
    port_cfg = dataclasses.replace(eval_twin.data_config(config),
                                   pool_size=5)
    jmd._SceneCache.scenes.clear()
    jmd._SceneCache.knn.clear()
    port = tmd.MegadepthDataset(port_cfg, "val")
    ref = jmd.MegadepthDataset(jmd.DataConfig(**dataclasses.asdict(
        port_cfg)), "val")
    return [(port.get_query_with_knn(i), ref.get_query_with_knn(i))
            for i in range(n)]


def _grid_flow(flow, queries):
    return flow[queries[:, 1].astype(int), queries[:, 0].astype(int)]


def test_eval_twin_pairs_and_epe_match_on_the_identity_stub(scene):
    sys.path.insert(0, _ROOT)
    import eval_megadepth as jax_eval
    from cotr_tpu.geometry.projector import optical_flow_from_a_to_b
    from cotr_tpu.inference.engine import FasterSparseEngine as JaxEngine
    from cotr_tpu_torch.inference.engine import FasterSparseEngine

    from tests.test_torch_common import JaxIdentityRunner, TorchIdentityRunner

    prepped = []
    for (qp, np_), (qj, nj) in _val_pairs(scene):
        p = eval_twin.prepare_pair(qp, np_[0], grid=6)
        j = jax_eval.prepare_pair(qj, nj[0], grid=6)
        assert p is not None and j is not None
        for a, b in zip(p[:3], j[:3]):  # images and the query grid
            np.testing.assert_array_equal(a, b)
        gt = _grid_flow(optical_flow_from_a_to_b(qj, nj[0]), j[2])
        np.testing.assert_array_equal(p[3], gt)
        np.testing.assert_array_equal(p[4], np.abs(gt).sum(axis=1) > 0)
        prepped.append(p)
    zooms = [0.5, 0.25]
    got = eval_twin.evaluate_batch(
        FasterSparseEngine(TorchIdentityRunner(), mode="stretching"),
        prepped, zooms)
    want = jax_eval.evaluate_batch(
        JaxEngine(JaxIdentityRunner(), mode="stretching", task_bucket=8),
        prepped, zooms)
    for g, w in zip(got, want):
        assert len(g) > 0 and np.isfinite(g).all()
        np.testing.assert_array_equal(g, w)
    summary = eval_twin.summarize(got, 1.0)
    assert summary["pairs"] == 2 and summary["queries"] == sum(map(len, got))


def test_eval_twin_ground_truth_is_the_depth_reprojection(scene):
    """The twin's ground truth against the query-to-neighbour
    correspondences of the depth reprojection (``compute_corrs``): within
    half a pixel (the flow is splatted to whole pixels). The JAX script's
    is the neighbour-to-query flow read at the query's pixels: off by about
    twice the displacement between the views."""
    sys.path.insert(0, _ROOT)
    import eval_megadepth as jax_eval
    from cotr_tpu_torch.data.dataset import compute_corrs

    (qp, np_), (qj, nj) = _val_pairs(scene, 1)[0]
    p = eval_twin.prepare_pair(qp, np_[0], grid=16)
    j = jax_eval.prepare_pair(qj, nj[0], grid=16)
    rows = compute_corrs(qp, np_[0])
    truth = {(int(r[0]), int(r[1])): r[2:] for r in rows}
    keep = [i for i, q in enumerate(p[2])
            if p[4][i] and j[4][i] and (int(q[0]), int(q[1])) in truth]
    want = np.array([truth[(int(q[0]), int(q[1]))] for q in p[2][keep]])
    shift = np.median(np.linalg.norm(want - p[2][keep], axis=1))
    twin = np.median(np.linalg.norm(p[3][keep] - want, axis=1))
    jax_off = np.median(np.linalg.norm(j[3][keep] - want, axis=1))
    assert len(keep) >= 10 and shift > 5
    assert twin <= 0.5, twin
    assert jax_off > shift, (jax_off, shift)


def test_eval_twin_median_epe_matches_on_a_small_model(
        scene, few_torch_threads):  # noqa: F811
    """A 2+2-layer model (hidden 64) with the same weights in both packages
    through ``SparseEngine`` (serial calls), one pair: median EPE within
    1e-3 px of the JAX script's."""
    sys.path.insert(0, _ROOT)
    import eval_megadepth as jax_eval
    from cotr_tpu.inference import ModelRunner as JaxRunner
    from cotr_tpu.inference.engine import SparseEngine as JaxEngine
    from cotr_tpu_torch.inference.engine import SparseEngine
    from cotr_tpu_torch.inference.runner import ModelRunner

    from tests.test_torch_common import small_models

    jmodel, variables, tmodel = small_models()
    prepped = [eval_twin.prepare_pair(q, n[0], 4)
               for (q, n), _ in _val_pairs(scene, 1)]
    zooms = [0.0625]
    got = eval_twin.evaluate_batch(
        SparseEngine(ModelRunner(tmodel, device="cpu"), mode="stretching",
                     batch_size=64), prepped, zooms)
    want = jax_eval.evaluate_batch(
        JaxEngine(JaxRunner(jmodel, variables), mode="stretching",
                  batch_size=64), prepped, zooms)
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0 and np.isfinite(g).all()
        assert abs(np.median(g) - np.median(w)) <= 1e-3
