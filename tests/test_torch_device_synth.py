"""Supervision synthesized on the device (cotr_tpu_torch/data/device_synth.py)
against the JAX package's, and a train step on the candidate layout
against the JAX step.

The JAX package draws each sample's selection scores from a threefry key
(``jax.random.uniform(PRNGKey(skey))``), which torch cannot draw: the
parity tests draw them so and hand the same scores to the port. The port's
own generator is held to the distribution only.

Tolerances, float32: canvases and validity weights equal, the selected
rows in the same order; correspondences within 1e-5 px (on the CPU the two
packages' float32 products came out bit for bit equal on 36 samples of 600
candidates); the train step's losses 1e-4 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cotr_tpu import COTRConfig as JaxConfig
from cotr_tpu import TrainConfig as JaxTrainConfig
from cotr_tpu import build_model as jax_build_model
from cotr_tpu.data import device_synth as jsynth
from cotr_tpu.models.checkpoint_io import _flatten
from cotr_tpu.training import train_step as jax_ts
from cotr_tpu_torch.config import COTRConfig, TrainConfig
from cotr_tpu_torch.data import dataset as tds
from cotr_tpu_torch.data import device_synth
from cotr_tpu_torch.models.checkpoint_io import load_state
from cotr_tpu_torch.models.cotr import build_model
from cotr_tpu_torch.training import train_step as port_ts
from cotr_tpu_torch.training.trainer import upload
from cotr_tpu_torch.utils.constants import MAX_SIZE

from tests.test_torch_common import few_torch_threads  # noqa: F401
from tests.test_torch_megadepth import generated  # noqa: F401 (fixture)

NUM_KP = 24
PX_ATOL = 1e-5
LOSS_RTOL = 1e-4
#: normalized canvas coordinates -> pixels
TO_PX = np.array([2 * MAX_SIZE, MAX_SIZE])


@pytest.fixture(scope="module")
def batch(generated):  # noqa: F811
    """Four samples of the candidate layout, stacked (numpy)."""
    ds = tds.CotrDataset(generated, "train", seed=2, device_synth=True)
    samples = [ds[i] for i in (0, 3, 7, 10)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _jax_scores(skey: np.ndarray, c: int) -> np.ndarray:
    """The scores ``_synth_one`` draws: one threefry stream per sample."""
    return np.array(jax.vmap(lambda k: jax.random.uniform(
        jax.random.PRNGKey(k), (c,)))(jnp.asarray(skey, jnp.uint32)))


def _port_batch(batch) -> dict:
    return {k: upload(v, "cpu") for k, v in batch.items()}


def test_quantize_and_dequantize_as_the_jax_package():
    rng = np.random.RandomState(0)
    depth = rng.uniform(0, 800.0, (32, 32)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.3] = 0.0
    q, scale = device_synth.quantize_depth(depth)
    jq, jscale = jsynth.quantize_depth(depth)
    np.testing.assert_array_equal(q, jq)
    assert scale == jscale and q.dtype == np.uint16
    back = device_synth.dequantize_depth(upload(q, "cpu"),
                                         torch.tensor(scale)).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jsynth.dequantize_depth_jnp(jnp.asarray(jq),
                                                     jnp.asarray(jscale))),
        rtol=1e-6)
    assert np.abs(back - depth).max() < 0.05


def test_upload_widens_the_unsigned_fields(batch):
    b = _port_batch(batch)
    assert b["qdepth"].dtype == torch.int32 and b["skey"].dtype == torch.int64
    np.testing.assert_array_equal(b["qdepth"].numpy(), batch["qdepth"])
    np.testing.assert_array_equal(b["skey"].numpy(), batch["skey"])
    assert b["image"].dtype == torch.uint8


@pytest.mark.parametrize("bidirectional", [True, False])
def test_synth_supervision_matches_the_jax_package(batch, bidirectional):
    c = batch["cand"].shape[1]
    scores = _jax_scores(batch["skey"], c)
    want = jsynth.synth_supervision_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, NUM_KP, bidirectional)
    got = device_synth.synth_supervision_batch(
        _port_batch(batch), NUM_KP, bidirectional,
        scores=torch.from_numpy(scores))
    canvas, queries, targets, weights = (t.numpy() for t in got)
    np.testing.assert_array_equal(canvas, np.asarray(want[0]))
    np.testing.assert_array_equal(weights, np.asarray(want[3]))
    for g, w in ((queries, want[1]), (targets, want[2])):
        np.testing.assert_allclose(g * TO_PX, np.asarray(w) * TO_PX,
                                   atol=PX_ATOL, rtol=0)
    q = 2 * NUM_KP if bidirectional else NUM_KP
    assert queries.shape == targets.shape == (4, q, 2)
    # the picks are valid ones first, and most are valid in this scene
    assert (np.diff(weights[:, :NUM_KP], axis=1) <= 0).all()
    assert weights.mean() > 0.5


def test_selected_rows_and_their_order_match_top_k(batch):
    """The candidates picked, in order, before the flip: torch.topk
    (largest=False, sorted) against jax.lax.top_k of the negated score."""
    c = batch["cand"].shape[1]
    scores = _jax_scores(batch["skey"], c)
    corrs, wgt = device_synth.synth_corrs_batch(
        _port_batch(batch), NUM_KP, torch.from_numpy(scores))
    for i in range(4):
        want_c, want_w = jsynth._synth_one(
            *(jnp.asarray(batch[k][i]) for k in ("cand", "kinv_nn",
                                                 "c2w_nn", "proj_q",
                                                 "qdepth", "qscale",
                                                 "skey")), NUM_KP)
        # the neighbour's pixel (columns 2, 3) names the candidate exactly
        np.testing.assert_array_equal(corrs[i, :, 2:].numpy(),
                                      np.asarray(want_c)[:, 2:])
        np.testing.assert_array_equal(wgt[i].numpy(), np.asarray(want_w))
        np.testing.assert_allclose(corrs[i, :, :2].numpy(),
                                   np.asarray(want_c)[:, :2],
                                   atol=PX_ATOL, rtol=0)


def test_generator_scores_pick_valid_candidates_uniformly(batch):
    """The port's own scores (a torch.Generator): reproducible from its
    seed; every pick with weight 1 reprojects as the host's projective math
    says; each valid candidate is picked about num_kp / n_valid of the
    time (within 6 standard deviations over 300 draws)."""
    from cotr_tpu_torch.geometry.projector import pcd_2d_to_pcd_3d

    b = _port_batch(batch)
    runs = [device_synth.synth_supervision_batch(
        b, NUM_KP, generator=torch.Generator().manual_seed(s))
        for s in (1, 1, 2)]
    for x, y in zip(runs[0], runs[1]):
        assert torch.equal(x, y)
    assert not torch.equal(runs[0][1], runs[2][1])

    _, queries, targets, weights = runs[0]
    for i in range(4):
        q_xy = queries[i, :NUM_KP].numpy() * TO_PX
        nn_xy = targets[i, :NUM_KP].numpy() * TO_PX - [MAX_SIZE, 0]
        if batch["flip"][i] > 0.5:
            q_xy[:, 0] = MAX_SIZE - 1 - q_xy[:, 0]
            nn_xy[:, 0] = MAX_SIZE - 1 - nn_xy[:, 0]
        cand = batch["cand"][i]
        for j in np.nonzero(weights[i, :NUM_KP].numpy())[0]:
            row = np.nonzero((np.abs(cand[:, 0] - nn_xy[j, 0]) < 1e-3)
                             & (np.abs(cand[:, 1] - nn_xy[j, 1]) < 1e-3))[0]
            world = pcd_2d_to_pcd_3d(
                nn_xy[j][None], cand[row[:1], 2:3].astype(np.float64),
                np.linalg.inv(batch["kinv_nn"][i].astype(np.float64)),
                motion=np.vstack([batch["c2w_nn"][i], [0, 0, 0, 1]]))
            uvw = batch["proj_q"][i].astype(np.float64) @ np.append(
                world[0], 1.0)
            np.testing.assert_allclose(q_xy[j], uvw[:2] / uvw[2], atol=0.01)

    one = {k: v[:1] for k, v in b.items()}
    draws = 300
    counts = None
    for s in range(draws):
        corrs, wgt = device_synth.synth_corrs_batch(
            one, NUM_KP, torch.rand(1, one["cand"].shape[1],
                                    generator=torch.Generator().manual_seed(
                                        100 + s)))
        hits = np.zeros(one["cand"].shape[1])
        picked = corrs[0, :, 2:].numpy()[wgt[0].numpy() > 0]
        cand = batch["cand"][0, :, :2]
        for p in picked:
            hits[np.nonzero((cand == p).all(axis=1))[0][0]] += 1
        counts = hits if counts is None else counts + hits
    n_valid = int((counts > 0).sum())
    assert n_valid > NUM_KP
    p = NUM_KP / n_valid
    sigma = np.sqrt(draws * p * (1 - p))
    valid_counts = counts[counts > 0]
    assert np.abs(valid_counts - draws * p).max() < 6 * sigma


def test_eval_step_on_the_candidate_layout_is_repeatable(batch):
    torch.manual_seed(0)
    model = build_model(COTRConfig(enc_layers=1, dec_layers=1, dropout=0.0,
                                   hidden_dim=64, nheads=2))
    eval_step = port_ts.make_eval_step(TrainConfig(num_kp=NUM_KP))
    b = {k: v[:2] for k, v in _port_batch(batch).items()}
    a, c = eval_step(model, b), eval_step(model, b)
    assert torch.equal(a["val_loss"], c["val_loss"])
    assert a["pred"].shape == (2, 2 * NUM_KP, 2)


# ------------------------------------------------------- the train step

@pytest.fixture(scope="module")
def jax_step(batch):
    """One JAX train step on the candidate batch: (flat variables before,
    loss metrics). 1+1 layers at full width, dropout 0."""
    cfg = JaxConfig(enc_layers=1, dec_layers=1, dropout=0.0)
    model = jax_build_model(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(4),
                                    jnp.zeros((1, 256, 512, 3)),
                                    jnp.zeros((1, 2, 2)))
    tcfg = JaxTrainConfig(num_kp=NUM_KP)
    tx = jax_ts.build_optimizer(tcfg, variables["params"])
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), variables,
                              tx.init(variables["params"]))
    step = jax_ts.make_train_step(model, tx, tcfg)
    start = _flatten(jax.device_get(variables))  # the step donates them
    _, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    return start, {k: float(metrics[k])
                       for k in ("loss", "corr_loss", "cycle_loss")}


def test_train_step_on_the_candidate_layout_matches_the_jax_step(
        batch, jax_step, few_torch_threads, monkeypatch):  # noqa: F811
    variables, want = jax_step
    model = build_model(COTRConfig(enc_layers=1, dec_layers=1, dropout=0.0))
    load_state(model, variables)
    scores = torch.from_numpy(_jax_scores(batch["skey"],
                                          batch["cand"].shape[1]))
    synth = port_ts.synth_supervision_batch

    def with_jax_scores(b, num_kp, bidirectional, generator=None):
        return synth(b, num_kp, bidirectional, scores=scores)

    monkeypatch.setattr(port_ts, "synth_supervision_batch", with_jax_scores)
    cfg = TrainConfig(num_kp=NUM_KP)
    state = port_ts.create_train_state(model, cfg, device="cpu")
    state, metrics = port_ts.make_train_step(cfg)(
        state, _port_batch(batch), torch.Generator().manual_seed(0))
    for name, value in want.items():
        np.testing.assert_allclose(float(metrics[name]), value,
                                   rtol=LOSS_RTOL, err_msg=name)
    assert metrics["pred"].shape == metrics["target"].shape \
        == (4, 2 * NUM_KP, 2)
    assert state.step == 1
