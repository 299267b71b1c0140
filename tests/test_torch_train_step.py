"""cotr_tpu_torch.training.train_step against cotr_tpu's on the CPU: three
steps on one batch, for both freeze settings and across the batch layouts;
the evaluation step; the layout that is not ported.

The JAX steps run once in a module-scoped fixture (two compilations of the
ResNet's backward). Tolerances, float32: losses 1e-4 relative, parameters
after three steps 1e-5 absolute (Adam's first steps move every trained
weight by about the rate, 1e-4 or 1e-5, so a wrong sign, a missed step or a
frozen weight that moved shows). Adam divides each gradient element by its
own magnitude, so an element whose gradient is of the size of its rounding
noise steps by the rate in a direction the noise decides, in either package:
up to 0.1% of a tensor's elements may therefore differ by more than 1e-5,
none by more than the three steps themselves. The key projections' biases
are left out altogether: a softmax does not see a constant added to all its
logits, so their whole gradient is such noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cotr_tpu import TrainConfig as JaxTrainConfig
from cotr_tpu.models.checkpoint_io import _flatten
from cotr_tpu.training import train_step as jax_ts
from cotr_tpu_torch.config import TrainConfig
from cotr_tpu_torch.models.checkpoint_io import params_to_flax
from cotr_tpu_torch.training import train_step as port_ts

from tests.test_torch_common import (few_torch_threads,  # noqa: F401
                                     small_models, smooth_image)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
NOISE_SHARE = 1e-3
CANVAS_ATOL = 1e-4
STEPS = 3


def _batches():
    rng = np.random.RandomState(31)
    crops = np.stack([smooth_image(rng, (256, 256)) for _ in range(2)])
    h_mat = np.stack([np.array([[1.05, 0.04, 6.0], [-0.03, 0.97, -4.0],
                                [1e-4, 0.0, 1.0]]),
                      np.array([[0.95, -0.05, -5.0], [0.06, 1.02, 3.0],
                                [0.0, -1e-4, 1.0]])]).astype(np.float32)
    photo = np.concatenate([rng.uniform(0.8, 1.2, (2, 2, 3)),
                            rng.uniform(-0.05, 0.05, (2, 2, 1))],
                           axis=-1).astype(np.float32)
    sup = dict(queries=rng.uniform(0.05, 0.45, (2, 4, 2)).astype(np.float32),
               targets=rng.uniform(0.55, 0.95, (2, 4, 2)).astype(np.float32))
    canvas_u8 = np.concatenate([crops, crops[::-1]], axis=2)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return {
        "crop_h_mat_photo": dict(crop=crops, h_mat=h_mat, photo=photo, **sup),
        "crop_h_mat": dict(crop=crops, h_mat=h_mat, **sup),
        "image_uint8": dict(image=canvas_u8, **sup),
        "image_float": dict(
            image=((canvas_u8 / np.float32(255.0)) - mean) / std, **sup),
    }


#: name -> (lr_backbone, batch layout): both freeze settings and, between
#: them, both families of layout go through the three steps
RUNS = {"frozen_backbone": (0.0, "crop_h_mat_photo"),
        "lr_backbone_1e-5": (1e-5, "image_uint8")}


@pytest.fixture(scope="module")
def both():
    jmodel, variables, _ = small_models()
    batches = _batches()
    want = {}
    for name, (lr_backbone, layout) in RUNS.items():
        cfg = JaxTrainConfig(lr_backbone=lr_backbone)
        tx = jax_ts.build_optimizer(cfg, variables["params"])
        state = jax_ts.TrainState(jnp.zeros((), jnp.int32),
                                  jax.tree_util.tree_map(jnp.array, variables),
                                  tx.init(variables["params"]))
        step = jax_ts.make_train_step(jmodel, tx, cfg)
        batch = {k: jnp.asarray(v) for k, v in batches[layout].items()}
        losses = []
        for i in range(STEPS):
            state, metrics = step(state, batch, jax.random.PRNGKey(i))
            losses.append({k: float(metrics[k])
                           for k in ("loss", "corr_loss", "cycle_loss")})
        want[name] = dict(losses=losses, step=int(state.step),
                          params=_flatten(jax.device_get(state.params)))
    eval_step = jax_ts.make_eval_step(jmodel, JaxTrainConfig())
    out = eval_step(variables, {k: jnp.asarray(v) for k, v in
                                batches["crop_h_mat"].items()})
    want["eval"] = dict(val_loss=float(out["val_loss"]),
                        pred=np.asarray(out["pred"]))
    return dict(batches=batches, want=want,
                start=_flatten(jax.device_get(variables)))


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("run", list(RUNS))
def test_three_train_steps_match_make_train_step(both, run):
    lr_backbone, layout = RUNS[run]
    _, _, tmodel = small_models()
    cfg = TrainConfig(lr_backbone=lr_backbone)
    state = port_ts.create_train_state(tmodel, cfg, device="cpu")
    train_step = port_ts.make_train_step(cfg)
    batch = _tensors(both["batches"][layout])
    want = both["want"][run]
    for i in range(STEPS):
        state, metrics = train_step(state, batch,
                                    torch.Generator().manual_seed(i))
        for name, value in want["losses"][i].items():
            np.testing.assert_allclose(float(metrics[name]), value,
                                       rtol=LOSS_RTOL, atol=1e-12,
                                       err_msg=f"step {i} {name}")
        assert not metrics["pred"].requires_grad
        assert metrics["pred"].shape == metrics["target"].shape == (2, 4, 2)
    assert state.step == want["step"] == STEPS
    assert int(state.optimizer.count) == STEPS

    got = params_to_flax(tmodel.state_dict())
    assert set(got) == set(want["params"])
    moved = frozen = 0
    for key, w in want["params"].items():
        if key.endswith("k_proj/bias"):
            continue
        diff = np.abs(got[key] - w)
        assert np.mean(diff > PARAM_ATOL) <= NOISE_SHARE, key
        assert diff.max() <= 2 * STEPS * max(cfg.learning_rate,
                                             cfg.lr_backbone), key
        if np.array_equal(w, both["start"][key]):
            frozen += 1
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            moved += 1
    # the freeze policy shows on the weights: 161 backbone tensors to
    # layer3 never move when lr_backbone is 0, layer2/3 convs do otherwise
    assert moved > 40 and frozen > 100
    key = "params/backbone/body/layer3_block0/conv1/kernel"
    assert np.array_equal(want["params"][key], both["start"][key]) \
        == (lr_backbone == 0.0)
    key = "params/transformer/enc0/ffn/linear1/kernel"
    step_size = np.abs(got[key] - both["start"][key]).max()
    assert 1e-4 < step_size < 4e-4  # three steps of about the rate


@pytest.mark.parametrize("layout", ["crop_h_mat_photo", "crop_h_mat",
                                    "image_uint8", "image_float"])
def test_batch_views_match_jax(both, layout):
    batch = both["batches"][layout]
    want = jax_ts.batch_views({k: jnp.asarray(v) for k, v in batch.items()},
                              JaxTrainConfig())
    got = port_ts.batch_views(_tensors(batch), TrainConfig())
    assert got[3] is None and want[3] is None
    assert got[0].dtype == torch.float32 and got[0].shape == (2, 256, 512, 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=CANVAS_ATOL, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), batch["queries"])
    np.testing.assert_array_equal(got[2].numpy(), batch["targets"])


def test_uint8_and_float_image_layouts_give_the_same_step(both):
    losses = {}
    for layout in ("image_uint8", "image_float"):
        _, _, tmodel = small_models()
        cfg = TrainConfig()
        state = port_ts.create_train_state(tmodel, cfg, device="cpu")
        _, metrics = port_ts.make_train_step(cfg)(
            state, _tensors(both["batches"][layout]), None)
        losses[layout] = float(metrics["loss"])
    np.testing.assert_allclose(losses["image_uint8"], losses["image_float"],
                               rtol=1e-5)


def test_eval_step_matches_jax(both, monkeypatch):
    _, _, tmodel = small_models()
    batch = _tensors(both["batches"]["crop_h_mat"])
    eval_step = port_ts.make_eval_step(TrainConfig())
    tmodel.train()
    out = eval_step(tmodel, batch)
    assert not tmodel.training and not out["pred"].requires_grad
    want = both["want"]["eval"]
    np.testing.assert_allclose(float(out["val_loss"]), want["val_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["pred"].numpy(), want["pred"], atol=1e-4,
                               rtol=0)

    # with weights, as a layout with per-query validity hands them over
    weights = np.array([[1, 0, 1, 1], [0, 0, 0.5, 1]], np.float32)
    views = port_ts.batch_views

    def weighted(b, cfg):
        return views(b, cfg)[:3] + (torch.from_numpy(weights),)

    monkeypatch.setattr(port_ts, "batch_views", weighted)
    out_w = eval_step(tmodel, batch)
    err_sq = (want["pred"] - both["batches"]["crop_h_mat"]["targets"]) ** 2
    want_w = (err_sq * weights[..., None]).sum() / (weights.sum() * 2)
    np.testing.assert_allclose(float(out_w["val_loss"]), want_w,
                               rtol=LOSS_RTOL)
    assert abs(float(out_w["val_loss"]) - float(out["val_loss"])) > 1e-6


def test_same_generator_state_gives_the_same_step_with_dropout(both):
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.models.cotr import build_model
    from tests.test_torch_common import SMALL

    _, _, tmodel = small_models()
    batch = _tensors(both["batches"]["image_uint8"])
    cfg = TrainConfig()
    losses = []
    for seed in (0, 0, 1):
        model = build_model(COTRConfig(**dict(SMALL, dropout=0.1)))
        model.load_state_dict(tmodel.state_dict())
        state = port_ts.create_train_state(model, cfg, device="cpu")
        _, metrics = port_ts.make_train_step(cfg)(
            state, batch, torch.Generator().manual_seed(seed))
        assert model.training
        losses.append(float(metrics["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_cand_layout_is_not_ported_and_says_so(both):
    """The candidate layout was once refused here; it is ported now
    (data.device_synth, held against the JAX package in
    tests/test_torch_device_synth.py): its supervision comes out with
    weights, and a batch without its camera fields says what is missing."""
    image = _tensors(both["batches"]["image_uint8"])["image"]
    cand = torch.zeros(2, 8, 3)
    cand[:, :, :2] = 100.0
    cand[:, :, 2] = 2.0
    batch = dict(image=image, cand=cand,
                 qdepth=torch.zeros(2, 256, 256, dtype=torch.int32),
                 qscale=torch.ones(2), kinv_nn=torch.eye(3).expand(2, 3, 3),
                 c2w_nn=torch.eye(4)[:3].expand(2, 3, 4),
                 proj_q=torch.eye(4)[:3].expand(2, 3, 4),
                 flip=torch.zeros(2))
    canvas, queries, targets, weights = port_ts.batch_views(
        batch, TrainConfig(num_kp=4), generator=torch.Generator())
    assert canvas.shape == (2, 256, 512, 3) and canvas.dtype == torch.float32
    assert queries.shape == targets.shape == (2, 8, 2)
    # z_proj = 2 lands on a dequantized depth of 0: every pick is invalid
    assert weights.shape == (2, 8) and not weights.any()
    with pytest.raises(KeyError, match="kinv_nn"):
        port_ts.batch_views({k: v for k, v in batch.items()
                             if k != "kinv_nn"}, TrainConfig(num_kp=4))


def test_create_train_state_draws_fresh_weights_from_the_generator():
    _, _, tmodel = small_models()
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    states = []
    for seed in (3, 3, 4):
        state = port_ts.create_train_state(
            tmodel, TrainConfig(), torch.Generator().manual_seed(seed),
            device="cpu")
        assert state.step == 0
        states.append({k: v.clone() for k, v in tmodel.state_dict().items()})
    key = "transformer.enc0.self_attn.q_proj.weight"
    assert not torch.equal(states[0][key], before[key])
    assert all(torch.equal(states[0][k], states[1][k]) for k in before)
    assert not torch.equal(states[0][key], states[2][key])
    bound = (6.0 / (64 + 64)) ** 0.5  # xavier-uniform
    assert float(states[0][key].abs().max()) <= bound
    assert float(states[0][key].abs().max()) > 0.9 * bound
    assert torch.equal(states[0]["backbone.body.bn1.running_var"],
                       torch.ones(64))
