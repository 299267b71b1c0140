"""The port's parallelism (cotr_tpu_torch/parallel, the mesh branches of the
train step, the optimizer and the Trainer) against the JAX package's layouts
and against the one-process step.

* Layouts: the Megatron parameter layouts and the Adam moments' layouts
  (moments follow their parameter; ZeRO-1 over ``data``) equal the JAX
  package's ``transformer_param_shardings`` / ``opt_state_shardings`` specs
  for every leaf of a 1 + 1 and a 6 + 6 tree, mapped through the converter's
  axis permutation. The JAX trees come from ``jax.eval_shape``: nothing is
  compiled.
* Two gloo ranks (``tests/test_torch_dist_common.py``): data parallelism
  equals the one-process step (loss 1e-6 relative, the trained weights
  after two steps 1e-6 absolute) on rows whose cycle-consistent picks and
  weight sums differ between the ranks; a NaN on one rank is skipped on
  both; a ZeRO-1 ``Trainer`` checkpoint written at world size 2 equals one
  written in one process and resumes there to the same next step. Trained
  weights are compared in float64 (``test_torch_dist_common.build``): in
  float32 Adam turns gradients' rounding noise into steps of about the
  learning rate on either side. The weighted loss, its gradient and the
  NaN skip are float32.

The JAX package's own mesh steps take minutes to compile on the CPU and are
marked slow there, so the one-process port step (held against the JAX step
in ``tests/test_torch_train_step.py``) is the reference here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cotr_tpu import COTRConfig as JaxConfig
from cotr_tpu import TrainConfig as JaxTrainConfig
from cotr_tpu import build_model as jax_build_model
from cotr_tpu.parallel.opt_shard import _names, opt_state_shardings
from cotr_tpu.parallel.tp import make_2d_mesh, transformer_param_shardings
from cotr_tpu.training.train_step import create_train_state
from cotr_tpu_torch.config import COTRConfig, TrainConfig
from cotr_tpu_torch.models.cotr import build_model
from cotr_tpu_torch.parallel import opt_shard, tp
from cotr_tpu_torch.parallel.mesh import (REPLICATED, Layout, Mesh,
                                          make_mesh, shard_batch)
from cotr_tpu_torch.training.optim import param_labels
from cotr_tpu_torch.training.trainer import Trainer

from tests import test_torch_dist_common as dc
from tests.test_torch_common import assert_tree_close, few_torch_threads  # noqa: F401,E501

#: the JAX mesh of the layout tests: 8 virtual devices as (data 4, model 2)
MESH_SHAPE = {"data": 4, "model": 2}
LOSS_RTOL = 1e-6
WEIGHT_ATOL = 1e-6


def _port_name(jax_names) -> str:
    """A JAX parameter path (under ``params``) as the port's state_dict
    key."""
    *mods, leaf = jax_names
    return ".".join(list(mods) + [{"kernel": "weight",
                                   "scale": "weight"}.get(leaf, leaf)])


def _in_jax_order(layout: Layout, name: str, ndim: int) -> tuple:
    spec = layout.spec(ndim)
    out = [None] * ndim
    for dim, axis in enumerate(opt_shard.flax_axes(name, ndim)):
        out[axis] = spec[dim]
    return tuple(out)


def _padded(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module", params=[1, 6], ids=["1+1", "6+6"])
def trees(request):
    """The JAX shapes of a depth's parameters and Adam state (traced, not
    run) for lr_backbone 1e-5 (so layer2/3 convolutions have moments), and
    the port's model at that depth."""
    depth = request.param
    jcfg = JaxConfig(enc_layers=depth, dec_layers=depth)
    tcfg = JaxTrainConfig(lr_backbone=1e-5)
    model = jax_build_model(jcfg)
    sample = {"image": jnp.zeros((1, 256, 512, 3), jnp.float32),
              "queries": jnp.zeros((1, 4, 2), jnp.float32),
              "targets": jnp.zeros((1, 4, 2), jnp.float32)}
    state = jax.eval_shape(lambda: create_train_state(
        model, tcfg, jax.random.PRNGKey(0), sample)[0])
    port = build_model(COTRConfig(enc_layers=depth, dec_layers=depth))
    return state, port


def test_tp_layouts_equal_the_jax_specs(trees):
    state, port = trees
    mesh = make_2d_mesh(8, model_parallel=2)
    want = transformer_param_shardings(state.params["params"], mesh)
    # the JAX parameters hold the FrozenBN statistics the port keeps as
    # buffers: every state_dict entry has its layout
    port_params = port.state_dict()
    got = tp.transformer_param_shardings(port_params)
    leaves = jax.tree_util.tree_leaves_with_path(want)
    split = 0
    for path, sharding in leaves:
        name = _port_name(_names(path))
        p = port_params[name]
        assert _in_jax_order(got[name], name, p.dim()) == \
            _padded(sharding.spec, p.dim()), name
        split += not got[name].replicated
    assert len(leaves) == len(port_params)
    # a layer's split tensors: q, k, v (weight, bias), out_proj.weight,
    # linear1 (weight, bias), linear2.weight
    layers = port.cfg.enc_layers + port.cfg.dec_layers
    assert split == 10 * layers


def test_moment_layouts_equal_the_jax_specs_with_zero1(trees):
    """Every Adam moment leaf: TP moments on ``model``, replicated
    parameters' moments on ``data`` (ZeRO-1) at the dim the JAX package
    picks, scalars replicated."""
    state, port = trees
    mesh = make_2d_mesh(8, model_parallel=2)
    psh = transformer_param_shardings(state.params["params"], mesh)
    want = opt_state_shardings(state.opt_state, state.params["params"], psh,
                               mesh, zero1_axis="data")
    params = dict(port.named_parameters())
    labels = param_labels(params, 1e-5)
    trainable = {k: v for k, v in params.items() if labels[k] != "frozen"}
    got = opt_shard.opt_state_shardings(
        trainable, tp.transformer_param_shardings(port), MESH_SHAPE,
        zero1_axis="data")
    seen = {"mu": set(), "nu": set()}
    kinds = {"model": 0, "data": 0, "replicated": 0}
    for path, sharding in jax.tree_util.tree_leaves_with_path(want):
        names = _names(path)
        kind = next((n for n in names if n in ("mu", "nu")), None)
        if kind is None:  # counters: replicated scalars
            assert tuple(sharding.spec) == (), names
            continue
        name = _port_name(names[names.index(kind) + 1:])
        ndim = params[name].dim()
        assert _in_jax_order(got[name], name, ndim) == \
            _padded(sharding.spec, ndim), (kind, name)
        seen[kind].add(name)
        kinds[got[name].axis or "replicated"] += 1
    assert seen["mu"] == seen["nu"] == set(trainable)
    assert kinds["model"] > 0 and kinds["data"] > 0
    # a 4-D convolution's moments split at the JAX dim (its O or I axis)
    conv = "backbone.body.layer3_block0.conv2.weight"
    assert got[conv].dim in (0, 1)


def test_zero1_dim_follows_the_jax_axis_order():
    # a dense (out, in) weight of JAX shape (in, out) = (256, 1024): the
    # JAX package splits its axis 1 (1024), which is the port's dim 0
    assert opt_shard._zero1_dim("corr_embed.fc0.weight", (1024, 256), 4) == 0
    # a tie on a square kernel goes to the JAX axis 0, the port's dim 1
    assert opt_shard._zero1_dim("input_proj.weight", (256, 256), 4) == 1
    # conv OIHW (256, 64, 3, 3) is HWIO (3, 3, 64, 256): O, the port's 0
    assert opt_shard._zero1_dim("backbone.body.x.conv.weight",
                                (256, 64, 3, 3), 4) == 0
    # nothing divides: replicated
    assert opt_shard._zero1_dim("b", (3,), 4) is None
    assert opt_shard.opt_state_shardings(
        {"b": torch.zeros(3)}, {}, {"data": 4}, "data")["b"] == REPLICATED


def test_local_mesh_shards_and_replicates():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.kind == "local" and mesh.shape == {"data": 4}
    x = torch.arange(8.0).reshape(8, 1)
    parts = shard_batch({"x": x}, mesh)["x"]
    assert [p.flatten().tolist() for p in parts] == \
        [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    with pytest.raises(ValueError):
        shard_batch(torch.zeros(6, 1), mesh)
    from cotr_tpu_torch.parallel.mesh import (batch_sharding, replicate,
                                              replicated)

    copies = replicate(x, mesh)
    assert len(copies) == 4 and all(c is x for c in copies)
    assert batch_sharding(mesh) == Layout(0, "data")
    assert replicated(mesh).replicated and Layout(1, "model").spec(2) == \
        (None, "model")
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"] * 4)


def test_consumers_refuse_the_other_kind_of_mesh():
    from cotr_tpu_torch.inference.grouped import GroupedStepper
    from cotr_tpu_torch.training.train_step import make_train_step

    from tests.test_torch_common import TorchIdentityRunner

    with pytest.raises(TypeError, match="process mesh"):
        make_train_step(TrainConfig(), make_mesh(devices=["cpu", "cpu"]))
    with pytest.raises(TypeError, match="local mesh"):
        GroupedStepper(TorchIdentityRunner(), mesh=Mesh(("data",), (2,)))


def test_trainer_checks_num_devices_against_the_world_size(tmp_path):
    with pytest.raises(ValueError, match="num_devices"):
        Trainer(build_model(COTRConfig(**dc.DEPTH)), COTRConfig(**dc.DEPTH),
                TrainConfig(num_devices=2, out_dir=str(tmp_path)),
                train_loader=list, out_dir=str(tmp_path),
                use_tensorboard=False, device="cpu")


# ------------------------------------------------------------- two ranks

@pytest.fixture(scope="module")
def batch(few_torch_threads):  # noqa: F811
    return dc.cycle_batch(dc.build())


@pytest.fixture(scope="module")
def dp(tmp_path_factory, batch):
    return dc.run_ranks("dp_scenario", 2, tmp_path_factory.mktemp("dp"),
                        batch)


def test_ranks_see_different_cycle_and_weight_counts(dp):
    counts = dp[0]["cycle_counts"]
    assert counts[0] != counts[1] and min(counts) > 0, counts
    assert [r["coordinate"] for r in dp] == [0, 1]
    # shard_batch gives each rank its row; shard_batch_multihost keeps a
    # row a rank's loader made for it
    assert all(r["rows_are_mine"] for r in dp)


def test_weighted_loss_is_globally_normalized(dp):
    """Each rank's share of the weighted loss, its gradients summed over
    the ranks, equals the one-process weighted loss and gradient."""
    ref = dp[0]["ref_weighted"]
    for r in dp:
        for k in ("loss", "corr_loss", "cycle_loss"):
            assert r["weighted"][k] == pytest.approx(ref[k], rel=LOSS_RTOL), k
    assert ref["cycle_loss"] > 0
    grads = {k: v.numpy() for k, v in dp[0]["weighted_grads"].items()}
    want = {k: v.numpy() for k, v in dp[0]["ref_weighted_grads"].items()}
    assert_tree_close(grads, want, 1e-5, "weighted DP gradient")
    for k, v in dp[1]["weighted_grads"].items():
        assert torch.equal(v, dp[0]["weighted_grads"][k]), k


def test_two_rank_data_parallel_steps_equal_the_one_process_steps(dp):
    ref = dp[0]
    for r in dp:
        np.testing.assert_allclose(r["losses"], ref["ref_losses"],
                                   rtol=LOSS_RTOL)
    for k, want in ref["ref_weights"].items():
        for r in dp:
            np.testing.assert_allclose(r["weights"][k].numpy(), want.numpy(),
                                       rtol=0, atol=WEIGHT_ATOL, err_msg=k)
        assert torch.equal(dp[0]["weights"][k], dp[1]["weights"][k]), k


def test_a_nan_on_one_rank_is_skipped_on_every_rank(dp):
    for r in dp:
        assert r["nan"] == {"count": 0, "total_notfinite": 1,
                            "unchanged": True}


@pytest.mark.usefixtures("few_torch_threads")
def test_zero1_checkpoint_at_world_size_2_equals_one_process_and_resumes(
        tmp_path, monkeypatch, batch):
    sharded_dir = str(tmp_path / "sharded")
    ranks = dc.run_ranks("checkpoint_scenario", 2, tmp_path, sharded_dir,
                         batch)
    assert [r["is_main"] for r in ranks] == [True, False]
    zero1 = ranks[0]["zero1"]
    assert any(len(ranks[0]["local_nu"][k]) == 4 for k in zero1), \
        "no convolution's moments split"
    for k, (dim, axis) in zero1.items():
        assert axis == "data"
        assert ranks[0]["local_nu"][k] == ranks[1]["local_nu"][k]
    dc.float64_patches(monkeypatch.setattr)

    def trainer(run_dir, max_iter):
        return dc.make_trainer(COTRConfig, TrainConfig, Trainer, run_dir,
                               batch, max_iter)

    plain_dir = str(tmp_path / "plain")
    plain = trainer(plain_dir, 1)
    plain.initialize(seed=0)
    plain.train()
    path = os.path.join("checkpoints", "checkpoint.pt")
    got = torch.load(os.path.join(sharded_dir, path), weights_only=True)
    want = torch.load(os.path.join(plain_dir, path), weights_only=True)
    assert got["step"] == want["step"] == 1
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=WEIGHT_ATOL, err_msg=k)
    for kind in ("mu", "nu"):
        assert set(got["opt_state"][kind]) == set(want["opt_state"][kind])
        assert_tree_close(
            {k: v.numpy() for k, v in got["opt_state"][kind].items()},
            {k: v.numpy() for k, v in want["opt_state"][kind].items()},
            1e-5, kind)
    assert int(got["opt_state"]["count"]) == 1

    # the world-size-2 checkpoint resumes here, in one process, to the step
    # the one-process run takes next
    resumed = trainer(sharded_dir, 2)
    resumed.initialize(seed=0)
    resumed.train(resume=True)
    unbroken = trainer(plain_dir, 2)
    unbroken.initialize(seed=0)
    unbroken.train(resume=True)
    assert resumed.state.step == unbroken.state.step == 2
    want = dict(unbroken.state.model.named_parameters())
    for k, v in resumed.state.model.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(),
                                   want[k].detach().numpy(), rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=k)
