"""cotr_tpu_torch.training.optim against cotr_tpu.training.optim (optax) on
the CPU: the freeze policy's labels, Adam under both schedules, and the
finite-gradient skip with its 101st step.

Tolerance: parameters after each update within 1e-6 absolute (float32; the
updates are of the size of the rate, 1e-2 here).
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from cotr_tpu import TrainConfig as JaxTrainConfig
from cotr_tpu.models.checkpoint_io import _flatten
from cotr_tpu.training import optim as jax_optim
from cotr_tpu_torch import native
from cotr_tpu_torch.config import TrainConfig
from cotr_tpu_torch.models.checkpoint_io import params_from_flax
from cotr_tpu_torch.training import optim as port_optim

from tests.test_torch_common import small_models

ATOL = 1e-6
CONV = "backbone.body.layer2_block0.conv1.weight"
SCHEDULES = {
    "constant": dict(lr_schedule="constant"),
    # ends inside the ten updates: the clamp at lr_decay_steps acts
    "cosine": dict(lr_schedule="cosine", lr_decay_steps=7,
                   lr_final_frac=0.05),
}


@pytest.mark.parametrize("lr_backbone", [0.0, 1e-5])
def test_param_labels_match_jax_key_by_key(lr_backbone):
    _, variables, tmodel = small_models()
    flat = _flatten(jax.device_get(variables))
    # params_from_flax keeps the order: port name <- flat Flax key
    port_name = dict(zip(flat, params_from_flax(flat)))
    jax_labels = _flatten(jax_optim.param_labels(variables, lr_backbone))
    got = port_optim.param_labels(tmodel.state_dict(), lr_backbone)
    assert len(got) == len(jax_labels) == len(flat)
    for key, label in jax_labels.items():
        assert got[port_name[key]] == str(label), key
    kinds = set(got.values())
    assert kinds == ({"main", "frozen"} if lr_backbone == 0
                     else {"main", "frozen", "backbone"})


@pytest.mark.parametrize("lr_backbone", [0.0, 1e-5])
def test_build_optimizer_freezes_by_the_labels(lr_backbone):
    _, _, tmodel = small_models()
    opt = port_optim.build_optimizer(TrainConfig(lr_backbone=lr_backbone),
                                     tmodel)
    labels = port_optim.param_labels(dict(tmodel.named_parameters()),
                                     lr_backbone)
    for name, p in tmodel.named_parameters():
        assert p.requires_grad == (labels[name] != "frozen"), name
    assert set(opt.params) == {n for n, l in labels.items() if l != "frozen"}
    assert set(opt.groups["backbone"]) == {
        n for n, l in labels.items() if l == "backbone"}


def _toy(cfg_kwargs, seed=0):
    """One ``main`` and one ``backbone`` tensor under both optimizers."""
    rng = np.random.RandomState(seed)
    w = rng.randn(5).astype(np.float32)
    conv = rng.randn(2, 3, 1, 1).astype(np.float32)  # OIHW
    kw = dict(learning_rate=1e-2, lr_backbone=3e-3, **cfg_kwargs)
    jparams = {"transformer": {"w": jnp.asarray(w)},
               "backbone": {"body": {"layer2_block0": {"conv1": {
                   "kernel": jnp.asarray(conv.transpose(2, 3, 1, 0))}}}}}
    tx = jax_optim.build_optimizer(JaxTrainConfig(**kw), jparams)
    named = {"transformer.w": nn.Parameter(torch.from_numpy(w.copy())),
             CONV: nn.Parameter(torch.from_numpy(conv.copy()))}
    opt = port_optim.Optimizer(TrainConfig(**kw), named)
    return jparams, tx, tx.init(jparams), named, opt


def _grads(rng, nan=False):
    gw = rng.randn(5).astype(np.float32)
    gc = rng.randn(2, 3, 1, 1).astype(np.float32)
    if nan:
        gw[2] = np.nan
    return gw, gc


def _jax_update(tx, state, jparams, gw, gc):
    grads = {"transformer": {"w": jnp.asarray(gw)},
             "backbone": {"body": {"layer2_block0": {"conv1": {
                 "kernel": jnp.asarray(gc.transpose(2, 3, 1, 0))}}}}}
    updates, state = tx.update(grads, state, jparams)
    return optax.apply_updates(jparams, updates), state


def _port_update(named, opt, gw, gc):
    named["transformer.w"].grad = torch.from_numpy(gw.copy())
    named[CONV].grad = torch.from_numpy(gc.copy())
    opt.step()


def _assert_same(jparams, named, equal_nan=False):
    conv = np.asarray(jparams["backbone"]["body"]["layer2_block0"]["conv1"]
                      ["kernel"]).transpose(3, 2, 0, 1)
    for got, want in ((named["transformer.w"], jparams["transformer"]["w"]),
                      (named[CONV], conv)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, equal_nan=equal_nan)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_ten_updates_match_optax(schedule):
    jparams, tx, state, named, opt = _toy(SCHEDULES[schedule])
    rng = np.random.RandomState(1)
    start = named["transformer.w"].detach().clone()
    for i in range(10):
        gw, gc = _grads(rng)
        jparams, state = _jax_update(tx, state, jparams, gw, gc)
        _port_update(named, opt, gw, gc)
        _assert_same(jparams, named)
        if i == 0:
            # the first update uses the base rate: Adam's first step moves
            # every weight by the rate, against the gradient's sign
            moved = named["transformer.w"].detach() - start
            np.testing.assert_allclose(moved.numpy(), -1e-2 * np.sign(gw),
                                       atol=1e-6, rtol=0)
    assert int(opt.count) == 10


def test_nonfinite_step_changes_nothing_and_the_next_equals_optax():
    jparams, tx, state, named, opt = _toy(SCHEDULES["cosine"])
    rng = np.random.RandomState(2)
    for _ in range(3):
        gw, gc = _grads(rng)
        jparams, state = _jax_update(tx, state, jparams, gw, gc)
        _port_update(named, opt, gw, gc)
    before = {k: v.clone() for k, v in opt.state_dict()["mu"].items()}
    before_nu = {k: v.clone() for k, v in opt.state_dict()["nu"].items()}
    before_p = {k: p.detach().clone() for k, p in named.items()}

    gw, gc = _grads(rng, nan=True)
    jparams, state = _jax_update(tx, state, jparams, gw, gc)
    _port_update(named, opt, gw, gc)
    for k in named:
        assert torch.equal(named[k].detach(), before_p[k])
        assert torch.equal(opt.mu[k], before[k])
        assert torch.equal(opt.nu[k], before_nu[k])
    assert int(opt.count) == 3  # the schedule did not advance either
    assert int(opt.notfinite_count) == int(state.notfinite_count) == 1
    assert int(opt.total_notfinite) == int(state.total_notfinite) == 1
    assert bool(opt.last_finite) is bool(state.last_finite) is False
    _assert_same(jparams, named)

    gw, gc = _grads(rng)
    jparams, state = _jax_update(tx, state, jparams, gw, gc)
    _port_update(named, opt, gw, gc)
    _assert_same(jparams, named)
    assert int(opt.count) == 4
    assert int(opt.notfinite_count) == int(state.notfinite_count) == 0
    assert int(opt.total_notfinite) == int(state.total_notfinite) == 1
    assert bool(opt.last_finite) is True


def test_the_101st_nonfinite_step_in_a_row_is_applied_as_optax_does():
    jparams, tx, state, named, opt = _toy(SCHEDULES["constant"])
    rng = np.random.RandomState(3)
    gw, gc = _grads(rng)
    jparams, state = _jax_update(tx, state, jparams, gw, gc)
    _port_update(named, opt, gw, gc)
    update = jax.jit(lambda s, p, a, b: _jax_update(tx, s, p, a, b))
    gw, gc = _grads(rng, nan=True)
    for i in range(1, 102):
        jparams, state = update(state, jparams, gw, gc)
        _port_update(named, opt, gw, gc)
        assert int(opt.notfinite_count) == int(state.notfinite_count) == i
        if i <= 100:
            assert torch.isfinite(named["transformer.w"]).all(), i
            assert int(opt.count) == 1
    _assert_same(jparams, named, equal_nan=True)
    # a NaN in one element of one gradient: that element's weight is lost
    got = named["transformer.w"].detach().numpy()
    assert np.isnan(got[2]) and np.isfinite(np.delete(got, 2)).all()
    assert int(opt.count) == 2
    assert int(opt.total_notfinite) == int(state.total_notfinite) == 101


def test_optimizer_state_round_trip_and_mismatch():
    _, _, _, named, opt = _toy(SCHEDULES["cosine"])
    rng = np.random.RandomState(4)
    for nan in (False, True, False):
        _port_update(named, opt, *_grads(rng, nan=nan))
    saved = {k: (dict(v) if isinstance(v, dict) else v.clone())
             for k, v in opt.state_dict().items()}
    _, _, _, named2, opt2 = _toy(SCHEDULES["cosine"])
    opt2.load_state_dict(saved)
    for k in named:
        named2[k].data.copy_(named[k].data)
    gw, gc = _grads(rng)
    _port_update(named, opt, gw, gc)
    _port_update(named2, opt2, gw, gc)
    for k in named:
        assert torch.equal(named[k].detach(), named2[k].detach())
    assert int(opt2.total_notfinite) == 1 and int(opt2.count) == 3
    bad = dict(saved, mu={"transformer.w": saved["mu"]["transformer.w"]})
    with pytest.raises(ValueError, match="optimizer state holds mu"):
        opt2.load_state_dict(bad)


def test_a_cpu_step_takes_the_loop_and_builds_no_kernel(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU step asked for the CUDA library")

    monkeypatch.setattr(native, "build_cuda_library", refuse)
    monkeypatch.setattr(native, "_nvcc", refuse)
    monkeypatch.setattr(port_optim, "_library", refuse)
    jparams, tx, state, named, opt = _toy(SCHEDULES["cosine"])
    before = port_optim.launches
    rng = np.random.RandomState(5)
    for _ in range(3):
        gw, gc = _grads(rng)
        jparams, state = _jax_update(tx, state, jparams, gw, gc)
        _port_update(named, opt, gw, gc)
    _assert_same(jparams, named)
    assert port_optim.launches == before


def test_a_reload_into_the_same_optimizer_then_a_step_equals_unbroken_steps():
    _, _, _, named, opt = _toy(SCHEDULES["cosine"])
    _, _, _, unbroken, opt_u = _toy(SCHEDULES["cosine"])
    rng = np.random.RandomState(6)
    steps = [_grads(rng, nan=nan) for nan in (False, True, False)]
    for gw, gc in steps[:2]:
        _port_update(named, opt, gw, gc)
        _port_update(unbroken, opt_u, gw, gc)
    saved = opt.state_dict()
    weights = {k: p.detach().clone() for k, p in named.items()}
    for _ in range(2):
        _port_update(named, opt, *_grads(rng))
    opt.load_state_dict(saved)
    for k, p in named.items():
        p.data.copy_(weights[k])
    _port_update(named, opt, *steps[2])
    _port_update(unbroken, opt_u, *steps[2])
    for k in named:
        assert torch.equal(named[k].detach(), unbroken[k].detach())
        assert torch.equal(opt.mu[k], opt_u.mu[k])
        assert torch.equal(opt.nu[k], opt_u.nu[k])
    assert int(opt.count) == int(opt_u.count) == 2
    assert int(opt.total_notfinite) == int(opt_u.total_notfinite) == 1


def test_state_dict_shares_no_tensor_with_the_live_state():
    """The card's step updates the state in place, so a kept state dict
    holds copies."""
    _, _, _, named, opt = _toy(SCHEDULES["constant"])
    _port_update(named, opt, *_grads(np.random.RandomState(7)))
    saved = opt.state_dict()
    live = [opt.count, opt.notfinite_count, opt.total_notfinite,
            opt.last_finite, *opt.mu.values(), *opt.nu.values()]
    kept = [saved["count"], saved["notfinite_count"],
            saved["total_notfinite"], saved["last_finite"],
            *saved["mu"].values(), *saved["nu"].values()]
    ptrs = {t.untyped_storage().data_ptr() for t in live}
    assert not ptrs & {t.untyped_storage().data_ptr() for t in kept}
    for a, b in zip(live, kept):
        assert torch.equal(a, b)


def _adam_step_fields():
    """(name, ctypes type) of each field of ``csrc/adam.cu``'s
    ``struct AdamStep``, read from the source."""
    source = (Path(native.__file__).parent / "csrc" / "adam.cu").read_text()
    body = re.search(r"struct AdamStep \{(.*?)\};", source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    scalars = {"int": ctypes.c_int, "float": ctypes.c_float}
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        kind, pointer, names = re.fullmatch(
            r"(unsigned int|int|float|bool)\s*(\*?)\s*(.+)", decl,
            re.S).groups()
        for name in (n.strip() for n in names.split(",")):
            count = re.fullmatch(r"(\w+)\[(\d+)\]", name)
            ctype = ctypes.c_void_p if pointer else scalars[kind]
            if count:
                name, ctype = count.group(1), ctype * int(count.group(2))
            fields.append((name, ctype))
    return fields


def test_the_step_mirror_lays_out_as_the_kernels_struct():
    """``optim._Step`` passes ``AdamStep`` to the kernel by pointer: the
    same fields, in the same order, at the same offsets. The library checks
    it again at load, on the card."""
    fields = _adam_step_fields()

    class FromSource(ctypes.Structure):
        _fields_ = fields

    assert [n for n, _ in fields] == \
        [n for n, _ in port_optim._Step._fields_]
    want = [ctypes.sizeof(FromSource)] + [getattr(FromSource, n).offset
                                          for n, _ in fields]
    assert port_optim._step_layout() == want

    def kind(ctype):
        if issubclass(ctype, ctypes.Array):
            return ctype._type_._type_, ctype._length_
        return ctype._type_

    for (name, ctype), (_, mine) in zip(fields,
                                        port_optim._Step._fields_):
        assert kind(ctype) == kind(mine), name


@pytest.mark.parametrize("shift", [0, 1])
def test_a_library_whose_struct_differs_is_refused(shift):
    want = port_optim._step_layout()

    class Library:
        @staticmethod
        def cotr_adam_step_layout(out):
            for i, v in enumerate(want):
                out[i] = v + (shift if i == len(want) - 1 else 0)
            return len(want)

    if shift:
        with pytest.raises(RuntimeError, match="AdamStep"):
            port_optim._check_step_layout(Library)
    else:
        port_optim._check_step_layout(Library)


def test_unknown_schedule_raises():
    named = {"transformer.w": nn.Parameter(torch.zeros(2))}
    with pytest.raises(ValueError, match="lr_schedule"):
        port_optim.Optimizer(TrainConfig(lr_schedule="linear"), named)
