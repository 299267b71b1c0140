"""The optimizer's Adam kernels (``csrc/adam.cu``) against its plain eager
loop (``Optimizer.step_plain``), on a card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_adam_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.) Without a card every
test skips. Each test runs the kernels and the loop on copies of one seeded
state and holds them equal to the bit: the kernels compute every value in
the loop's order of float32 operations.
"""

import os

import pytest
import torch
from torch import nn

from cotr_tpu_torch.config import COTRConfig, TrainConfig
from cotr_tpu_torch.models.cotr import build_model
from cotr_tpu_torch.parallel import mesh as par
from cotr_tpu_torch.training import optim

#: the published model's trainable tensors and parameters at lr_backbone 0
PUBLISHED_TENSORS, PUBLISHED_PARAMS = 202, 9_872_130


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def published(card):
    """The published model's parameters on the CPU, by name."""
    return {n: p.detach() for n, p in
            build_model(COTRConfig()).named_parameters()}


def _state(names_shapes, card, seed=0):
    """Seeded float32 parameters on the card, by name."""
    gen = torch.Generator(device=card).manual_seed(seed)
    return {n: nn.Parameter(0.05 * torch.randn(shape, generator=gen,
                                                device=card))
            for n, shape in names_shapes.items()}


def _pair(names_shapes, card, cfg, **kw):
    """Two optimizers over equal copies of one seeded state."""
    named = _state(names_shapes, card)
    twin = {n: nn.Parameter(p.detach().clone()) for n, p in named.items()}
    return (named, optim.Optimizer(cfg, named, **kw)), \
        (twin, optim.Optimizer(cfg, twin, **kw))


def _set_grads(sides, step, nan_in=None):
    """The same gradients on both sides: normal draws scaled by a power of
    ten drawn a tensor, from 1e-7 (where eps acts) to 1."""
    gen = torch.Generator(device=sides[0][0][next(iter(sides[0][0]))].device)
    gen.manual_seed(1000 + step)
    for i, name in enumerate(sides[0][0]):
        p = sides[0][0][name]
        scale = 10.0 ** -(i % 8)
        g = scale * torch.randn(p.shape, generator=gen, device=p.device)
        if name == nan_in:
            g.view(-1)[p.numel() // 2] = float("nan")
        for named, _ in sides:
            if named[name].requires_grad:
                named[name].grad = g.clone()


def _assert_bits(got, want, what):
    gi, wi = got.contiguous().view(torch.int32), \
        want.contiguous().view(torch.int32)
    if not torch.equal(gi, wi):
        diff = (gi.long() - wi.long()).abs()
        raise AssertionError(f"{what}: {int((diff != 0).sum())} of "
                             f"{gi.numel()} values differ, by at most "
                             f"{int(diff.max())} ulp")


def _assert_same(kernel, plain):
    (kn, ko), (pn, po) = kernel, plain
    for name in ko.params:
        _assert_bits(kn[name].detach(), pn[name].detach(), f"w[{name}]")
        _assert_bits(ko.mu[name], po.mu[name], f"mu[{name}]")
        _assert_bits(ko.nu[name], po.nu[name], f"nu[{name}]")
    for attr in ("count", "notfinite_count", "total_notfinite",
                 "last_finite"):
        assert torch.equal(getattr(ko, attr), getattr(po, attr)), attr


def _steps(kernel, plain, n, nan_in=None, first=0):
    for s in range(first, first + n):
        _set_grads((kernel, plain), s, nan_in)
        kernel[1].step()
        plain[1].step_plain()
        torch.cuda.synchronize()
    return kernel, plain


def _shapes(params):
    return {n: p.shape for n, p in params.items()}


def _toy_shapes():
    """A main tensor over several chunks (its last one ragged), a small
    one, and a backbone convolution."""
    return {"transformer.w": (3 * optim.KERNEL_CHUNK + 77,),
            "transformer.b": (7,),
            "backbone.body.layer2_block0.conv1.weight": (8, 4, 3, 3)}


@pytest.mark.cuda
def test_three_steps_of_the_published_model_equal_the_loop(card, published):
    kernel, plain = _pair(_shapes(published), card, TrainConfig())
    assert len(kernel[1].params) == PUBLISHED_TENSORS
    assert sum(p.numel() for p in kernel[1].params.values()) \
        == PUBLISHED_PARAMS
    before = optim.launches
    _assert_same(*_steps(kernel, plain, 3))
    assert optim.launches == before + 6
    assert int(kernel[1].count) == 3


@pytest.mark.cuda
def test_a_nan_changes_nothing_and_the_counters_move_as_the_loop(card):
    kernel, plain = _pair(_toy_shapes(), card, TrainConfig(
        learning_rate=1e-2, lr_backbone=3e-3))
    _steps(kernel, plain, 2)
    kept = {n: p.detach().clone() for n, p in kernel[0].items()}
    mu = {n: m.clone() for n, m in kernel[1].mu.items()}
    _steps(kernel, plain, 1, nan_in="transformer.w", first=2)
    for name in kept:
        assert torch.equal(kernel[0][name].detach(), kept[name]), name
        assert torch.equal(kernel[1].mu[name], mu[name]), name
    assert (int(kernel[1].count), int(kernel[1].notfinite_count),
            int(kernel[1].total_notfinite), bool(kernel[1].last_finite)) \
        == (2, 1, 1, False)
    _assert_same(kernel, plain)
    _assert_same(*_steps(kernel, plain, 2, first=3))
    assert (int(kernel[1].count), int(kernel[1].notfinite_count),
            int(kernel[1].total_notfinite)) == (4, 0, 1)


@pytest.mark.cuda
def test_the_101st_nonfinite_step_in_a_row_is_applied_as_the_loop(card):
    kernel, plain = _pair(_toy_shapes(), card, TrainConfig(
        learning_rate=1e-2, lr_backbone=3e-3))
    _steps(kernel, plain, 1)
    _steps(kernel, plain, optim.MAX_CONSECUTIVE_ERRORS, nan_in="transformer.w",
           first=1)
    assert int(kernel[1].count) == 1
    _assert_same(*_steps(kernel, plain, 1, nan_in="transformer.w",
                         first=1 + optim.MAX_CONSECUTIVE_ERRORS))
    w = kernel[0]["transformer.w"].detach()
    assert int(kernel[1].count) == 2 and torch.isnan(w).sum() == 1
    assert int(kernel[1].notfinite_count) \
        == optim.MAX_CONSECUTIVE_ERRORS + 1


@pytest.mark.cuda
def test_the_cosine_schedule_across_its_decay_steps(card):
    kernel, plain = _pair(_toy_shapes(), card, TrainConfig(
        learning_rate=1e-2, lr_backbone=3e-3, lr_schedule="cosine",
        lr_decay_steps=7, lr_final_frac=0.05))
    for s in range(10):
        _assert_same(*_steps(kernel, plain, 1, first=s))


@pytest.mark.cuda
def test_both_groups_of_the_published_model_at_lr_backbone(card, published):
    cfg = TrainConfig(lr_backbone=1e-5)
    kernel, plain = _pair(_shapes(published), card, cfg)
    assert kernel[1].groups["backbone"]
    _assert_same(*_steps(kernel, plain, 3))


@pytest.mark.cuda
def test_a_one_rank_nccl_mesh(card, published, tmp_path):
    """The kernels inside a one-rank NCCL process group. At world size 1
    ZeRO-1 splits nothing, so no moment is a slice here: the ZeRO-1 slices
    are ``test_zero1_slices_of_a_two_rank_axis``'s."""
    started = par.init_distributed(
        "cuda", store=torch.distributed.FileStore(
            os.path.join(tmp_path, "store"), 1), rank=0, world_size=1)
    assert started
    try:
        mesh = par.make_mesh()
        assert mesh.size == 1
        kernel, plain = _pair(_shapes(published), card, TrainConfig(),
                              mesh=mesh, zero1_axis="data")
        assert not kernel[1].zero1
        _assert_same(*_steps(kernel, plain, 3))
        full = kernel[1].state_dict()["mu"]
        assert all(torch.equal(full[n], plain[1].mu[n]) for n in full)
    finally:
        torch.distributed.destroy_process_group()


class _RankOfTwo(par.ProcessMesh):
    """Rank ``coord`` of a two-rank data axis in this one process: its
    collectives are faked by the test (one card holds one NCCL rank)."""

    def __init__(self, coord, device):
        par.Mesh.__init__(self, ("data",), (2,))
        self.device, self._coord = device, coord

    def group(self, axis):
        return None

    def coordinate(self, axis):
        return self._coord


@pytest.mark.cuda
@pytest.mark.parametrize("coord", [0, 1])
def test_zero1_slices_of_a_two_rank_axis(card, published, coord,
                                         monkeypatch):
    """Each rank's ZeRO-1 slices (dim 1 of a dense weight is not
    contiguous) through the kernels, gathered as the loop gathers them. The
    other rank's slices come back as zeros on both sides, and the flag's
    minimum is this rank's own."""
    def all_gather(parts, flat, group=None):
        for i, part in enumerate(parts):
            part.copy_(flat if i == coord else torch.zeros_like(flat))

    monkeypatch.setattr(torch.distributed, "all_gather", all_gather)
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, op=None, group=None: None)
    mesh = _RankOfTwo(coord, card)
    kernel, plain = _pair(_shapes(published), card, TrainConfig(),
                          mesh=mesh, zero1_axis="data")
    parts = [kernel[1]._moment_part(n, p) for n, p in
             kernel[1].params.items() if n in kernel[1].zero1]
    assert any(not t.is_contiguous() for t in parts)
    _assert_same(*_steps(kernel, plain, 3))


@pytest.mark.cuda
def test_a_step_launches_two_kernels_and_never_waits(card, published):
    kernel, _ = _pair(_shapes(published), card, TrainConfig())
    named, opt = kernel
    torch.cuda.set_sync_debug_mode("error")
    try:
        for s in range(3):  # the first builds and uploads the tables
            _set_grads((kernel,), s)
            opt.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _set_grads((kernel,), 3)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.step()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    runtime = sum(n in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel") for n in names)
    kernels = [n for n in names if "adam_" in n]
    print(f"launch calls in one step: {runtime}; kernels {kernels}")
    assert runtime <= 16
    assert sum("adam_finite" in n for n in kernels) == 1
    assert sum("adam_update" in n for n in kernels) == 1


@pytest.mark.cuda
def test_a_reload_then_a_step_equals_unbroken_steps(card):
    """The tables the kernels keep do not outlive a reload: the moments it
    brings are new tensors."""
    cfg = TrainConfig(learning_rate=1e-2, lr_backbone=3e-3)
    (named, opt), (fresh, fresh_opt) = _pair(_toy_shapes(), card, cfg)
    for s in (0, 1):
        _set_grads(((named, opt),), s)
        opt.step()
        _set_grads(((fresh, fresh_opt),), s)
        fresh_opt.step()
    saved = opt.state_dict()
    kept = {n: m.clone() for n, m in saved["mu"].items()}
    weights = {n: p.detach().clone() for n, p in named.items()}
    for s in (5, 6):
        _set_grads(((named, opt),), s)
        opt.step()
    # a state dict is a copy: the steps since moved the state in place
    assert int(saved["count"]) == 2 and int(opt.count) == 4
    assert all(torch.equal(saved["mu"][n], kept[n]) for n in kept)
    opt.load_state_dict(saved)
    for name, p in named.items():
        p.data.copy_(weights[name])
    _set_grads(((named, opt), (fresh, fresh_opt)), 2)
    opt.step()
    fresh_opt.step()
    _assert_same((named, opt), (fresh, fresh_opt))
