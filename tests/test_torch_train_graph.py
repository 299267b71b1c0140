"""The train step replayed as a CUDA graph (``training/train_step.py``).

On the CPU: the rule that decides when a step is captured, with the CPU
taken for a card and the graph API faked (a capture runs its body eagerly,
a replay does nothing), so the decision is seen without a card. On a card:
the graphed step against the eager body, bit for bit, at the published
width and batch.

This file imports neither JAX nor the JAX package, so its card tests run
on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_train_graph.py

(``--noconftest``: tests/conftest.py configures JAX.) Without a card the
card tests skip.
"""

import contextlib
import copy
import dataclasses

import pytest
import torch
import torch.distributed as dist

from cotr_tpu_torch.config import COTRConfig, TrainConfig
from cotr_tpu_torch.models.cotr import build_model, init_weights
from cotr_tpu_torch.parallel import mesh as par
from cotr_tpu_torch.training import train_step as ts

#: one encoder and one decoder layer; dropout stays on, so the steps draw
#: from their generator
TINY = COTRConfig(enc_layers=1, dec_layers=1, hidden_dim=64, nheads=2)


def crop_batch(b, q, seed, device="cpu", photo=True):
    """A batch of the crop layout: uint8 crops, homographies near the
    identity, queries in the A half and targets in the B half."""
    gen = torch.Generator().manual_seed(seed)
    crop = torch.randint(0, 256, (b, 256, 256, 3), generator=gen,
                         dtype=torch.uint8)
    jitter = torch.tensor([[0.02, 0.02, 3.0], [0.02, 0.02, 3.0],
                           [1e-5, 1e-5, 0.0]])
    h_mat = torch.eye(3) + jitter * (2 * torch.rand(b, 3, 3, generator=gen)
                                     - 1)
    queries = torch.rand(b, q, 2, generator=gen) * torch.tensor([0.4, 0.9]) \
        + 0.05
    batch = dict(crop=crop, h_mat=h_mat, queries=queries,
                 targets=queries + torch.tensor([0.5, 0.0]))
    if photo:
        batch["photo"] = torch.cat([
            0.9 + 0.2 * torch.rand(b, 2, 3, generator=gen),
            0.04 * torch.rand(b, 2, 1, generator=gen) - 0.02], dim=-1)
    return {k: v.to(device) for k, v in batch.items()}


# ----------------------------------------------------------- the CPU: rule


class FakeGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: records the generators
    registered with it and counts its replays."""

    def __init__(self):
        self.generators, self.replays = [], 0

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        self.replays += 1


@pytest.fixture
def as_card(monkeypatch):
    """The CPU taken for a card by the rule; the capture's body runs
    eagerly. Yields the graphs made."""
    made = []

    def new_graph():
        made.append(FakeGraph())
        return made[-1]

    monkeypatch.setattr(ts, "_on_card", lambda device: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: contextlib.nullcontext())
    yield made


def tiny_state(remat=False, mesh=None):
    model = build_model(dataclasses.replace(TINY, remat=remat))
    init_weights(model, torch.Generator().manual_seed(5))
    cfg = TrainConfig(batch_size=1, num_kp=2)
    return cfg, ts.create_train_state(model, cfg, device="cpu", mesh=mesh)


@contextlib.contextmanager
def one_rank_mesh():
    """A process mesh of one gloo rank in this process."""
    par.init_distributed("cpu", store=dist.HashStore(), rank=0,
                         world_size=1)
    try:
        yield par.make_mesh()
    finally:
        dist.destroy_process_group()


def test_a_repeated_signature_on_the_card_is_captured_once(as_card,
                                                           monkeypatch):
    """The rule's positive case: the first call warms up eagerly, the
    second captures and replays, the third replays; the generator is
    registered with the graph, the gradients are the graph's, and each
    replay sits in a ``cotr.train.replay`` span inside its step's."""
    opened = []

    @contextlib.contextmanager
    def record(name):
        opened.append(name)
        yield

    monkeypatch.setattr(ts, "span", record)
    cfg, state = tiny_state()
    step = ts.make_train_step(cfg)
    gen = torch.Generator().manual_seed(1)
    batch = crop_batch(1, 4, seed=0)
    metrics = []
    for _ in range(3):
        state, m = step(state, batch, gen)
        metrics.append(m)
    assert step.counts == {"captures": 1, "replays": 2, "eager": 1}
    assert len(as_card) == 1 and as_card[0].generators == [gen]
    assert as_card[0].replays == 2
    assert state.step == 3
    assert opened == ["cotr.train.step", "cotr.train.forward",
                      "cotr.train.backward", "cotr.train.optimizer"] \
        + 2 * ["cotr.train.step", "cotr.train.replay",
               "cotr.train.optimizer"]
    # the replayed steps return copies, not the graph's own outputs
    assert metrics[1]["loss"] is not metrics[2]["loss"]
    assert metrics[2]["loss"].data_ptr() != metrics[1]["loss"].data_ptr()
    # an eager step in between drops the graph's gradients; the next
    # replay hands them back before Adam reads them
    grads = {n: p.grad for n, p in state.optimizer.params.items()}
    state, _ = step.eager(state, batch, gen)
    assert all(p.grad is not grads[n]
               for n, p in state.optimizer.params.items())
    state, _ = step(state, batch, gen)
    assert all(p.grad is grads[n] for n, p in state.optimizer.params.items())
    assert step.counts == {"captures": 1, "replays": 3, "eager": 2}


@pytest.mark.parametrize("case", ["cpu", "mesh", "remat", "changed_shape",
                                  "changed_keys", "new_generator"])
def test_each_case_the_rule_leaves_out_runs_eagerly(case, request):
    """Two calls that a card would capture on the second, but for one
    thing the rule reads: each runs eagerly and nothing is captured."""
    if case != "cpu":
        request.getfixturevalue("as_card")
    first = crop_batch(1, 4, seed=0)
    second = dict(first)
    gens = [torch.Generator().manual_seed(1)] * 2
    if case == "changed_shape":
        second = crop_batch(1, 6, seed=0)
    elif case == "changed_keys":
        second = crop_batch(1, 4, seed=0, photo=False)
    elif case == "new_generator":
        gens[1] = torch.Generator().manual_seed(1)
    with one_rank_mesh() if case == "mesh" else \
            contextlib.nullcontext() as mesh:
        cfg, state = tiny_state(remat=case == "remat", mesh=mesh)
        step = ts.make_train_step(cfg, mesh)
        for batch, gen in zip((first, second), gens):
            state, metrics = step(state, batch, gen)
            assert torch.isfinite(metrics["loss"])
    assert step.counts == {"captures": 0, "replays": 0, "eager": 2}


# ------------------------------------------------------- the card: bits

#: the traffic of the benchmark's training cell: batch 24, 100 keypoints
#: both ways
CARD_BATCH, CARD_QUERIES = 24, 200


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    # cuDNN's default weight-gradient algorithm for the input projection
    # does not repeat itself bit for bit from one eager step to the next;
    # its deterministic one does, on both paths
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = before


def bits(t):
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def assert_bits(got, want, what):
    if not torch.equal(bits(got), bits(want)):
        raise AssertionError(f"{what}: the graphed step differs from the "
                             f"eager one")


def assert_same_state(graphed, eager, gens):
    (gs, gm), (es, em) = graphed, eager
    for k in ("loss", "corr_loss", "cycle_loss", "pred", "target"):
        assert_bits(gm[k], em[k], f"metrics[{k}]")
    want = es.model.state_dict()
    for k, v in gs.model.state_dict().items():
        assert_bits(v, want[k], f"weight {k}")
    go, eo = gs.optimizer, es.optimizer
    for n in eo.mu:
        assert_bits(go.mu[n], eo.mu[n], f"mu[{n}]")
        assert_bits(go.nu[n], eo.nu[n], f"nu[{n}]")
    for attr in ("count", "notfinite_count", "total_notfinite",
                 "last_finite"):
        assert torch.equal(getattr(go, attr), getattr(eo, attr)), attr
    assert gs.step == es.step
    assert torch.equal(gens[0].get_state(), gens[1].get_state()), \
        "the generators moved apart"


@pytest.mark.cuda
def test_graphed_steps_equal_the_eager_body_to_the_bit(card):
    """Five steps of the published model at batch 24 through the eager
    body and through ``make_train_step`` (warm-up, capture, replays), on
    three batches at their own addresses, cycled: losses, every weight,
    Adam's moments and counters and the generator's state agree after
    every step; what a replayed step returned still holds after the next
    replay; then a batch with a NaN is skipped alike."""
    cfg = TrainConfig(batch_size=CARD_BATCH, num_kp=CARD_QUERIES // 2)
    model = build_model(COTRConfig())
    init_weights(model, torch.Generator().manual_seed(0))
    twin = copy.deepcopy(model)
    graphed = ts.make_train_step(cfg)
    eager = ts.make_train_step(cfg).eager
    states = [ts.create_train_state(m, cfg, device=card)
              for m in (model, twin)]
    gens = [torch.Generator(device=card).manual_seed(20) for _ in range(2)]
    batches = [crop_batch(CARD_BATCH, CARD_QUERIES, seed=s, device=card)
               for s in range(3)]
    kept = []
    for k in range(5):
        batch = batches[k % 3]
        states[0], got = graphed(states[0], batch, gens[0])
        states[1], want = eager(states[1], batch, gens[1])
        torch.cuda.synchronize()
        assert_same_state((states[0], got), (states[1], want), gens)
        kept.append(({n: v.clone() for n, v in want.items()}, got))
        if k:
            before_want, before_got = kept[k - 1]
            for n in before_want:
                assert_bits(before_got[n], before_want[n],
                            f"step {k}'s metrics[{n}] after step {k + 1}")
    assert graphed.counts == {"captures": 1, "replays": 4, "eager": 1}

    bad = dict(batches[1], targets=batches[1]["targets"].clone())
    bad["targets"][0, 0, 0] = float("nan")
    weights = {n: p.detach().clone()
               for n, p in states[0].optimizer.params.items()}
    states[0], got = graphed(states[0], bad, gens[0])
    states[1], want = eager(states[1], bad, gens[1])
    torch.cuda.synchronize()
    assert_same_state((states[0], got), (states[1], want), gens)
    assert not torch.isfinite(got["loss"])
    opt = states[0].optimizer
    assert int(opt.count) == 5 and int(opt.notfinite_count) == 1
    for n, p in opt.params.items():
        assert_bits(p, weights[n], f"{n} after the NaN step")
    assert graphed.counts == {"captures": 1, "replays": 5, "eager": 1}
