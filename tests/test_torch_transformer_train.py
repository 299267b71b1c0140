"""The training side of the port's transformer against cotr_tpu on the CPU:
the einsum attention with a key-padding mask, ``return_intermediate``,
dropout from a generator, the routing rule and ``remat``.

Tolerances, float32 on both sides: attention 1e-5 absolute, intermediate
decoder outputs 1e-4 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cotr_tpu.models import transformer as jax_tr
from cotr_tpu_torch.models import transformer as port_tr
from cotr_tpu_torch.ops import attention
from cotr_tpu_torch.ops.dropout import dropout

from tests.test_torch_common import (few_torch_threads,  # noqa: F401
                                     grads_to_port, random_canvas,
                                     small_models)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

ATTN_ATOL = 1e-5
INTERMEDIATE_ATOL = 1e-4
D, H, S, LQ, B = 64, 2, 24, 5, 3


def _mha_pair(seed=0):
    """The JAX MultiHeadAttention and the port's, sharing weights."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, LQ, D).astype(np.float32)
    k = rng.randn(B, S, D).astype(np.float32)
    v = rng.randn(B, S, D).astype(np.float32)
    jmha = jax_tr.MultiHeadAttention(D, H, dropout=0.1)
    variables = jmha.init(jax.random.PRNGKey(seed), q, k, v)
    variables = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(1), x.shape),
        variables)  # biases away from zero
    tmha = port_tr.MultiHeadAttention(D, H, dropout=0.1).eval()
    tmha.load_state_dict({k_: torch.from_numpy(v_)
                          for k_, v_ in grads_to_port(variables).items()})
    return jmha, variables, tmha, (q, k, v)


def _mask(kind):
    mask = np.zeros((B, S), bool)
    if kind == "some":
        mask[0, S // 2:] = True
        mask[1, ::3] = True
    elif kind == "row_masked_whole":
        mask[0, 3:] = True
        mask[2, :] = True
    return None if kind == "none" else mask


@pytest.mark.parametrize("kind", ["none", "some", "row_masked_whole"])
def test_einsum_path_matches_jax_attention(kind):
    jmha, variables, tmha, (q, k, v) = _mha_pair()
    mask = _mask(kind)
    want = np.asarray(jmha.apply(
        variables, q, k, v, deterministic=True,
        key_padding_mask=None if mask is None else jnp.asarray(mask)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tmha(tq, tk, tv, None if mask is None else torch.from_numpy(mask))
    assert got.requires_grad  # a gradient was wanted: the einsum path ran
    assert np.isfinite(got.detach().numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATTN_ATOL,
                               rtol=0)


def test_row_masked_whole_is_uniform_not_nan():
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(1, n, H, 32).astype(np.float32))
               for n in (LQ, S, S))
    out = attention.einsum_attention(q, k, v, torch.ones(1, S,
                                                         dtype=torch.bool))
    np.testing.assert_allclose(out.numpy(),
                               v.mean(dim=1, keepdim=True).expand_as(out),
                               atol=1e-6, rtol=0)


def test_einsum_path_is_differentiable_and_the_kernel_wrapper_refuses():
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(1, n, H, 32).astype(np.float32))
               .requires_grad_() for n in (LQ, S, S))
    attention.einsum_attention(q, k, v).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))
    # without mask or dropout the two paths agree to rounding in float32
    with torch.no_grad():
        np.testing.assert_allclose(
            attention.einsum_attention(q, k, v).numpy(),
            attention.flash_cross_attention(q, k, v).numpy(), atol=1e-6,
            rtol=0)


@pytest.fixture(scope="module")
def models():
    return small_models()


def test_return_intermediate_matches_jax(models):
    jmodel, variables, tmodel = models
    rng = np.random.RandomState(3)
    canvas = random_canvas(rng, 1)
    queries = rng.uniform(0.05, 0.95, (1, 6, 2)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda c, q: jmodel.apply(variables, c, q, return_intermediate=True)
    )(canvas, queries))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(canvas), torch.from_numpy(queries),
                     return_intermediate=True).numpy()
        last = tmodel(torch.from_numpy(canvas),
                      torch.from_numpy(queries)).numpy()
    assert got.shape == want.shape == (2, 1, 6, 2)
    np.testing.assert_allclose(got, want, atol=INTERMEDIATE_ATOL, rtol=0)
    np.testing.assert_array_equal(got[-1], last)


def _transformer(dropout_p, remat=False, seed=5):
    tr = port_tr.Transformer(D, H, enc_layers=2, dec_layers=2,
                             dim_feedforward=128, dropout=dropout_p,
                             remat=remat)
    port_tr.xavier_reset(tr, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    src, pos = (torch.from_numpy(rng.randn(2, S, D).astype(np.float32))
                for _ in range(2))
    qe = torch.from_numpy(rng.randn(2, LQ, D).astype(np.float32))
    return tr, src, pos, qe


def _run(tr, src, pos, qe, seed):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return tr.decode(tr.encode(src, pos, generator=gen), pos, qe,
                     generator=gen)


def test_dropout_in_train_mode_from_the_generator():
    tr, src, pos, qe = _transformer(0.1)
    with torch.no_grad():
        tr.eval()
        eval_out = _run(tr, src, pos, qe, 0)
        assert torch.equal(eval_out, _run(tr, src, pos, qe, 1))
        tr.train()
        a = _run(tr, src, pos, qe, 0)
        assert not torch.allclose(a, eval_out, atol=1e-3)
        assert torch.equal(a, _run(tr, src, pos, qe, 0))
        assert not torch.allclose(a, _run(tr, src, pos, qe, 1), atol=1e-3)


def test_dropout_keeps_the_mean():
    """Inverted dropout is unbiased: the mean over many draws nears the
    input (2,000 draws of p = 0.1: the standard error of an element's mean
    is |x|/3 * 2000**-0.5 = 0.0075 |x|; 6 of those allowed)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.linspace(-2, 2, 64).reshape(8, 8)
    mean = torch.stack([dropout(x, 0.1, True, gen)
                        for _ in range(2000)]).mean(dim=0)
    assert (mean - x).abs().max() <= 6 * 0.0075 * 2.0
    kept = dropout(torch.ones(100_000), 0.1, True, gen)
    assert set(kept.unique().tolist()) == {0.0, float(np.float32(1.0 / 0.9))}
    assert abs(float((kept == 0).float().mean()) - 0.1) < 0.005
    assert dropout(x, 0.1, False, gen) is x and dropout(x, 0.0, True) is x


def test_train_mode_mean_over_draws_nears_eval_output():
    """After the dropout on its probabilities an attention is linear, so
    its train-mode output is unbiased: averaged over 1,000 generator seeds
    it lies over ten times nearer the eval output than single draws do
    (1000**-0.5 = 1/32 in expectation)."""
    _, _, tmha, (q, k, v) = _mha_pair()
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with torch.no_grad():
        want = tmha(tq, tk, tv)
        tmha.train()
        draws = torch.stack([
            tmha(tq, tk, tv, generator=torch.Generator().manual_seed(s))
            for s in range(1000)])
    single = (draws - want).abs().mean()
    averaged = (draws.mean(dim=0) - want).abs().mean()
    assert single > 1e-3
    assert averaged < single / 10.0


def test_eval_mode_with_dropout_equals_jax_deterministic(models):
    """A model configured with dropout 0.1 in eval mode is the JAX model's
    deterministic forward: the same weights give the same output as the
    dropout-0 model."""
    from cotr_tpu import COTRConfig as JaxConfig, build_model as jax_build
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.models.cotr import build_model
    from tests.test_torch_common import SMALL

    _, variables, tmodel = models
    small = dict(SMALL, dropout=0.1)
    jmodel = jax_build(JaxConfig(**small))
    dmodel = build_model(COTRConfig(**small))
    dmodel.load_state_dict(tmodel.state_dict())
    rng = np.random.RandomState(4)
    canvas = random_canvas(rng, 1)
    queries = rng.uniform(0.05, 0.95, (1, 6, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda c, q: jmodel.apply(variables, c, q))(
        canvas, queries))
    with torch.no_grad():
        got = dmodel(torch.from_numpy(canvas),
                     torch.from_numpy(queries)).numpy()
    np.testing.assert_allclose(got, want, atol=INTERMEDIATE_ATOL, rtol=0)


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = 0
        original = attention.flash_cross_attention

        def spy(*args, **kwargs):
            self.calls += 1
            return original(*args, **kwargs)

        monkeypatch.setattr(port_tr, "flash_cross_attention", spy)


def test_routing_rule(monkeypatch):
    """The kernel wrapper is called when there is no mask, dropout is
    inactive and no gradient is wanted; the einsum path otherwise."""
    spy = _Spy(monkeypatch)
    mha = port_tr.MultiHeadAttention(D, H, dropout=0.1)
    rng = np.random.RandomState(6)
    q = torch.from_numpy(rng.randn(1, LQ, D).astype(np.float32))
    kv = torch.from_numpy(rng.randn(1, S, D).astype(np.float32))
    mask = torch.zeros(1, S, dtype=torch.bool)

    mha.eval()
    with torch.no_grad():
        mha(q, kv, kv)
    assert spy.calls == 1
    with torch.inference_mode():
        mha(q, kv, kv)
    assert spy.calls == 2
    with torch.no_grad():
        mha(q, kv, kv, mask)  # a mask
    assert spy.calls == 2
    mha(q, kv, kv)  # eval mode, but the parameters want a gradient
    assert spy.calls == 2
    mha.train()
    with torch.no_grad():
        mha(q, kv, kv)  # dropout active
    assert spy.calls == 2
    mha.dropout = 0.0
    with torch.no_grad():
        mha(q, kv, kv)  # train mode without dropout and without gradient
    assert spy.calls == 3
    for p in mha.parameters():
        p.requires_grad_(False)
    mha(q, kv, kv)  # gradients recorded, but no input requires one
    assert spy.calls == 4
    mha(q.clone().requires_grad_(), kv, kv)
    assert spy.calls == 4


@pytest.mark.parametrize("seed", [0, 1])
def test_remat_gradients_equal_plain_ones_with_dropout(seed):
    """With dropout 0.1 the recomputed forward must draw the first
    forward's keep masks: same generator seed, same gradients, and the
    generator is left where the plain run leaves it."""
    grads, states = {}, {}
    for remat in (False, True):
        tr, src, pos, qe = _transformer(0.1, remat=remat)
        tr.train()
        gen = torch.Generator().manual_seed(seed)
        out = tr.decode(tr.encode(src, pos, generator=gen), pos, qe,
                        generator=gen)
        (out ** 2).sum().backward()
        grads[remat] = {k: p.grad.clone() for k, p in tr.named_parameters()}
        states[remat] = gen.get_state()
    assert torch.equal(states[False], states[True])
    for k, g in grads[False].items():
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(grads[True][k].numpy(), g.numpy(),
                                   atol=1e-6 * float(g.abs().max()), rtol=0,
                                   err_msg=k)
    # another seed gives other gradients: the masks do act
    tr, src, pos, qe = _transformer(0.1, remat=True)
    tr.train()
    gen = torch.Generator().manual_seed(seed + 17)
    out = tr.decode(tr.encode(src, pos, generator=gen), pos, qe,
                    generator=gen)
    (out ** 2).sum().backward()
    key = "enc0.ffn.linear1.weight"
    assert not torch.allclose(tr.get_parameter(key).grad, grads[True][key],
                              atol=1e-6)
