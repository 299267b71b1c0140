"""cotr_tpu_torch.training.loss against cotr_tpu.training.loss on the CPU:
values, every parameter's gradient, all three cycle branches and weights.

The JAX side is computed once, under one ``jax.jit``, in a module-scoped
fixture (the ResNet compiles slowly on the CPU). Tolerances, float32 on both
sides: ``loss`` and ``corr_loss`` 1e-5 relative; ``cycle_loss`` 1e-4 relative
(a mean of squares of differences of about 0.02 between coordinates near
0.5, each of which carries 6e-8 of rounding: 1e-5 of the term is that
noise); predictions 1e-4 absolute; each gradient 1e-3 of its tensor's
largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cotr_tpu.training import loss as jax_loss
from cotr_tpu_torch.training import loss as port_loss

from tests.test_torch_common import (assert_tree_close,  # noqa: F401
                                     few_torch_threads, grads_to_port,
                                     random_canvas, small_models)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

LOSS_RTOL = {"loss": 1e-5, "corr_loss": 1e-5, "cycle_loss": 1e-4}
PRED_ATOL = 1e-4
GRAD_RTOL_OF_MAX = 1e-3

#: name -> (cycle_consis, bidirectional, with weights)
CASES = {"bidirectional": (True, True, False),
         "unidirectional": (True, False, False),
         "no_cycle": (False, True, False),
         "weights": (True, True, True)}


def _fixed_points(tmodel, canvas, start, bidirectional, iters=4):
    """Queries near ones that the round trip returns to themselves, found by
    iterating it on the port's model (a freshly drawn model's round trip
    hardly depends on the query, so a few rounds settle it) and stepping 0.02
    aside (the threshold is 0.039): with those among the queries the cycle mask selects something
    and the cycle term is not zero."""
    q = torch.from_numpy(start)
    c = torch.from_numpy(canvas)
    rev = torch.cat([c[:, :, 256:], c[:, :, :256]], dim=2)
    shift = torch.tensor([0.5, 0.0])
    with torch.no_grad():
        for _ in range(iters):
            pred = tmodel(c, q)
            q = (tmodel(c, pred) if bidirectional
                 else tmodel(rev, pred - shift) - shift)
    return q.numpy() + np.float32(0.02 / np.sqrt(2.0))


@pytest.fixture(scope="module")
def both():
    jmodel, variables, tmodel = small_models()
    rng = np.random.RandomState(11)
    canvas = random_canvas(rng, 2)
    start = rng.uniform(0.05, 0.45, (2, 2, 2)).astype(np.float32)
    queries = np.concatenate([
        _fixed_points(tmodel, canvas, start, True),
        _fixed_points(tmodel, canvas, start[:, :1], False),
        rng.uniform(0.05, 0.45, (2, 1, 2)).astype(np.float32)], axis=1)
    targets = rng.uniform(0.55, 0.95, (2, 4, 2)).astype(np.float32)
    weights = np.array([[1, 0, 1, 1], [1, 1, 0.5, 0]], np.float32)

    def one(p, case):
        cyc, bi, with_w = CASES[case]
        return jax_loss.cotr_loss(
            jmodel, {"params": p}, jnp.asarray(canvas), jnp.asarray(queries),
            jnp.asarray(targets), cycle_consis=cyc, bidirectional=bi,
            train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            weights=jnp.asarray(weights) if with_w else None)

    @jax.jit
    def all_cases(p):
        return {case: jax.value_and_grad(one, has_aux=True)(p, case)
                for case in CASES}

    want = jax.device_get(all_cases(variables["params"]))
    return dict(tmodel=tmodel, canvas=canvas, queries=queries,
                targets=targets, weights=weights, want=want)


def _port(both, case):
    cyc, bi, with_w = CASES[case]
    tmodel = both["tmodel"]
    tmodel.train()  # dropout is 0 in the small model
    tmodel.zero_grad()
    loss, metrics = port_loss.cotr_loss(
        tmodel, torch.from_numpy(both["canvas"]),
        torch.from_numpy(both["queries"]), torch.from_numpy(both["targets"]),
        cycle_consis=cyc, bidirectional=bi,
        weights=torch.from_numpy(both["weights"]) if with_w else None)
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    tmodel.eval()
    return metrics, grads


@pytest.mark.parametrize("case", list(CASES))
def test_cotr_loss_values_match_jax(both, case):
    metrics, _ = _port(both, case)
    (_, want), _ = both["want"][case]
    for name in ("loss", "corr_loss", "cycle_loss"):
        np.testing.assert_allclose(float(metrics[name].detach()), float(want[name]),
                                   rtol=LOSS_RTOL[name], atol=0, err_msg=name)
    np.testing.assert_allclose(metrics["pred"].detach().numpy(),
                               np.asarray(want["pred"]), atol=PRED_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(metrics["target"].numpy(), both["targets"])


@pytest.mark.parametrize("case", list(CASES))
def test_cotr_loss_gradients_match_jax_grad(both, case):
    _, grads = _port(both, case)
    _, jax_grads = both["want"][case]
    want = grads_to_port(jax_grads)
    # FrozenBN is a parameter in the JAX package and a buffer in the port
    want = {k: v for k, v in want.items() if k in grads}
    assert len(want) == len(grads)
    assert_tree_close(grads, want, GRAD_RTOL_OF_MAX, f"gradient, {case}")


@pytest.mark.parametrize("case", ["bidirectional", "unidirectional",
                                  "weights"])
def test_cycle_term_is_not_zero(both, case):
    """The fixed-point queries pass the cycle threshold, the others do not:
    the cycle mask selects some pairs and not all."""
    (_, want), _ = both["want"][case]
    assert float(want["cycle_loss"]) > 0.0
    metrics, _ = _port(both, case)
    assert float(metrics["cycle_loss"].detach()) > 0.0


def test_gradient_reaches_the_first_forward_through_the_queries(both):
    """The cycle term's gradient flows through the second forward's query
    embedding into the first forward: detaching ``pred`` changes the
    gradients."""
    _, grads = _port(both, "bidirectional")
    tmodel = both["tmodel"]
    tmodel.zero_grad()
    c, q = torch.from_numpy(both["canvas"]), torch.from_numpy(both["queries"])
    t = torch.from_numpy(both["targets"])
    pred = tmodel(c, q)
    cycle = tmodel(c, pred.detach())
    mask = torch.linalg.norm(cycle - q, dim=-1) < port_loss.CYCLE_THRESH
    loss = ((pred - t) ** 2).mean() \
        + port_loss.masked_mse((cycle - q) ** 2, mask)
    loss.backward()
    key = "corr_embed.fc2.weight"
    detached = tmodel.get_parameter(key).grad.numpy()
    assert np.abs(detached - grads[key]).max() > \
        1e-3 * np.abs(grads[key]).max()


def test_masked_mse_matches_indexing():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 10, 2).astype(np.float32)
    y = rng.randn(4, 10, 2).astype(np.float32)
    mask = rng.rand(4, 10) > 0.5
    got = float(port_loss.masked_mse(torch.from_numpy((x - y) ** 2),
                                     torch.from_numpy(mask)))
    want = float(torch.nn.functional.mse_loss(
        torch.from_numpy(x)[torch.from_numpy(mask)],
        torch.from_numpy(y)[torch.from_numpy(mask)]))
    assert abs(got - want) < 1e-6
    jax_got = float(jax_loss.masked_mse(jnp.asarray((x - y) ** 2),
                                        jnp.asarray(mask)))
    assert abs(got - jax_got) < 1e-6


def test_masked_mse_empty_mask_is_zero_with_zero_gradient():
    x = torch.ones(2, 3, 2, requires_grad=True)
    out = port_loss.masked_mse(x ** 2, torch.zeros(2, 3, dtype=torch.bool))
    assert float(out) == 0.0
    out.backward()
    assert torch.equal(x.grad, torch.zeros_like(x))


def test_cycle_thresh_is_the_jax_value():
    assert port_loss.CYCLE_THRESH == jax_loss.CYCLE_THRESH
