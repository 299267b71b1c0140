"""Megatron tensor parallelism with ZeRO-1 over a 2 x 2 (data, model) mesh
of gloo ranks, against the one-process step, as the JAX package holds its
DP x TP step against DP (``tests/test_parallel.py``, 1e-5).

Four ranks (``tests/test_torch_dist_common.tp_scenario``), float64 (see
``test_torch_dist_common.build``): two steps on rows whose cycle-consistent
picks differ between the data ranks; the loss and every trained weight,
gathered from the model shards, within 1e-5 of the one-process step's. Then
an Inf in one model shard's part of a split gradient: the finite-step flag
is reduced over every rank, so all four skip the step.
"""

import numpy as np
import pytest

from tests import test_torch_dist_common as dc
from tests.test_torch_common import few_torch_threads  # noqa: F401

TOL = 1e-5


@pytest.fixture(scope="module")
def tp(tmp_path_factory, few_torch_threads):  # noqa: F811
    return dc.run_ranks("tp_scenario", 4, tmp_path_factory.mktemp("tp"),
                        dc.cycle_batch(dc.build()))


def test_ranks_form_a_two_by_two_mesh_with_half_the_heads(tp):
    assert [r["coordinate"] for r in tp] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # q_proj (out, in) keeps half its output rows: 4 of the 8 heads
    assert all(r["q_proj"] == (128, 256) for r in tp)


def test_moments_split_on_model_and_on_data(tp):
    moments = tp[0]["moments"]
    # 10 split tensors a layer, 2 layers; the rest of the trained tensors
    # (the projection, layer norms, the out/linear2 biases, the head) ZeRO-1
    assert moments["model"] == 20
    assert moments["data"] > 0
    assert all(r["moments"] == moments for r in tp)


def test_dp_x_tp_with_zero1_equals_the_one_process_step(tp):
    ref = tp[0]
    for r in tp:
        np.testing.assert_allclose(r["losses"], ref["ref_losses"], rtol=TOL)
    for k, want in ref["ref_weights"].items():
        for r in tp:
            np.testing.assert_allclose(r["weights"][k].numpy(), want.numpy(),
                                       rtol=0, atol=TOL, err_msg=k)


def test_checkpointed_moments_are_full_on_every_rank(tp):
    state = tp[0]["moments_state"]
    for kind in ("mu", "nu"):
        for k, v in state[kind].items():
            assert tuple(v.shape) == tuple(tp[0]["ref_weights"][k].shape), k
            for r in tp[1:]:
                np.testing.assert_array_equal(
                    r["moments_state"][kind][k].numpy(), v.numpy())


def test_a_non_finite_part_of_a_split_gradient_is_skipped_on_every_rank(tp):
    for r in tp:
        assert r["nan"] == {"count": 2, "total_notfinite": 1,
                            "unchanged": True}
