"""The comparison's control on the card, for every cell at its own size,
on three seeds: the program passes the cell's limits, and the reference at
the next lower precision in its place (TF32 for the float32 cells, fp8 for
the bfloat16 one) does not; and the same of the train step at a small size
(the flagship at batch 2, 8 keypoints both ways), held to limits of its
own. About 13 minutes; run on the card with
``python -m pytest -m cuda cotr_bench/tests/test_cotr_bench_card.py``."""

import json

import pytest

from cotr_bench import control
from cotr_bench.tests.tiny import REPO, make_root

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
# Readings of the small train step on SEEDS (program's largest, TF32's
# smallest): loss1_gap 9.9e-5 and 4.1e-3, grad_gap 5.3e-3 and 0.156,
# change_gap 0.028 and 0.098. The first step's loss is a mean over 32
# predictions here and reads up to 33 times its largest at batch 24
# (3.0e-6), so the cell's own limit (2e-5) does not hold at this size.
SMALL_TRAIN_LIMITS = {"loss1_gap": 1e-3, "grad_gap": 0.05,
                      "change_gap": 0.06}
CELLS = [("squad_guided.f32", "tf32"), ("squad_multipair.bf16", "fp8"),
         ("train_b24.f32", "tf32"), ("scan_cycle.f32", "tf32")]


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload,lower", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_program_passes_and_lower_precision_fails(card, workload, lower,
                                                  seed):
    out = control.readings(REPO, workload, seed, 0.0, lower, device=card)
    assert out["correct"], out
    assert not out["control_correct"], out


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_small_train_step_within_its_own_limits(card, tmp_path, seed):
    root = make_root(tmp_path, entries=("train",), flagship=True)
    (root / "cotr_bench" / "limits" / "small.train.json").write_text(
        json.dumps(SMALL_TRAIN_LIMITS))
    out = control.readings(root, "small.train", seed, 0.0, "tf32",
                           device=card)
    assert out["correct"], out
    assert not out["control_correct"], out
