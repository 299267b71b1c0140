"""The plain reference against the port's plain path on the CPU, at small
sizes: the model (the committed weights, full depth), the crops, the seed
canvases and fields, the training canvas and the train step with its
dropout masks."""

import numpy as np
import pytest
import torch

from cotr_bench.reference import crops as rc
from cotr_bench.reference import weights as rw
from cotr_bench.reference.model import PlainCOTR, round_fp8, round_tf32
from cotr_bench.reference.train import run_steps
from cotr_bench.tests.tiny import REPO, random_weights

FLAGSHIP = REPO / "checkpoints" / "flagship.npz"


@pytest.fixture(scope="module")
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def small(tmp_path_factory, threads):
    """A 1 + 1-layer port model of random weights and its weight file."""
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.models.checkpoint_io import load_model

    path = tmp_path_factory.mktemp("w") / "small.npz"
    random_weights(path)
    cfg = COTRConfig(enc_layers=1, dec_layers=1)
    model = load_model(str(path), cfg, device="cpu")
    w = rw.to_device(rw.read_npz(str(path)), "cpu")
    return model, w, cfg


def test_flagship_forward(threads):
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.models.checkpoint_io import load_model

    model = load_model(str(FLAGSHIP), COTRConfig(), device="cpu").eval()
    ref = PlainCOTR(rw.to_device(rw.read_npz(str(FLAGSHIP)), "cpu"))
    g = torch.Generator().manual_seed(0)
    canvas = torch.randn(1, 256, 512, 3, generator=g)
    queries = torch.rand(1, 16, 2, generator=g) * torch.tensor([0.5, 1.0])
    with torch.no_grad():
        want = model(canvas, queries)
        got = ref(canvas, queries)
    assert (got - want).abs().max() < 1e-4


def test_crop_is_the_ports_pil_crop():
    from cotr_tpu_torch.ops.sampling import crop_and_resize_matmul

    g = torch.Generator().manual_seed(1)
    img = torch.rand(200, 300, 3, generator=g)
    boxes = torch.tensor([[0, 0, 200, 200], [37, 11, 96, 96],
                          [250, 150, 50, 50], [3, 90, 384 // 4, 96]],
                         dtype=torch.float32)
    want = crop_and_resize_matmul(img, boxes, 256)
    for k, box in enumerate(boxes.tolist()):
        assert (rc.crop(img, box) - want[k]).abs().max() < 1e-5


def test_seed_canvases_are_the_ports(threads):
    from cotr_tpu_torch.inference.dense import (_canvases_for_jobs,
                                                to_square_patches)
    from cotr_tpu_torch.inference.runner import ModelRunner

    g = torch.Generator().manual_seed(2)
    a = (torch.rand(96, 128, 3, generator=g) * 255).to(torch.uint8)
    b = (torch.rand(96, 128, 3, generator=g) * 255).to(torch.uint8)
    runner = ModelRunner(torch.nn.Identity(), device="cpu")
    jobs = [(p.patch, q.patch) for p in to_square_patches(a.numpy())
            for q in to_square_patches(b.numpy())]
    want = _canvases_for_jobs(runner, jobs)
    got = rc.seed_canvases(a, b)
    assert got.shape == want.shape == (4, 256, 512, 3)
    assert (got - want).abs().max() < 1e-5


@pytest.mark.parametrize("stride", [1, 8])
def test_dense_field_is_the_ports(small, stride):
    from cotr_tpu_torch.inference.dense import dense_pass_device
    from cotr_tpu_torch.inference.runner import ModelRunner

    model, w, _ = small
    canvas = torch.randn(1, 256, 512, 3,
                         generator=torch.Generator().manual_seed(3))
    want = dense_pass_device(ModelRunner(model, device="cpu"), canvas,
                             stride)
    with torch.no_grad():
        got = rc.dense_field(PlainCOTR(w, enc_layers=1, dec_layers=1),
                             canvas, stride)
    assert got.shape == want.shape
    assert (got - want).abs().max() < 1e-4


def test_training_canvas_is_the_ports():
    from cotr_tpu_torch.ops.canvas import canvas_from_crops_and_homographies

    from cotr_bench import pairs

    b = pairs.make_train_batch(4, 0, {"batch": 2, "num_kp": 8,
                                      "angle_deg": 12.0,
                                      "scale": [0.9, 1.12],
                                      "shift_px": 14.0}, "cpu")
    want = canvas_from_crops_and_homographies(b["crop"], b["h_mat"])
    got = rc.training_canvas(b["crop"], b["h_mat"])
    assert (got - want).abs().max() < 1e-4


def test_train_steps_are_the_ports(small):
    """Two Adam steps with dropout: the same masks, drawn in the same
    order, give the port's losses, gradients and weights."""
    from cotr_tpu_torch.config import TrainConfig
    from cotr_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

    from cotr_bench import check, pairs

    model, w, _ = small
    traffic = {"batch": 2, "num_kp": 8, "angle_deg": 12.0,
               "scale": [0.9, 1.12], "shift_px": 14.0}
    batches = [pairs.make_train_batch(5, i, traffic, "cpu") for i in (0, 1)]
    tcfg = TrainConfig(batch_size=2, num_kp=8)
    state = create_train_state(model, tcfg, device="cpu")
    step = make_train_step(tcfg)
    gen = torch.Generator().manual_seed(123)
    p0 = {n: p.detach().clone() for n, p in state.optimizer.params.items()}
    losses = []
    for i, batch in enumerate(batches):
        state, m = step(state, batch, gen)
        losses.append(float(m["loss"]))
        if i == 0:
            g1 = {check.port_key(n): mu / 0.1
                  for n, mu in state.optimizer.mu.items()}
    ref = run_steps(w, batches, 123, tcfg.learning_rate, 0.1, layers=(1, 1))
    # the first step sees the same weights; later ones weights that differ
    # where Adam's first step turned a gradient's round-off into +-lr
    assert abs(losses[0] - ref["loss"][0]) <= 1e-6 * abs(ref["loss"][0])
    assert np.allclose(losses, ref["loss"], rtol=1e-3)
    assert set(g1) == set(ref["grad"])
    # a leaf against its own size or the median leaf's: a key's bias has a
    # gradient of round-off alone
    median = float(np.median([g.abs().max() for g in ref["grad"].values()]))
    for k, g in ref["grad"].items():
        got = g1[k].reshape(-1)
        want = g.t().reshape(-1) if g.dim() == 2 else g.reshape(-1)
        assert (got - want).abs().max() <= 1e-4 * max(
            float(want.abs().max()), median)
    norms = {k: float(g.norm()) for k, g in ref["grad"].items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    for n, p in state.optimizer.params.items():
        k = check.port_key(n)
        if norms[k] < floor:  # moved by round-off alone
            continue
        change = (p.detach() - p0[n]).norm()
        assert abs(change - (ref["params"][k] - w[k]).norm()) \
            <= 1e-2 * change + 1e-9


def test_lower_precisions_round_as_stated():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(6))
    t = round_tf32(x)
    bits = t.view(torch.int32)
    assert (bits & 0x1FFF).eq(0).all()
    assert ((t - x).abs() <= x.abs() * 2 ** -11 + 1e-30).all()
    f = round_fp8(x)
    scale = 448.0 / x.abs().max()
    assert ((f - x).abs() <= x.abs() * 2 ** -4 + 2 ** -9 / scale).all()
    assert (f - x).abs().max() > (t - x).abs().max()
