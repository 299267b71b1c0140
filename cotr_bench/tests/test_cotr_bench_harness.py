"""The harness on the CPU at small sizes: it finds a configuration, a
traffic mix and a metric added as files; a run reaches its result; a
traced run that misses its kernels fails by name; and with the timed path
broken underneath, ``correct`` comes out false."""

import json
import shutil

import pytest
import torch

from cotr_bench import control, pairs, run
from cotr_bench.tests.tiny import REPO, make_root

SEED = 2 ** 31 + 19


@pytest.fixture(scope="module")
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def counted(monkeypatch):
    """The CPU's plain attention counted by shape, as the card's wrapper
    counts its launches."""
    import cotr_tpu_torch.models.transformer as tr
    from cotr_tpu_torch.ops import attention

    plain = tr.flash_cross_attention

    def counting(q, k, v, tile_rows=None):
        attention.launches += 1
        attention.shape_counts[(q.shape[0], q.shape[1], k.shape[1],
                                str(q.dtype).removeprefix("torch."))] += 1
        return plain(q, k, v)

    monkeypatch.setattr(tr, "flash_cross_attention", counting)


@pytest.fixture
def restore_program(monkeypatch):
    """Whatever a fault patches is put back after the test."""
    import cotr_tpu_torch.inference.engine as engine_mod
    import cotr_tpu_torch.inference.refine as refine_mod
    from cotr_tpu_torch.inference.grouped import GroupedStepper
    from cotr_tpu_torch.inference.runner import ModelRunner
    from cotr_tpu_torch.training import optim, train_step

    for obj, name in ((engine_mod, "refine_grouped"),
                      (engine_mod, "refine_grouped_pairs"),
                      (refine_mod, "refine_loop"),
                      (optim.Optimizer, "step"),
                      (GroupedStepper, "_encode_decode"),
                      (ModelRunner, "forward"),
                      (train_step, "batch_views")):
        monkeypatch.setattr(obj, name, getattr(obj, name))


@pytest.fixture(scope="module")
def root(tmp_path_factory, threads):
    return make_root(tmp_path_factory.mktemp("bench"),
                     entries=("single_pair", "multipair", "train"))


def test_new_files_are_found_by_name(tmp_path, threads, counted):
    """Files added to a copy, and entries naming them, are all a new cell
    needs: a configuration, a traffic mix, an entry point, an arrival
    pattern and a metric."""
    base = make_root(tmp_path / "bench", entries=("single_pair",))
    b = base / "cotr_bench"
    shutil.copy(b / "configs" / "small.json", b / "configs" / "added.json")
    traffic = json.loads((b / "traffic" / "small_single_pair.json")
                         .read_text())
    traffic.update(queries=5, entry="added_entry", loop="added_loop")
    (b / "traffic" / "added_mix.json").write_text(json.dumps(traffic))
    (b / "entries" / "added_entry.py").write_text(
        "from pathlib import Path\n"
        "from cotr_bench.drivers import load_code\n"
        "base = load_code(Path(__file__).resolve().parents[2], 'entries',"
        " 'single_pair')\n\n\n"
        "class Driver(base.Driver):\n"
        "    def build(self):\n"
        "        super().build()\n"
        "        (self.ctx.root / 'added_entry_built').write_text('1')\n")
    (b / "loops" / "added_loop.py").write_text(
        "def window(driver, seconds, sync):\n"
        "    n = driver.request(0) + driver.request(1)\n"
        "    sync()\n"
        "    return {'attempted': 2, 'answers': n, 'window_s': 1.0}\n")
    (b / "metrics" / "answers_seen.added.py").write_text(
        "def read(m):\n    return float(m.answers)\n")
    shutil.copy(b / "limits" / "small.single_pair.json",
                b / "limits" / "added.cell.json")
    bench = json.loads((base / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "added", "source": "test",
                             "file": "cotr_bench/configs/added.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "added.cell", "config": "added",
                               "traffic": "added_mix", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "small.single_pair" in m.get("workloads", []):
            m["workloads"].append("added.cell")
    bench["end_to_end"].append({"name": "answers_seen.added", "unit": "corr",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["added.cell"]})
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    result, compared = run.run_cell(base, "added.cell", SEED, 0.0, False,
                                    device="cpu")
    assert (base / "added_entry_built").is_file()
    assert result["attempted"] == 2
    assert result["metrics"]["answers_seen.added"]["value"] == 10.0
    assert result["metrics"]["corr_per_s"]["value"] == 10.0
    assert set(result["metrics"]) >= {"px_err_p50", "setup_s"}
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"
    assert set(compared) == {"seed_gap", "refine_gap_px"}


def test_a_fixed_pool_gives_every_seed_the_same_work(tmp_path, threads,
                                                     counted):
    """With ``pool_seed`` the seed chooses the order of the calls only: one
    pass of the pool reads the same error whatever the seed."""
    base = make_root(tmp_path / "bench", entries=("single_pair",),
                     traffic={"single_pair": {"pool": 3,
                                              "pool_seed": 2 ** 31 + 7}})
    px, orders = [], []
    for seed in (SEED, SEED + 40):
        result, _ = run.run_cell(base, "small.single_pair", seed, 0.0,
                                 False, device="cpu")
        px.append(result["metrics"]["px_err_p50"]["value"])
        orders.append(list(pairs.call_order(seed, 3)))
    assert px[0] == px[1]
    assert orders[0] != orders[1]


@pytest.mark.parametrize("metric,missing", [
    ("canvases_per_corr.squad", "canvas_count"),
    ("seed_share.serve", "cotr_bench.seed"),
    ("idle_share.serve", "not traced"),
    ("px_err_p50", "no answers"),
])
def test_a_reader_without_its_source_fails_by_name(metric, missing):
    m = run.MetricContext(counters={}, spans={}, trace=None, answers=4,
                          window_s=1.0, pool_errors=None)
    with pytest.raises(LookupError, match=missing):
        run.reader(REPO, metric)(m)


def test_traced_run_fails_by_name_without_its_kernels(root, counted):
    with pytest.raises(LookupError, match="attention_kernel_tile"):
        run.run_cell(root, "small.single_pair", SEED, 0.0, True,
                     device="cpu")


def test_multipair_run_is_correct(root, counted):
    result, _ = run.run_cell(root, "small.multipair", SEED + 1, 0.0, False,
                             device="cpu")
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_train_run_is_correct(root):
    result, compared = run.run_cell(root, "small.train", SEED + 2, 0.0,
                                    True, device="cpu")
    assert result["correct"], result["compared"]
    assert set(compared) == {"loss1_gap", "grad_gap", "change_gap"}
    assert "mfu.train" in result["metrics"]
    assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("small.single_pair", "unchanged"),
    ("small.single_pair", "half_batch"),
    ("small.single_pair", "altered"),
    ("small.multipair", "half_batch"),
    ("small.train", "unchanged"),
    ("small.train", "half_batch"),
])
def test_a_broken_timed_path_is_not_correct(root, restore_program, counted,
                                            cell, fault):
    control.install_fault(fault)
    result, compared = run.run_cell(root, cell, SEED + 3, 0.0, False,
                                    device="cpu")
    assert not result["correct"], compared
