"""The parallelism tools of the port on the CPU at 1 + 1 depth:
``tools/bench_sharded.py`` (the twin of the JAX package's) on a mesh that
lists the CPU 4 times, and ``tools/dryrun_multichip.py`` (the twin of
``__graft_entry__.dryrun_multichip``) on 4 gloo ranks as 2 x 2 (data, model)
with TP and ZeRO-1, and on 2 as pure data parallelism, as the JAX dry run
picks its layout."""

import json

import pytest

from cotr_tpu_torch.tools import bench_sharded, dryrun_multichip
from tests.test_torch_common import few_torch_threads  # noqa: F401


@pytest.mark.usefixtures("few_torch_threads")
def test_bench_sharded_splits_four_ways_with_equal_outputs(tmp_path):
    out = tmp_path / "sharded.json"
    result = bench_sharded.main(
        ["--enc_layers", "1", "--dec_layers", "1", "--n", "4", "--groups",
         "4", "--members", "2", "--iters", "1", "--out", str(out)],
        device="cpu")
    assert json.loads(out.read_text()) == result
    configs = result["configs"]
    assert result["mesh"] == ["cpu"] * 4
    assert configs["grouped_n1"]["canvases_per_device"] == [4]
    assert configs["grouped_n4"]["canvases_per_device"] == [1] * 4
    assert configs["scan_n1"]["tasks_per_device"] == [8]
    assert configs["scan_n4"]["tasks_per_device"] == [2] * 4
    assert configs["grouped_n4"]["max_abs_dev_vs_n1"] <= \
        bench_sharded.STEPPER_TOL
    assert configs["scan_n4"]["share_within_1px"] == 1.0
    with pytest.raises(ValueError, match="multiple"):
        bench_sharded.main(["--n", "3", "--groups", "4"], device="cpu")


@pytest.mark.parametrize("n,layout", [(4, "dp x tp"), (2, "dp")])
def test_dryrun_multichip_takes_one_full_step(tmp_path, capsys, n, layout):
    out = tmp_path / "dryrun.json"
    report = dryrun_multichip.main(
        ["--n", str(n), "--enc_layers", "1", "--dec_layers", "1", "--out",
         str(out)], device="cpu")
    assert json.loads(out.read_text()) == report
    assert report["ok"] and report["layout"] == layout
    printed = capsys.readouterr().out
    assert f"dryrun_multichip({n}) OK" in printed
    moments = report["moments"]
    if layout == "dp x tp":
        assert report["mesh"] == {"data": 2, "model": 2}
        # mu and nu of the 20 split transformer tensors on "model"; every
        # other trained tensor's moments split over "data" (ZeRO-1)
        assert moments["model"] == 40 and moments["data"] > 0
        assert "on 'model' (TP)" in printed
    else:
        assert report["mesh"] == {"data": 2}
        assert moments["model"] == moments["data"] == 0


def test_dryrun_multichip_refuses_more_ranks_than_cards():
    # here there is no card at all; with fewer cards than ranks it raises
    # ValueError before starting any rank
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip.main(["--n", "2"], device="cuda")


@pytest.mark.usefixtures("few_torch_threads")
def test_train_twin_runs_data_parallel_on_two_ranks(tmp_path):
    """tools/train_synthetic.py's twin on 2 gloo ranks, as torchrun starts
    it, warm-started from a weight file: both ranks end at the same step
    with the same held-out errors, and only rank 0's files exist."""
    import numpy as np

    from cotr_tpu_torch.models.checkpoint_io import save_params_npz
    from tests import test_torch_dist_common as dc

    np.save(tmp_path / "tex0.npy", np.random.RandomState(0).randint(
        0, 256, (300, 280, 3)).astype(np.uint8))
    weights = str(tmp_path / "init.npz")
    save_params_npz(dc.build(seed=4), weights, dtype="float32")
    run = tmp_path / "run"
    argv = ["--steps", "2", "--batch_size", "2", "--enc_layers", "1",
            "--dec_layers", "1", "--num_kp", "8", "--epoch_len", "6",
            "--workers", "1", "--valid_iter", "2", "--lr_backbone", "0",
            "--dtype", "float32", "--proc_textures", "1",
            "--textures", str(tmp_path / "tex*.npy"), "--num_devices", "2",
            "--init_weights", weights, "--out", str(run)]
    ranks = dc.run_ranks("train_synthetic_scenario", 2, tmp_path, argv)
    assert ranks[0] == ranks[1] and ranks[0]["step"] == 2
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == \
        ["checkpoint.pt", "final.pt"]
    assert (run / "params.json").exists()
