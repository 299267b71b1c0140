"""The generated-scene training orchestrator's twin
(cotr_tpu_torch/tools/run_generated_training.py) against
tools/run_generated_training.py.

* The stage command lines, recorded from both tools with ``run_stage`` and
  ``subprocess.run`` replaced by recorders that emit ``iter N: loss=...
  val=...`` lines: flag for flag equal, apart from the script (the twin
  runs ``python -m cotr_tpu_torch.tools.<name>``) and the stage weights
  (the port Trainer's ``checkpoint.pt`` where the JAX tool names an Orbax
  directory).
* One real run of the twin on the CPU at 1 + 1 layers, batches of 2
  (``STAGE_BATCHES`` patched) and a small scene: stage 1 killed by SIGTERM
  after its first validation and resumed, stages 2 and 3; the held-out
  evaluation's command is recorded, not run (the eval twin builds the
  flagship's size whatever the stages trained). No process of the run
  outlives it (every process it starts inherits a marker in its
  environment, and none carrying it is left)."""

import json
import os
import sys
import uuid

import numpy as np

from cotr_tpu_torch.tools import bench_loader, run_generated_training as twin

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    sys.path.insert(0, _ROOT)
    try:
        from tools import bench_loader as jax_bench_loader
        from tools import run_generated_training as jax_tool
    finally:
        sys.path.remove(_ROOT)
    return jax_tool, jax_bench_loader


def _recorders(commands, valid_iter):
    """(run_stage, subprocess.run) stand-ins: each records its command and
    makes the run directory the stage would; a stage prints its iterations,
    the first leg of stage 1 up to its preemption."""
    def fake_run_stage(cmd, log_path, kill_after_iter=None):
        commands.append(list(cmd))
        suffix = cmd[cmd.index("--suffix") + 1]
        out_dir = cmd[cmd.index("--out_dir") + 1]
        os.makedirs(os.path.join(out_dir, f"model_suffix:{suffix}",
                                 "checkpoints"), exist_ok=True)
        first = 2 * valid_iter if "--resume" in cmd else valid_iter
        lines = [f"iter {first}: loss=0.5 val=0.25",
                 f"iter {first + valid_iter}: loss=0.4 val=nan"]
        if kill_after_iter is not None:
            lines = lines[:1]
        iters = [(int(l.split()[1][:-1]), float(l.split("=")[1].split()[0]),
                  float(l.split("=")[2])) for l in lines]
        return 0, iters

    class Done:
        returncode = 0

    def fake_run(cmd, **kw):
        commands.append(list(cmd))
        with open(cmd[cmd.index("--out") + 1], "w") as f:
            json.dump({"epe_median": 1.5}, f)
        return Done()

    return fake_run_stage, fake_run


def _normalized(cmd, script_len):
    """The flags of a stage command, the stage weights' file suffix off."""
    flags = cmd[script_len:]
    return [f[:-len(".pt")] if f.endswith("checkpoint.pt") else f
            for f in flags]


def test_stage_commands_match_the_jax_tool(tmp_path, monkeypatch):
    jax_tool, jax_bench_loader = _jax_tool()
    valid_iter = 7
    argv = ["--root", str(tmp_path / "scenes"), "--train_caps", "4",
            "--val_caps", "2", "--stage1_iters", "30", "--stage2_iters",
            "20", "--stage3_iters", "10", "--valid_iter", str(valid_iter),
            "--init_weights", str(tmp_path / "w.npz"), "--enc_layers", "2"]
    recorded = {}
    for name, mod, loader in [("jax", jax_tool, jax_bench_loader),
                              ("port", twin, bench_loader)]:
        commands = recorded[name] = []
        run_stage, run = _recorders(commands, valid_iter)
        monkeypatch.setattr(mod, "run_stage", run_stage)
        monkeypatch.setattr(mod.subprocess, "run", run)
        monkeypatch.setattr(loader, "generate_scene", lambda root, *a, **k:
                            os.makedirs(root, exist_ok=True))
        out = ["--out", str(tmp_path / "out")]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["run.py", *argv, *out])
            jax_tool.main()
        else:
            summary = twin.main(argv + out)
            assert summary["stages"]["stage1"]["resume_proof"] == {
                "preempted_at": valid_iter,
                "resumed_first_val": 2 * valid_iter}
            assert summary["heldout_eval"] == {"epe_median": 1.5}
        monkeypatch.undo()
    jax_cmds, port_cmds = recorded["jax"], recorded["port"]
    assert len(jax_cmds) == len(port_cmds) == 5
    py = sys.executable
    for want, got in zip(jax_cmds, port_cmds):
        assert want[:2] == [py, "-u"] and got[:3] == [py, "-u", "-m"]
        assert got[3] in ("cotr_tpu_torch.tools.train_cotr",
                          "cotr_tpu_torch.tools.eval_megadepth")
        assert os.path.basename(want[2]) == got[3].split(".")[-1] + ".py"
        assert _normalized(got, 4) == _normalized(want, 3)
    assert "--resume" in port_cmds[1] and "--device_synth" in port_cmds[0]
    assert port_cmds[2][port_cmds[2].index("--load_weights_path") + 1] \
        .endswith("suffix:gen1/checkpoints/checkpoint.pt")


def _processes_with(marker: str) -> list:
    """The pids of live processes whose environment holds ``marker``."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if marker.encode() in f.read():
                    with open(f"/proc/{pid}/stat") as s:
                        if s.read().split(") ")[-1][0] != "Z":
                            found.append(int(pid))
        except OSError:
            continue
    return found


def test_orchestrator_runs_on_the_cpu_with_a_resume(tmp_path, monkeypatch):
    marker = f"COTR_RUN_MARK={uuid.uuid4().hex}"
    key, value = marker.split("=")
    monkeypatch.setenv(key, value)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setattr(twin, "STAGE_BATCHES", (2, 2, 2))
    evals = []
    monkeypatch.setattr(twin.subprocess, "run", _recorders(evals, 2)[1])
    summary = twin.main(
        ["--root", str(tmp_path / "scenes"), "--out", str(tmp_path / "out"),
         "--train_caps", "16", "--val_caps", "2", "--height", "96",
         "--width", "128", "--stage1_iters", "2", "--stage2_iters", "1",
         "--stage3_iters", "1", "--valid_iter", "1", "--dtype", "float32",
         "--enc_layers", "1", "--dec_layers", "1"], device="cpu")
    stage1 = summary["stages"]["stage1"]
    assert stage1["resume_proof"] == {"preempted_at": 1,
                                      "resumed_first_val": 2}
    assert [i[0] for i in stage1["iters_leg_b"]] == [2]
    for stage in ("stage2", "stage3"):
        assert [i[0] for i in summary["stages"][stage]["iters"]] == [1]
        assert all(np.isfinite(i[1]) for i in summary["stages"][stage][
            "iters"])
    assert summary["heldout_eval"] == {"epe_median": 1.5}
    (cmd,) = evals
    assert cmd[cmd.index("--load_weights_path") + 1].endswith(
        "suffix:gen3/checkpoints/checkpoint.pt")
    assert os.path.isfile(cmd[cmd.index("--load_weights_path") + 1])
    with open(tmp_path / "out" / "summary.json") as f:
        assert json.load(f)["stages"]["stage1"]["resume_proof"][
            "preempted_at"] == 1
    for suffix in ("gen1", "gen2", "gen3"):
        runs = [d for d in os.listdir(tmp_path / "out" / "runs")
                if d.endswith(f"suffix:{suffix}")]
        assert len(runs) == 1 and os.path.isfile(
            tmp_path / "out" / "runs" / runs[0] / "checkpoints" /
            "checkpoint.pt")
    assert _processes_with(marker) == []
