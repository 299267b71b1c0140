"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the measured program."""

import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

from cotr_bench import run

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cotr_tpu"}
SOURCES = sorted(p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("rel", SOURCES)
def test_no_module_imports_jax_or_the_jax_package(rel):
    assert not top_level_imports(BENCH / rel) & FORBIDDEN


@pytest.mark.parametrize("rel", [s for s in SOURCES
                                 if s.startswith("reference/")])
def test_reference_imports_nothing_of_the_program(rel):
    assert not top_level_imports(BENCH / rel) & (FORBIDDEN
                                                 | {"cotr_tpu_torch"})


def test_reference_loads_nothing_of_the_program_at_run_time():
    code = ("import sys, cotr_bench.reference.model, "
            "cotr_bench.reference.crops, cotr_bench.reference.train, "
            "cotr_bench.reference.weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (FORBIDDEN | {"cotr_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cotr_tpu_torch_lookalike",
                        types.ModuleType("cotr_tpu_torch_lookalike"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cotr_tpu.sub",
                        types.ModuleType("cotr_tpu.sub"))
    assert run.forbidden_modules() == ["cotr_tpu"]


def test_a_run_of_the_cell_loads_no_jax():
    """The harness and the program it drives, imported as a run imports
    them, leave no JAX module behind."""
    code = ("import sys; import cotr_bench.run, cotr_bench.drivers, "
            "cotr_bench.check, cotr_bench.trace, cotr_bench.control; "
            "import cotr_tpu_torch.inference.engine, "
            "cotr_tpu_torch.training.train_step; "
            "from pathlib import Path; "
            "from cotr_bench.drivers import load_code; "
            "[load_code(Path('.'), f, n) for f, n in (('entries', "
            "'single_pair'), ('entries', 'multipair'), ('entries', "
            "'cycle'), ('entries', 'train'), ('loops', 'closed'))]; "
            "from cotr_bench.run import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, check=True).stdout
    assert out.strip() == "[]"


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "cotr_bench.run", "--workload",
         "squad_guided.f32", "--seed", str(2 ** 31 + 11), "--seconds", "1",
         "--trace", "0"], cwd=REPO, text=True, capture_output=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    if proc.returncode == 0:
        pytest.fail("a run without a card exited 0")
    assert "CUDA" in proc.stderr
    assert proc.stdout.strip() == ""
