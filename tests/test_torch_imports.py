"""The port imports no JAX, Flax, optax, orbax, PIL, ml_dtypes or cotr_tpu
module: the machine with the card has none of them."""

import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import pkgutil, sys, importlib
import cotr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cotr_tpu_torch.__path__,
                                                 "cotr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "ml_dtypes",
          "cotr_tpu")
found = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), found)
sys.exit(1 if found else 0)
"""


def test_port_imports_nothing_of_jax_pil_or_cotr_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    # -S: no site hooks that could preload jax into the interpreter; the
    # installed packages' directory is passed explicitly instead
    site_dirs = [p for p in sys.path if p.endswith("-packages")]
    env["PYTHONPATH"] = os.pathsep.join([_ROOT] + site_dirs)
    proc = subprocess.run([sys.executable, "-S", "-c", _PROBE], env=env,
                          cwd=_ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 27, proc.stdout


#: the squad engine's slice: each imports alone, with the JAX side blocked
#: at the import system, so a lazy import inside a function would show too
#: when the function runs
_SQUAD_MODULES = ["cotr_tpu_torch.native",
                  "cotr_tpu_torch.inference.grouped",
                  "cotr_tpu_torch.inference.triangulate",
                  "cotr_tpu_torch.inference.engine",
                  "cotr_tpu_torch.inference",
                  "cotr_tpu_torch.ops.sampling"]

_BLOCKED_PROBE = """
import importlib, importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "cotr_tpu"):
            raise ImportError("blocked for this test: " + name)

sys.meta_path.insert(0, Block())
import numpy as np
mod = importlib.import_module(sys.argv[1])
if sys.argv[1] == "cotr_tpu_torch.inference.grouped":
    # run the host side once, native squad formation included
    t = 50
    rng = np.random.RandomState(0)
    loc = np.stack([rng.uniform(0, 300, t), rng.uniform(0, 200, t)], 1)
    sq, pilots = mod.form_squads(loc, loc, np.ones(t, bool), 0.25, 0.25,
                                 (200, 300), (200, 300), 8,
                                 np.random.RandomState(1))
    assert (sq >= 0).all() and len(pilots) >= 1
if sys.argv[1] == "cotr_tpu_torch.inference.triangulate":
    corr = np.random.RandomState(0).uniform(0, 16, (12, 4))
    assert mod.triangulate_corr(corr, (16, 16), (16, 16)).shape == (16, 16, 2)
if sys.argv[1] == "cotr_tpu_torch.inference":
    assert mod.FasterSparseEngine.__mro__[1] is mod.SparseEngine
if sys.argv[1] == "cotr_tpu_torch.training.optim":
    import torch
    w = torch.nn.Parameter(torch.ones(3))
    opt = mod.Optimizer(mod.TrainConfig(), {"transformer.w": w})
    w.grad = torch.ones(3)
    opt.step()
    assert int(opt.count) == 1 and float(w[0]) < 1.0
if sys.argv[1] == "cotr_tpu_torch.training.loss":
    import torch
    assert float(mod.masked_mse(torch.ones(1, 2, 2),
                                torch.zeros(1, 2, dtype=torch.bool))) == 0.0
if sys.argv[1] == "cotr_tpu_torch.models.torch_convert":
    assert mod._reference_key("transformer.dec0.cross_attn.k_proj.bias") == (
        "transformer.decoder.layers.0.multihead_attn.in_proj_bias", 1)
print("imported", sys.argv[1])
"""


def _run_blocked(module):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    site_dirs = [p for p in sys.path if p.endswith("-packages")]
    env["PYTHONPATH"] = os.pathsep.join([_ROOT] + site_dirs)
    return subprocess.run([sys.executable, "-S", "-c", _BLOCKED_PROBE,
                           module], env=env, cwd=_ROOT, capture_output=True,
                          text=True, timeout=180)


def test_squad_modules_import_with_jax_flax_and_cotr_tpu_blocked():
    for module in _SQUAD_MODULES:
        proc = _run_blocked(module)
        assert proc.returncode == 0, module + "\n" + proc.stdout + proc.stderr
        assert f"imported {module}" in proc.stdout


#: the training slice, blocked the same way
_TRAINING_MODULES = ["cotr_tpu_torch.training",
                     "cotr_tpu_torch.training.loss",
                     "cotr_tpu_torch.training.optim",
                     "cotr_tpu_torch.training.train_step",
                     "cotr_tpu_torch.training.trainer",
                     "cotr_tpu_torch.training.tb",
                     "cotr_tpu_torch.models.torch_convert",
                     "cotr_tpu_torch.ops.dropout"]


def test_training_modules_import_with_jax_optax_orbax_and_cotr_tpu_blocked():
    for module in _TRAINING_MODULES:
        proc = _run_blocked(module)
        assert proc.returncode == 0, module + "\n" + proc.stdout + proc.stderr
        assert f"imported {module}" in proc.stdout


def test_the_block_really_blocks():
    proc = _run_blocked("cotr_tpu.inference.grouped")
    assert proc.returncode != 0
    assert "blocked for this test" in proc.stderr
