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
    assert n_modules >= 38, proc.stdout


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
        blocked = ["jax", "jaxlib", "flax", "optax", "orbax", "cotr_tpu"]
        if "--no-pil" in sys.argv:
            blocked.append("PIL")
        if "--no-image-libs" in sys.argv:
            blocked += ["PIL", "imageio", "h5py"]
        if "--no-triton" in sys.argv:
            blocked.append("triton")
        if name.split(".")[0] in blocked:
            raise ImportError("blocked for this test: " + name)

sys.meta_path.insert(0, Block())
if "--no-build" in sys.argv:
    # nvcc and the host compiler run in subprocesses: none may start
    import subprocess
    def no_process(*args, **kwargs):
        raise RuntimeError("a process started: " + repr(args)[:200])
    subprocess.Popen = no_process
import numpy as np
# the MegaDepth slice's run: a generated scene through its modules in turn
megadepth = "--no-image-libs" in sys.argv
for name in sys.argv[1].split(","):
    mod = importlib.import_module(name)
    if name == "cotr_tpu_torch.inference.grouped":
        # run the host side once, native squad formation included
        t = 50
        rng = np.random.RandomState(0)
        loc = np.stack([rng.uniform(0, 300, t), rng.uniform(0, 200, t)], 1)
        sq, pilots = mod.form_squads(loc, loc, np.ones(t, bool), 0.25, 0.25,
                                     (200, 300), (200, 300), 8,
                                     np.random.RandomState(1))
        assert (sq >= 0).all() and len(pilots) >= 1
    if name == "cotr_tpu_torch.inference.triangulate":
        corr = np.random.RandomState(0).uniform(0, 16, (12, 4))
        assert mod.triangulate_corr(corr, (16, 16), (16, 16)).shape == (16, 16, 2)
    if name == "cotr_tpu_torch.inference":
        assert mod.FasterSparseEngine.__mro__[1] is mod.SparseEngine
    if name == "cotr_tpu_torch.training.optim":
        import torch
        w = torch.nn.Parameter(torch.ones(3))
        opt = mod.Optimizer(mod.TrainConfig(), {"transformer.w": w})
        w.grad = torch.ones(3)
        opt.step()
        assert int(opt.count) == 1 and float(w[0]) < 1.0
    if name == "cotr_tpu_torch.training.loss":
        import torch
        assert float(mod.masked_mse(torch.ones(1, 2, 2),
                                    torch.zeros(1, 2, dtype=torch.bool))) == 0.0
    if name == "cotr_tpu_torch.data.synthetic":
        import os, tempfile
        path = os.path.join(tempfile.mkdtemp(), "tex.npy")
        np.save(path, np.random.RandomState(0).randint(
            0, 256, (300, 280, 3)).astype(np.uint8))
        ds = mod.SyntheticHomographyDataset([path], num_kp=8, proc_textures=1,
                                            tex_aug=True)
        assert ds[0]["image"].shape == (256, 512, 3)
        assert ds[1]["image"].dtype == np.uint8
    if name == "cotr_tpu_torch.tools.eval_synthetic_pair":
        img = np.random.RandomState(0).randint(0, 256, (40, 40, 3))
        h, b = mod.warp_for_seed(img.astype(np.uint8), 0, 0.15, "cpu")
        assert b.shape == (40, 40, 3) and h.shape == (3, 3)
    if name == "cotr_tpu_torch.tools.generated_scene" and megadepth:
        import json, os, tempfile
        root = tempfile.mkdtemp()
        config = mod.make_scene(root, views=4, height=48, width=64,
                                val_views=2)
        with open(config) as f:
            raw = json.load(f)
    if name == "cotr_tpu_torch.data.dataset" and megadepth:
        from cotr_tpu_torch.data.megadepth import DataConfig
        cfg = DataConfig(scenes_name_list=raw["scenes_name_list"],
                         valid_list_json=raw["valid_list_json"],
                         train_json=raw["train_json"],
                         val_json=raw["val_json"], num_kp=8)
        host = mod.CotrDataset(cfg, "train")[0]
        cand = mod.CotrDataset(cfg, "train", device_synth=True)[1]
        zoom_cfg = DataConfig(**dict(cfg.__dict__, crop_cam="no_crop",
                                     need_rotation=True, max_rotation=10.0,
                                     rotation_chance=1.0))
        zoom = mod.CotrZoomDataset(zoom_cfg, "train")[2]
        assert host["image"].shape == zoom["image"].shape == (256, 512, 3)
        assert cand["qdepth"].dtype == np.uint16
    if name == "cotr_tpu_torch.data.device_synth" and megadepth:
        import torch
        from cotr_tpu_torch.training.trainer import upload
        batch = {k: upload(v[None], "cpu") for k, v in cand.items()}
        out = mod.synth_supervision_batch(batch, 8,
                                          generator=torch.Generator())
        assert out[1].shape == (1, 16, 2)
    if name == "cotr_tpu_torch.native" and megadepth:
        assert mod.count_valid_depth(np.ones((3, 4), np.float32)) == 12
    if name == "cotr_tpu_torch.tools.eval_megadepth" and megadepth:
        from cotr_tpu_torch.data.megadepth import MegadepthDataset
        ds = MegadepthDataset(mod.data_config(config), "val")
        q, nn = ds.get_query_with_knn(0)
        assert mod.prepare_pair(q, nn[0], 4)[0].shape == (48, 64, 3)
    if name == "cotr_tpu_torch.parallel.opt_shard":
        import torch
        from cotr_tpu_torch.parallel import tp
        from cotr_tpu_torch.parallel.mesh import make_mesh, shard_batch
        from cotr_tpu_torch.config import COTRConfig
        from cotr_tpu_torch.models.cotr import build_model
        model = build_model(COTRConfig(enc_layers=1, dec_layers=1))
        layouts = tp.transformer_param_shardings(model)
        moments = mod.opt_state_shardings(dict(model.named_parameters()),
                                          layouts, {"data": 2, "model": 2},
                                          "data")
        assert {lay.axis for lay in moments.values()} == {"model", "data"}
        mesh = make_mesh(devices=["cpu"] * 2)
        assert len(shard_batch(torch.zeros(4, 1), mesh)) == 2
    if name == "cotr_tpu_torch":
        from cotr_tpu_torch import COTRConfig, build_model
        model = build_model(COTRConfig(enc_layers=1, dec_layers=1))
        assert type(model).__name__ == "COTRModel"
    if name == "cotr_tpu_torch.tools.dryrun_multichip":
        assert mod.uses_tp(4) and not mod.uses_tp(2)
    if name == "cotr_tpu_torch.models.torch_convert":
        assert mod._reference_key("transformer.dec0.cross_attn.k_proj.bias") == (
            "transformer.decoder.layers.0.multihead_attn.in_proj_bias", 1)
    if name == "cotr_tpu_torch.tools.bench_loader":
        import os, tempfile
        cfg = mod.generate_scene(tempfile.mkdtemp(), 4, 24, 32)
        assert os.path.isfile(os.path.join(
            cfg.scenes_name_list[0]["image_dir"], "img_0003.npy.geometric.bin"))
    if name == "cotr_tpu_torch.tools.make_side_by_side":
        import os, tempfile
        from cotr_tpu_torch.demos.demo_utils import read_png, write_png
        path = os.path.join(tempfile.mkdtemp(), "c.png")
        img = np.random.RandomState(0).randint(0, 256, (30, 40, 3))
        write_png(path, mod.composite(img.astype(np.uint8), img[..., 0]
                                      .astype(np.uint8)), text={"a": "b"})
        assert read_png(path).shape == (382, 2 * 480 + 8, 3)
    if name == "cotr_tpu_torch.tools.prepare_nn_distance_mat":
        import torch
        from cotr_tpu_torch.geometry.projector import splat_reprojections
        pts = torch.tensor([[0.0, 0.0, 2.0], [0.01, 0.0, 3.0]],
                           dtype=torch.float64)
        k = torch.tensor([[[4.0, 0, 3.3, 0], [0, 4.0, 2.2, 0], [0, 0, 1, 0]]],
                         dtype=torch.float64)
        assert float(splat_reprojections(pts, k, (5, 7))[0, 2, 3]) == 3.0
    print("imported", name)
"""


def _run_blocked(module, *flags):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    site_dirs = [p for p in sys.path if p.endswith("-packages")]
    env["PYTHONPATH"] = os.pathsep.join([_ROOT] + site_dirs)
    return subprocess.run([sys.executable, "-S", "-c", _BLOCKED_PROBE,
                           module, *flags], env=env, cwd=_ROOT,
                          capture_output=True, text=True, timeout=180)


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


#: the synthetic training slice, blocked the same way and without PIL:
#: the card's machine has none, so textures come as .npy files
_SYNTHETIC_MODULES = ["cotr_tpu_torch.data",
                      "cotr_tpu_torch.data.dataset",
                      "cotr_tpu_torch.data.synthetic",
                      "cotr_tpu_torch.data.loader",
                      "cotr_tpu_torch.ops.geometry_cv",
                      "cotr_tpu_torch.utils.misc",
                      "cotr_tpu_torch.utils.profiling",
                      "cotr_tpu_torch.tools.train_synthetic",
                      "cotr_tpu_torch.tools.eval_synthetic_pair"]


def test_synthetic_modules_import_and_run_with_jax_pil_and_cotr_tpu_blocked():
    proc = _run_blocked(",".join(_SYNTHETIC_MODULES), "--no-pil")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for module in _SYNTHETIC_MODULES:
        assert f"imported {module}" in proc.stdout


#: the MegaDepth slice, blocked the same way and without PIL, imageio and
#: h5py: the card's machine has none of them, so images are .npy and depths
#: COLMAP .bin there. The scene is generated, read, sampled in all three
#: dataset layouts and synthesized on the CPU.
_MEGADEPTH_MODULES = ["cotr_tpu_torch.geometry",
                      "cotr_tpu_torch.geometry.transforms",
                      "cotr_tpu_torch.geometry.camera",
                      "cotr_tpu_torch.geometry.projector",
                      "cotr_tpu_torch.geometry.capture",
                      "cotr_tpu_torch.native",
                      "cotr_tpu_torch.tools.generated_scene",
                      "cotr_tpu_torch.data.colmap",
                      "cotr_tpu_torch.data.scenes",
                      "cotr_tpu_torch.data.megadepth",
                      "cotr_tpu_torch.data.dataset",
                      "cotr_tpu_torch.data.device_synth",
                      "cotr_tpu_torch.training.train_step",
                      "cotr_tpu_torch.tools.train_cotr",
                      "cotr_tpu_torch.tools.eval_megadepth"]


def test_megadepth_modules_import_and_run_with_jax_and_image_libs_blocked():
    proc = _run_blocked(",".join(_MEGADEPTH_MODULES), "--no-image-libs")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for module in _MEGADEPTH_MODULES:
        assert f"imported {module}" in proc.stdout


#: the parallelism slice and its two tools, blocked the same way; a local
#: mesh splits a batch and the layouts of a 1 + 1 model are computed
_PARALLEL_MODULES = ["cotr_tpu_torch.parallel",
                     "cotr_tpu_torch.parallel.mesh",
                     "cotr_tpu_torch.parallel.tp",
                     "cotr_tpu_torch.parallel.opt_shard",
                     "cotr_tpu_torch.tools.bench_sharded",
                     "cotr_tpu_torch.tools.dryrun_multichip"]


def test_parallel_modules_import_and_run_with_jax_and_cotr_tpu_blocked():
    proc = _run_blocked(",".join(_PARALLEL_MODULES), "--no-pil")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for module in _PARALLEL_MODULES:
        assert f"imported {module}" in proc.stdout


def test_the_block_really_blocks():
    proc = _run_blocked("cotr_tpu.inference.grouped")
    assert proc.returncode != 0
    assert "blocked for this test" in proc.stderr
    proc = _run_blocked("PIL.Image", "--no-pil")
    assert proc.returncode != 0
    assert "blocked for this test" in proc.stderr
    for module in ("PIL", "imageio", "h5py"):
        proc = _run_blocked(module, "--no-image-libs")
        assert proc.returncode != 0
        assert "blocked for this test" in proc.stderr


#: the last tools (triage, loader bench, generated-scene training, the kNN
#: overlap matrix, goldens and side by side), blocked the same way and
#: without PIL, imageio and h5py; a scene is written in the card's formats,
#: a side-by-side picture composed and read back, and the splat run
_TOOL_MODULES = ["cotr_tpu_torch.utils.profiling",
                 "cotr_tpu_torch.tools.triage_dense",
                 "cotr_tpu_torch.tools.triage_multipair",
                 "cotr_tpu_torch.tools.triage_guided",
                 "cotr_tpu_torch.tools.bench_loader",
                 "cotr_tpu_torch.tools.run_generated_training",
                 "cotr_tpu_torch.tools.prepare_nn_distance_mat",
                 "cotr_tpu_torch.tools.make_demo_goldens",
                 "cotr_tpu_torch.tools.make_side_by_side"]


def test_tool_modules_import_and_run_with_jax_and_image_libs_blocked():
    proc = _run_blocked(",".join(_TOOL_MODULES), "--no-image-libs")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for module in _TOOL_MODULES:
        assert f"imported {module}" in proc.stdout


#: the package and each subpackage, now that their __init__ files export
#: the JAX package's names: blocked the same way and without PIL, imageio,
#: h5py and triton (the kernels import triton, if ever, when they launch),
#: and with no process started (no nvcc or host compiler runs on import);
#: the top-level exports build a model
_PACKAGES = ["cotr_tpu_torch", "cotr_tpu_torch.models",
             "cotr_tpu_torch.training", "cotr_tpu_torch.data",
             "cotr_tpu_torch.ops", "cotr_tpu_torch.utils",
             "cotr_tpu_torch.inference", "cotr_tpu_torch.geometry",
             "cotr_tpu_torch.parallel"]


def test_packages_import_with_jax_image_libs_and_triton_blocked():
    proc = _run_blocked(",".join(_PACKAGES), "--no-image-libs",
                        "--no-triton", "--no-build")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for module in _PACKAGES:
        assert f"imported {module}" in proc.stdout
    proc = _run_blocked("triton", "--no-triton")
    assert proc.returncode != 0
    assert "blocked for this test" in proc.stderr
