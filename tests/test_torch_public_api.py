"""The port's public API against the JAX package's.

Every public function and class of every ``cotr_tpu`` module has a twin of
the same name in the same module of ``cotr_tpu_torch``, with the JAX
parameter names, order and defaults, or it stands in ``BY_DESIGN`` with the
reason; parameters the port adds after the JAX ones are listed in
``EXTRAS``. Every name of a JAX ``__all__`` imports from the twin package.

The twins added last are held against the JAX functions on the same inputs:
``dense_pass`` (identity stub and a small real model), ``warp_by_flow``,
``grid_sample``'s ``align_corners``, ``resize_bilinear``'s ``antialias``,
``crop_and_resize`` (and PIL), ``trace``, both engines built in the JAX
keyword and positional forms, and ``BatchRefiner`` in the JAX form on padded
images.
"""

import glob
import importlib
import inspect
import json
import os

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from cotr_tpu.inference import dense as jdense
from cotr_tpu.inference.engine import FasterSparseEngine as JaxFaster
from cotr_tpu.inference.engine import SparseEngine as JaxEngine
from cotr_tpu.inference.refine import BatchRefiner as JaxRefiner
from cotr_tpu.inference.runner import ModelRunner as JaxRunner
from cotr_tpu.ops import sampling as jsamp
from cotr_tpu_torch.inference import (BatchRefiner, FasterSparseEngine,
                                      SparseEngine, dense_pass,
                                      warp_by_flow)
from cotr_tpu_torch.inference.runner import ModelRunner
from cotr_tpu_torch.ops import sampling
from cotr_tpu_torch.utils.profiling import trace
from tests.test_torch_common import (JaxIdentityRunner, TorchIdentityRunner,
                                     small_models, smooth_image)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FLAX_MODULE = ("a Flax module: its dataclass fields (dtype, use_flash, "
                "parent, name) and train/deterministic flags have no torch "
                "counterpart; the nn.Module keeps its dtype in its "
                "parameters, picks the attention path from the tensors' "
                "device, and takes dropout from module.train() and a "
                "torch.Generator")
_FLAX_SETUP = ("Flax's lazy submodule hook; an nn.Module builds its "
               "submodules in __init__")
_PARAMS_RNGS = ("the training API takes the nn.Module, which holds its "
                "weights, in place of the Flax (model, params) pair, and a "
                "torch.Generator in place of rngs/rng keys")
_LAYOUTS = ("torch.distributed layouts (parallel.mesh.Layout) over named "
            "parameters, in place of jax.sharding trees over a jax Mesh")

#: JAX names (module-relative "module.name" or "module.Class.method") that
#: the port does not mirror as they are: (the port's counterpart or None,
#: the reason)
BY_DESIGN = {
    # names with no twin of that name
    "models.resnet.StemConv": (
        None, "the TPU stem as a 2x2 space-to-depth 4x4 conv, for lane "
        "occupancy; the port's stem is cuDNN's plain 7x7/s2 conv on the "
        "same weights"),
    "models.transformer.matmul_precision": (
        None, "a jax.lax.Precision for XLA's matmuls; the port turns TF32 "
        "off for a float32 model instead"),
    "models.torch_convert.torch_state_dict_to_flax": (
        "models.torch_convert.torch_state_dict_to_port",
        "the port's model is a torch state_dict, not a Flax tree"),
    "models.torch_convert.flax_to_torch_state_dict": (
        "models.torch_convert.port_to_torch_state_dict",
        "the port's model is a torch state_dict, not a Flax tree"),
    "parallel.opt_shard.shard_opt_state": (
        "parallel.opt_shard.opt_state_shardings",
        "jax.device_put of an optax state; the port's Optimizer places "
        "its moments by their layouts itself"),
    "inference.refine.RefineState": (
        None, "the lax.scan carry; refine_loop keeps it in local tensors"),
    "data.device_synth.dequantize_depth_jnp": (
        "data.device_synth.dequantize_depth", "the torch twin of a jnp "
        "function drops the suffix"),
    "geometry.projector.project_points_jnp": (
        "geometry.projector.project_points", "the torch twin of a jnp "
        "function drops the suffix"),
    "geometry.projector.unproject_depth_jnp": (
        "geometry.projector.unproject_depth", "the torch twin of a jnp "
        "function drops the suffix"),
    "ops.pallas_attention.flash_cross_attention": (
        "ops.attention.flash_cross_attention", "the Pallas TPU kernel's "
        "twin wraps the CUDA kernels of csrc/attention.cu"),
    "native.available": (
        None, "the port builds its native code or raises; it has no "
        "pure-Python fallback to report"),
    # twins whose signatures differ
    "inference.runner.ModelRunner": (
        "inference.runner.ModelRunner", "(model, device, decode_chunk): "
        "the nn.Module holds its weights, and the runner puts it on the "
        "card unless the caller asks for the CPU"),
    "models.checkpoint_io.save_params_npz": (
        "models.checkpoint_io.save_params_npz", "takes the model or its "
        "state_dict where the JAX package takes a params tree"),
    "models.checkpoint_io.load_params": (
        "models.checkpoint_io.load_params", "cfg may be left out (the "
        "flagship's COTRConfig()); every JAX call works unchanged"),
    "models.torch_convert.load_torch_checkpoint": (
        "models.torch_convert.load_torch_checkpoint", "cfg may be left out "
        "(COTRConfig()), and the model comes back on a device"),
    "native.parse_images_txt": (
        "native.parse_images_txt", "max_images defaults to every image of "
        "the file, where the JAX package stops at 100,000"),
    "models.cotr.CorrHead": ("models.cotr.CorrHead", _FLAX_MODULE),
    "models.cotr.COTRModel": ("models.cotr.COTRModel", _FLAX_MODULE),
    "models.cotr.COTRModel.setup": (None, _FLAX_SETUP),
    "models.cotr.COTRModel.encode": ("models.cotr.COTRModel.encode",
                                     _FLAX_MODULE),
    "models.cotr.COTRModel.decode": ("models.cotr.COTRModel.decode",
                                     _FLAX_MODULE),
    "models.resnet.FrozenBatchNorm": ("models.resnet.FrozenBatchNorm",
                                      _FLAX_MODULE),
    "models.resnet.Bottleneck": (
        "models.resnet.Bottleneck", _FLAX_MODULE + "; an nn.Module also "
        "needs its input channels (cin) to build its first conv"),
    "models.resnet.ResNet": (
        "models.resnet.ResNet", _FLAX_MODULE + "; name_variant is variant "
        "(Flax reserves name)"),
    "models.resnet.SplitCanvasBackbone": (
        "models.resnet.SplitCanvasBackbone", _FLAX_MODULE + "; "
        "name_variant is variant"),
    "models.transformer.MultiHeadAttention": (
        "models.transformer.MultiHeadAttention", _FLAX_MODULE),
    "models.transformer.FFN": ("models.transformer.FFN", _FLAX_MODULE),
    "models.transformer.EncoderLayer": ("models.transformer.EncoderLayer",
                                        _FLAX_MODULE),
    "models.transformer.DecoderLayer": ("models.transformer.DecoderLayer",
                                        _FLAX_MODULE),
    "models.transformer.Transformer": ("models.transformer.Transformer",
                                       _FLAX_MODULE),
    "models.transformer.Transformer.setup": (None, _FLAX_SETUP),
    "models.transformer.Transformer.encode": (
        "models.transformer.Transformer.encode", _FLAX_MODULE),
    "models.transformer.Transformer.decode": (
        "models.transformer.Transformer.decode", _FLAX_MODULE),
    "parallel.opt_shard.opt_state_shardings": (
        "parallel.opt_shard.opt_state_shardings", _LAYOUTS),
    "parallel.tp.transformer_param_shardings": (
        "parallel.tp.transformer_param_shardings", _LAYOUTS),
    "training.loss.cotr_loss": ("training.loss.cotr_loss", _PARAMS_RNGS),
    "training.optim.param_labels": ("training.optim.param_labels",
                                    _PARAMS_RNGS),
    "training.optim.build_optimizer": (
        "training.optim.build_optimizer", _PARAMS_RNGS + "; the optimizer "
        "is built over the model's parameters, with their layouts"),
    "training.train_step.TrainState": (
        "training.train_step.TrainState", "(step, model, optimizer): the "
        "model holds the parameters and the Optimizer its moments"),
    "training.train_step.create_train_state": (
        "training.train_step.create_train_state", _PARAMS_RNGS + "; no "
        "sample batch is needed to build torch weights"),
    "training.train_step.make_train_step": (
        "training.train_step.make_train_step", _PARAMS_RNGS + "; the step "
        "reads the model and optimizer from its TrainState"),
    "training.train_step.make_eval_step": (
        "training.train_step.make_eval_step", _PARAMS_RNGS),
    "training.trainer.Trainer": (
        "training.trainer.Trainer", "takes a device, and builds its process "
        "mesh from the torch.distributed group (the mesh argument's role); "
        "zero1_axis turns on ZeRO-1"),
    "training.trainer.Trainer.initialize": (
        "training.trainer.Trainer.initialize", "no sample batch: torch "
        "weights need no shape trace"),
}

#: parameters the port adds after the JAX ones (each with a default)
EXTRAS = {
    "data.dataset.compute_corrs": ("impl",),
    "data.device_synth.synth_supervision_batch": ("scores", "generator"),
    "data.loader.PrefetchLoader": ("shard",),
    "inference.dense.warp_by_flow": ("device",),
    "inference.grouped.form_squads": ("impl",),
    "ops.geometry_cv.find_fundamental_ransac": ("device",),
    "parallel.mesh.make_mesh": ("devices",),
    "parallel.mesh.replicate": ("home",),
    "training.train_step.batch_views": ("generator",),
}

#: JAX modules, module-relative ("inference.engine"; "native" for the
#: package cotr_tpu/native)
JAX_MODULES = sorted(
    os.path.relpath(p, os.path.join(_ROOT, "cotr_tpu"))[:-3]
    .replace(os.sep, ".").removesuffix(".__init__")
    for p in glob.glob(os.path.join(_ROOT, "cotr_tpu", "**", "*.py"),
                       recursive=True)
    if os.path.basename(p) != "__init__.py"
    or os.path.dirname(p).endswith("native"))

PACKAGES = ["", "data", "geometry", "inference", "models", "ops",
            "parallel", "training", "utils"]


def _module(package: str, rel: str):
    return importlib.import_module(package + ("." + rel if rel else ""))


def _resolve(package: str, qualname: str):
    """The object at module-relative ``qualname`` in ``package``, or None."""
    parts = qualname.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        try:
            obj = _module(package, ".".join(parts[:cut]))
        except ModuleNotFoundError:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr, None)
        return obj
    return None


def _public(module):
    """(qualname within the module, object) of each public function and
    class the module defines, and of each public method of those classes."""
    for name, obj in sorted(vars(module).items()):
        if name.startswith("_") or getattr(obj, "__module__", None) \
                != module.__name__:
            continue
        if inspect.isfunction(obj):
            yield name, obj
        elif inspect.isclass(obj):
            yield name, obj
            for attr in sorted(vars(obj)):
                method = getattr(obj, attr)
                if not attr.startswith("_") and (inspect.isfunction(method)
                                                 or inspect.ismethod(method)):
                    yield f"{name}.{attr}", method


def _default(value) -> str:
    """A default as text, dtypes by name (jnp.float32 and torch.float32
    are both 'float32')."""
    if value is inspect.Parameter.empty:
        return "<required>"
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    if isinstance(value, type):
        try:
            return np.dtype(value).name
        except TypeError:
            pass
    return repr(value)


def _params(obj) -> list:
    return [(p.name, _default(p.default))
            for p in inspect.signature(obj).parameters.values()]


def _check_twin(qual: str, jax_obj, port_obj) -> None:
    """The port's parameters are the JAX ones, in order and with the same
    defaults, then the listed extras, each with a default."""
    assert port_obj is not None, f"{qual} has no twin in cotr_tpu_torch"
    want = _params(jax_obj)
    got = _params(port_obj)
    extras = EXTRAS.get(qual, ())
    assert got[:len(want)] == want, f"{qual}: {got} != {want}"
    assert [name for name, _ in got[len(want):]] == list(extras), \
        f"{qual}: port-only parameters {got[len(want):]}, listed {extras}"
    assert all(d != "<required>" for _, d in got[len(want):]), qual


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_twin_or_a_reason(rel):
    jax_mod = _module("cotr_tpu", rel)
    try:
        port_mod = _module("cotr_tpu_torch", rel)
    except ModuleNotFoundError:
        port_mod = None
    for name, obj in _public(jax_mod):
        qual = f"{rel}.{name}"
        if qual in BY_DESIGN:
            continue
        port_obj = None if port_mod is None else _resolve(
            "cotr_tpu_torch", qual)
        _check_twin(qual, obj, port_obj)


@pytest.mark.parametrize("qual", sorted(BY_DESIGN))
def test_by_design_entries_name_real_differences(qual):
    """Each entry names a JAX object whose twin is missing or differs, and
    its counterpart exists: no entry outlives what it excuses."""
    jax_obj = _resolve("cotr_tpu", qual)
    assert jax_obj is not None, qual
    counterpart, reason = BY_DESIGN[qual]
    assert len(reason) > 20, qual
    port_obj = _resolve("cotr_tpu_torch", qual)
    if port_obj is not None:
        assert _params(port_obj) != _params(jax_obj), \
            f"{qual} now matches the JAX signature: drop the entry"
    if counterpart is not None:
        assert _resolve("cotr_tpu_torch", counterpart) is not None, \
            counterpart


@pytest.mark.parametrize("package", PACKAGES)
def test_every_jax_export_imports_from_the_twin(package):
    """Each name of the JAX package's __all__ is exported by the twin
    package; a by-design name's counterpart is exported in its place."""
    jax_pkg = _module("cotr_tpu", package)
    port_pkg = _module("cotr_tpu_torch", package)
    for name in jax_pkg.__all__:
        obj = getattr(jax_pkg, name)
        home = getattr(obj, "__module__", "") or ""
        qual = home.removeprefix("cotr_tpu.") + "." + name
        if qual in BY_DESIGN:
            counterpart = BY_DESIGN[qual][0]
            assert counterpart.rsplit(".", 1)[1] in port_pkg.__all__, qual
            continue
        assert name in port_pkg.__all__, f"{package}: {name}"
        ns = {}
        exec(f"from {port_pkg.__name__} import {name}", ns)
        assert ns[name] is not None


#: the names whose JAX signatures the port took on last; none of them may
#: be excused in BY_DESIGN
LAST_TWINS = [
    "inference.engine.SparseEngine", "inference.engine.FasterSparseEngine",
    "inference.refine.BatchRefiner", "inference.refine.BatchRefiner.refine",
    "inference.refine.BatchRefiner.prepare_image",
    "inference.dense.dense_pass", "inference.dense.warp_by_flow",
    "ops.sampling.crop_and_resize", "ops.sampling.grid_sample",
    "ops.sampling.resize_bilinear", "utils.profiling.trace"]


def test_last_twins_are_held_to_the_jax_signature():
    """The module walk above checks each of these names' signatures unless
    BY_DESIGN excuses it; none may be excused."""
    assert set(LAST_TWINS).isdisjoint(BY_DESIGN)


# ------------------------------------------------------------- dense pass

@pytest.mark.parametrize("img", [
    np.zeros((256, 256, 3), np.float32),
    smooth_image(np.random.RandomState(5), (300, 300))],
    ids=["zeros-256-float", "smooth-300-uint8"])
def test_dense_pass_identity_stub_matches_jax(img):
    """As tests/test_engine.py's stub test: the flow is the identity and the
    cycle confidence is near 0 inside the border; and the port's fields are
    the JAX package's."""
    corr_a, corr_b = dense_pass(TorchIdentityRunner(), img, img)
    want_a, want_b = jdense.dense_pass(JaxIdentityRunner(), img, img)
    assert corr_a.shape == corr_b.shape == (256, 256, 3)
    np.testing.assert_allclose(corr_a, want_a, atol=1e-6)
    np.testing.assert_allclose(corr_b, want_b, atol=1e-6)
    interior = corr_a[2:-2, 2:-2]
    assert interior[..., 2].max() < 0.02
    ys, xs = np.mgrid[0:256, 0:256]
    np.testing.assert_allclose(interior[..., 0],
                               ((xs / 256.0) * 2 - 1)[2:-2, 2:-2], atol=1e-4)
    np.testing.assert_allclose(interior[..., 1],
                               ((ys / 256.0) * 2 - 1)[2:-2, 2:-2], atol=1e-4)


@pytest.fixture(scope="module")
def small_runners():
    jmodel, variables, tmodel = small_models()
    return JaxRunner(jmodel, variables), ModelRunner(tmodel, device="cpu")


def test_dense_pass_small_model_matches_jax(small_runners):
    """A 2 + 2-layer random model with the JAX weights carried across: one
    canvas, the full 131,072-query grid, the cycle confidence."""
    jrunner, trunner = small_runners
    rng = np.random.RandomState(2)
    img_a = smooth_image(rng, (240, 240))
    img_b = smooth_image(rng, (320, 320))
    got = dense_pass(trunner, img_a, img_b)
    want = jdense.dense_pass(jrunner, img_a, img_b)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (256, 256, 3)
        np.testing.assert_allclose(g, w, atol=1e-4)


# ------------------------------------------------------- sampling options

def _flow(rng, hw) -> np.ndarray:
    """A flow field with a third (confidence) channel, partly out of frame."""
    return rng.uniform(-1.2, 1.2, hw + (3,)).astype(np.float32)


def test_warp_by_flow_matches_jax():
    """On a [0, 1] image: torch's grid_sample and the JAX gather round the
    same float32 sums in another order, an error that grows with the
    values."""
    rng = np.random.RandomState(6)
    img = rng.uniform(0, 1, (40, 50, 3)).astype(np.float32)
    corr = _flow(rng, (30, 35))
    want = np.asarray(jdense.warp_by_flow(img, corr))
    got = warp_by_flow(img, corr, device="cpu")
    assert got.shape == want.shape == (30, 35, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # a tensor is resampled on its own device
    on_device = warp_by_flow(torch.from_numpy(img), torch.from_numpy(corr))
    np.testing.assert_allclose(on_device, want, atol=1e-5)


def test_warp_by_flow_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        warp_by_flow(np.zeros((4, 4, 3)), np.zeros((4, 4, 2)))


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_align_corners_matches_jax(align_corners):
    rng = np.random.RandomState(7)
    img = rng.rand(17, 23, 3).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (9, 11, 2)).astype(np.float32)
    want = np.asarray(jsamp.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                        align_corners=align_corners))
    got = sampling.grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                               align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((300, 420), (256, 256)),
                                          ((768, 768), (256, 256)),
                                          ((100, 137), (256, 256)),
                                          ((64, 128), (300, 200))])
def test_resize_bilinear_without_antialias_matches_jax(in_hw, out_hw):
    img = np.random.RandomState(8).rand(*in_hw, 3).astype(np.float32)
    want = np.asarray(jsamp.resize_bilinear(jnp.asarray(img), out_hw,
                                            antialias=False))
    got = sampling.resize_bilinear(torch.from_numpy(img), out_hw,
                                   antialias=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


# --------------------------------------------------------- crop_and_resize

CROP_BOXES = np.array([[0, 0, 100, 100], [50.5, 20.25, 200, 180],
                       [10, 10, 40, 40], [100.75, 50, 299.25, 249.5],
                       [390, 290, 10, 10], [3.5, 7.25, 1.5, 2.0]],
                      np.float32)


@pytest.mark.parametrize("out_size", [32, 64, 256])
def test_crop_and_resize_matches_jax(out_size):
    img = np.random.RandomState(9).rand(300, 400, 3).astype(np.float32)
    want = np.asarray(jsamp.crop_and_resize(
        jnp.asarray(img), jnp.asarray(CROP_BOXES), out_size))
    got = sampling.crop_and_resize(torch.from_numpy(img), CROP_BOXES,
                                   out_size)
    assert got.shape == (len(CROP_BOXES), out_size, out_size, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # boxes as a tensor, a uint8 image converted on the way
    img8 = (img * 255).astype(np.uint8)
    want8 = np.asarray(jsamp.crop_and_resize(
        jnp.asarray(img8, jnp.float32), jnp.asarray(CROP_BOXES), out_size))
    got8 = sampling.crop_and_resize(torch.from_numpy(img8),
                                    torch.from_numpy(CROP_BOXES), out_size)
    assert got8.dtype == torch.float32
    np.testing.assert_allclose(got8.numpy(), want8, atol=1e-3)


def test_crop_and_resize_identity():
    """As tests/test_ops.py: a crop of the whole image resized to its own
    size is the image."""
    img = np.random.RandomState(3).uniform(0, 1, (32, 32, 3)).astype(
        np.float32)
    out = sampling.crop_and_resize(torch.from_numpy(img),
                                   np.array([[0.0, 0.0, 32.0, 32.0]]), 32)
    np.testing.assert_allclose(out[0].numpy(), img, atol=1e-5)


def test_crop_and_resize_upscale_matches_pil():
    """As tests/test_ops.py: an upscaled crop (no anti-aliasing involved)
    matches PIL's BILINEAR resize of the cropped array."""
    img = np.random.RandomState(4).uniform(0, 255, (64, 64, 1)).astype(
        np.float32)
    ours = sampling.crop_and_resize(torch.from_numpy(img),
                                    np.array([[16.0, 16.0, 32.0, 32.0]]),
                                    128)[0, ..., 0].numpy()
    pil = np.array(PIL.Image.fromarray(img[16:48, 16:48, 0]).resize(
        (128, 128), resample=PIL.Image.BILINEAR))
    np.testing.assert_allclose(ours, pil, atol=1e-2)


# ------------------------------------------------------------------ trace

def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


# ---------------------------------------------------- engines and refiner

@pytest.fixture(scope="module")
def nonsquare_image():
    return smooth_image(np.random.RandomState(7), (200, 300))


#: (batch_size, mode, task_bucket, image_bucket, seed) in the JAX order,
#: then FasterSparseEngine's max_load
JAX_ARGS = (32, "tile", 8, 128, 5)
MAX_LOAD = 16


@pytest.mark.parametrize("form", ["keyword", "positional"])
@pytest.mark.parametrize("faster", [False, True], ids=["scan", "squad"])
def test_engines_take_the_jax_arguments(nonsquare_image, form, faster):
    """Built in the JAX form, each engine puts every argument in its slot
    and gives the JAX engine's answers; the seed drives the random seeding,
    so a seed in another slot would show."""
    names = ("batch_size", "mode", "task_bucket", "image_bucket", "seed")
    args, kwargs = (JAX_ARGS, {}) if form == "positional" else \
        ((), dict(zip(names, JAX_ARGS)))
    if faster:
        args = args + (MAX_LOAD,) if args else ()
        kwargs = kwargs if not kwargs else dict(kwargs, max_load=MAX_LOAD)
    port_cls, jax_cls = (FasterSparseEngine, JaxFaster) if faster else \
        (SparseEngine, JaxEngine)
    port = port_cls(TorchIdentityRunner(), *args, **kwargs)
    ref = jax_cls(JaxIdentityRunner(), *args, **kwargs)
    assert (port.batch_size, port.mode, port.image_bucket,
            port.refiner.bucket) == (32, "tile", 128, 128)
    assert port.crop_dtype == torch.float32
    if faster:
        assert port.max_load == MAX_LOAD
    kw = dict(zoom_ins=[0.5, 0.25], max_corrs=20, return_idx=True,
              return_cycle_error=True)
    got = port.cotr_corr_multiscale_with_cycle_consistency(
        nonsquare_image, nonsquare_image, **kw)
    want = ref.cotr_corr_multiscale_with_cycle_consistency(
        nonsquare_image, nonsquare_image, **kw)
    assert len(got[0]) > 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("build", [
    lambda r: SparseEngine(r, task_bucket=0),
    lambda r: SparseEngine(r, image_bucket=2.5),
    lambda r: FasterSparseEngine(r, task_bucket=-8),
    lambda r: BatchRefiner(r, 0),
    lambda r: BatchRefiner(r, True)],
    ids=["task_bucket-0", "image_bucket-float", "squad-task_bucket-neg",
         "refiner-bucket-0", "refiner-bucket-bool"])
def test_buckets_must_be_positive_ints(build):
    with pytest.raises(ValueError, match="positive int"):
        build(TorchIdentityRunner())


@pytest.mark.parametrize("seed", ["exact", "offset"])
def test_batch_refiner_jax_form_on_padded_images(seed):
    """As tests/test_engine.py's refiner tests: the refiner in the JAX form,
    on the JAX package's padded image and its (h, w), gives JAX's history;
    padding of other content on image B is never read, and the port's own
    unpadded image gives the same. An exact seed stays put."""
    img = smooth_image(np.random.RandomState(11), (300, 420))
    loc_from = np.array([[100.0, 200.0], [400.0, 50.0], [410.0, 290.0],
                         [5.0, 295.0]])
    loc_to0 = loc_from.copy() if seed == "exact" else \
        loc_from + np.array([5.0, -3.0])
    zooms = [0.5, 0.25, 0.0625]
    jref = JaxRefiner(JaxIdentityRunner(), bucket=256)
    pyr, hw = jref.prepare_image(img)
    want = jref.refine(pyr, hw, pyr, hw, loc_from, loc_to0, s_from=1.0,
                       s_to=1.0, zoom_ins=zooms, converge_iters=2)

    refiner = BatchRefiner(TorchIdentityRunner(), 256)
    padded_a = torch.from_numpy(np.array(pyr))
    padded_b = padded_a.clone()
    padded_b[hw[0]:] = 1.0
    padded_b[:, hw[1]:] = 1.0
    got = refiner.refine(padded_a, hw, padded_b, hw, loc_from, loc_to0,
                         1.0, 1.0, zooms, 2)
    own, own_hw = refiner.prepare_image(img)
    assert own_hw == tuple(hw) == (300, 420)
    assert own.shape == (300, 420, 3) and refiner.bucket == 256
    unpadded = refiner.refine(own, own_hw, own, own_hw, loc_from, loc_to0,
                              s_from=1.0, s_to=1.0, zoom_ins=zooms,
                              converge_iters=2)
    assert got.shape == want.shape == (3, 4, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(unpadded, want)
    if seed == "exact":
        for level in got:
            np.testing.assert_allclose(level, loc_from, atol=0.02)


def test_batch_refiner_rejects_an_extent_past_the_image():
    refiner = BatchRefiner(TorchIdentityRunner())
    img = torch.zeros(64, 64, 3)
    with pytest.raises(ValueError, match="does not fit"):
        refiner.refine(img, (65, 64), img, (64, 64), np.zeros((1, 2)),
                       np.zeros((1, 2)), 1.0, 1.0, [0.5])
