"""cotr_tpu_torch: the PyTorch/CUDA port of cotr_tpu for NVIDIA Hopper.

The JAX package ``cotr_tpu`` is the reference; this package imports nothing
of it and no JAX. Its one hand-written kernel is the fused attention in
``csrc/attention.cu`` (ops/attention.py). Entry points
(``models.checkpoint_io.load_model``,
``models.torch_convert.load_torch_checkpoint``,
``inference.runner.ModelRunner``, ``inference.engine.SparseEngine`` and
``FasterSparseEngine``, ``training.trainer.Trainer``) run on the card unless
the caller passes ``device="cpu"``. The squad engine's greedy squad
formation and the MegaDepth data path's inner loops are host C++ in
``csrc/squads.cpp`` and ``csrc/depth.cpp`` (native.py). Training
(``training/``) takes the differentiable einsum attention: like the TPU
kernel, the CUDA kernels are forward-only. ``geometry/`` holds the camera
algebra, ``data/`` the synthetic homography dataset, the MegaDepth datasets
(COLMAP scenes, kNN pairs, depth reprojection, supervision synthesized on
the device) and the prefetching loader, ``tools/`` the twins of the JAX
package's training and evaluation scripts
(``python -m cotr_tpu_torch.tools.train_cotr``, ``.eval_megadepth``,
``.train_synthetic``, ``.eval_synthetic_pair``), of its checkpoint and
accuracy tools (``.convert_checkpoint``, ``.publish_flagship``,
``.eval_suite``, ``.diagnose_tail``) and a generator of COLMAP scenes
(``.generated_scene``); ``demos/`` the twins of the six demos
(``python -m cotr_tpu_torch.demos.demo_single_pair``, ``.demo_face``,
``.demo_homography``, ``.demo_guided_matching``, ``.demo_reconstruction``,
``.demo_wbs``), which read ``.npy`` images and write PNG pictures without an
image library. ``parallel/`` holds the device meshes: a process mesh inside
a ``torch.distributed`` group, over which the ``Trainer`` is data-parallel
(``torchrun``) and the train step also runs Megatron tensor parallelism and
ZeRO-1, and a local mesh of one process's devices, over which the engines
split their squads and tasks; ``tools/bench_sharded`` and
``tools/dryrun_multichip`` are the twins of the JAX package's sharded
inference bench and multi-device dry run.
"""

from cotr_tpu_torch.config import COTRConfig, InferenceConfig, TrainConfig
from cotr_tpu_torch.models import COTRModel, build_model

__version__ = "0.1.0"

__all__ = [
    "COTRConfig",
    "InferenceConfig",
    "TrainConfig",
    "COTRModel",
    "build_model",
    "__version__",
]
