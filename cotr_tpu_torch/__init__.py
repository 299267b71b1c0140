"""cotr_tpu_torch: the PyTorch/CUDA port of cotr_tpu for NVIDIA Hopper.

The JAX package ``cotr_tpu`` is the reference; this package imports nothing
of it and no JAX. Its one hand-written kernel is the fused attention in
``csrc/attention.cu`` (ops/attention.py). Entry points
(``models.checkpoint_io.load_model``,
``models.torch_convert.load_torch_checkpoint``,
``inference.runner.ModelRunner``, ``inference.engine.SparseEngine`` and
``FasterSparseEngine``, ``training.trainer.Trainer``) run on the card unless
the caller passes ``device="cpu"``. The squad engine's greedy squad
formation is host C++ in ``csrc/squads.cpp`` (native.py). Training
(``training/``) takes the differentiable einsum attention: like the TPU
kernel, the CUDA kernels are forward-only. ``data/`` holds the synthetic
homography dataset and the prefetching loader, ``tools/`` the twins of the
JAX package's synthetic training and evaluation tools
(``python -m cotr_tpu_torch.tools.train_synthetic``).
"""

__version__ = "0.1.0"
