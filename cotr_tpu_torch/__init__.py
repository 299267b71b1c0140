"""cotr_tpu_torch: the PyTorch/CUDA port of cotr_tpu for NVIDIA Hopper.

The JAX package ``cotr_tpu`` is the reference; this package imports nothing
of it and no JAX. Its one hand-written kernel is the fused attention in
``csrc/attention.cu`` (ops/attention.py). Entry points
(``models.checkpoint_io.load_model``, ``inference.runner.ModelRunner``,
``inference.engine.SparseEngine`` and ``FasterSparseEngine``) run on the
card unless the caller passes ``device="cpu"``. The squad engine's greedy
squad formation is host C++ in ``csrc/squads.cpp`` (native.py).
"""

__version__ = "0.1.0"
