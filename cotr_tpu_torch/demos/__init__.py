"""Twins of the JAX package's demos (``demos/*.py``), one module each:

    python -m cotr_tpu_torch.demos.demo_single_pair [--densify]
    python -m cotr_tpu_torch.demos.demo_face
    python -m cotr_tpu_torch.demos.demo_homography
    python -m cotr_tpu_torch.demos.demo_guided_matching
    python -m cotr_tpu_torch.demos.demo_reconstruction
    python -m cotr_tpu_torch.demos.demo_wbs

Each keeps its JAX script's flags, defaults and printed lines, runs on the
card, and has ``main(argv=None, device="cuda") -> dict`` returning what it
found. Images are read from ``.npy`` arrays, or from image files where
imageio is installed; pictures are written as PNG with numpy and zlib
(``demo_utils``).
"""
