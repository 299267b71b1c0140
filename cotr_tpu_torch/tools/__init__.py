"""Command-line twins of the JAX package's tools, run as
``python -m cotr_tpu_torch.tools.<name>``."""
