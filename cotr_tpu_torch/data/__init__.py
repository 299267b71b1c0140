"""Training data on the host (counterpart of cotr_tpu/data): the synthetic
homography dataset, the MegaDepth datasets (``colmap``, ``scenes``,
``megadepth``, ``dataset``, ``device_synth``), the prefetching loader and
the sample helpers. Samples and batches are numpy dicts; ``Trainer``
uploads them."""
