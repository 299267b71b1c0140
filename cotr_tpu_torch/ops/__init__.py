"""Ops (counterpart of cotr_tpu/ops): the canvas, bilinear sampling and
crop-and-resize, the attention kernels' wrapper (``attention``, in place of
the JAX package's ``pallas_attention``), dropout and the homography ops."""

from cotr_tpu_torch.ops.canvas import (make_canvas_batch, normalize_canvas,
                                       two_images_side_by_side)
from cotr_tpu_torch.ops.sampling import (crop_and_resize,
                                         crop_and_resize_matmul,
                                         crop_and_resize_window_indexed,
                                         crop_and_resize_windowed,
                                         grid_sample, resize_bilinear)

__all__ = [
    "make_canvas_batch",
    "normalize_canvas",
    "two_images_side_by_side",
    "crop_and_resize",
    "crop_and_resize_matmul",
    "crop_and_resize_window_indexed",
    "crop_and_resize_windowed",
    "grid_sample",
    "resize_bilinear",
]
