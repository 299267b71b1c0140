"""Inference: the dense seed pass, the zoom refinement (scan and squad),
the engines and the densification of sparse correspondences."""

from cotr_tpu_torch.inference.dense import (dense_flow, full_grid_queries,
                                            merge_flow_patches,
                                            to_square_patches)
from cotr_tpu_torch.inference.engine import (FasterSparseEngine,
                                             SparseEngine,
                                             stretch_to_square)
from cotr_tpu_torch.inference.refine import (BatchRefiner, patch_box,
                                             zoom_schedule)
from cotr_tpu_torch.inference.runner import ModelRunner

__all__ = [
    "dense_flow",
    "full_grid_queries",
    "merge_flow_patches",
    "to_square_patches",
    "FasterSparseEngine",
    "SparseEngine",
    "stretch_to_square",
    "BatchRefiner",
    "patch_box",
    "zoom_schedule",
    "ModelRunner",
]
