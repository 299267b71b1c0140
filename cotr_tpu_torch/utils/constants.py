"""Framework-wide constants (copy of cotr_tpu/utils/constants.py).

Each image of a pair is resized to a ``MAX_SIZE`` square and the two squares
sit side by side on one (MAX_SIZE, 2*MAX_SIZE) canvas. Query and target
coordinates are normalized so that x spans [0, 1] across the full
double-wide canvas (left image x in [0, 0.5], right image x in [0.5, 1]) and
y spans [0, 1].
"""

MAX_SIZE = 256
CANVAS_H = MAX_SIZE
CANVAS_W = 2 * MAX_SIZE

#: kNN image retrieval: two captures are neighbours when this share of one
#: reprojects consistently into the other (``data.scenes``)
VALID_NN_OVERLAPPING_THRESH = 0.1

#: ImageNet normalization applied to every canvas before the backbone.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# Inference thresholds of the sparse engine.
THRESHOLD_SPARSE = 0.02
THRESHOLD_PIXELS_RELATIVE = 0.02
BASE_ZOOM = 1.0
THRESHOLD_AREA = 0.02


def zoom_ladder(depth: int):
    """Depth-N zoom-in schedule ending at the finest 0.0625 level: the
    demos' ``np.linspace(0.5, 0.0625, 4)`` over any depth. Depth 1 pins to
    the finest level (``linspace(..., num=1)`` would give the coarse 0.5)."""
    import numpy as np

    if depth < 1:
        raise ValueError(f"zoom depth must be at least 1, got {depth}")
    if depth == 1:
        return [0.0625]
    return [float(z) for z in np.linspace(0.5, 0.0625, depth)]
