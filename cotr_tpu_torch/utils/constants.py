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

#: ImageNet normalization applied to every canvas before the backbone.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# Inference thresholds of the sparse engine.
THRESHOLD_SPARSE = 0.02
THRESHOLD_PIXELS_RELATIVE = 0.02
BASE_ZOOM = 1.0
THRESHOLD_AREA = 0.02
