"""Training: the cycle loss, the Adam groups with the non-finite-step skip,
the train and evaluation steps, and the Trainer (counterpart of
cotr_tpu/training)."""
