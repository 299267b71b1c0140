"""The benchmark's plain reference of COTR: the model, the crops and seed
fields, and the training step, in plain PyTorch and NumPy. Nothing here
imports the measured program or the JAX package."""
