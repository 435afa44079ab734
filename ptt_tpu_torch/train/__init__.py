"""Training: the optimizer and its schedule, the BatchNorm momentum schedule,
the train step, checkpoints and the epoch loop (the JAX package's ``train/``)."""
