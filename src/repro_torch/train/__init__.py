"""Training: optimizers, the train step, checkpoints and the resumable loop."""
