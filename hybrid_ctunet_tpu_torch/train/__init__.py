"""Training: LR schedules, optimizers, losses and the train step,
reference-format checkpoints, and the training loop."""
