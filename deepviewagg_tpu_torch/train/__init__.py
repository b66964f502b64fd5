"""Training: optimizers, schedules and the train / eval step."""
