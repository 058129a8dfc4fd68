"""Training: the step and the trainer."""
