"""Training: the step, the optimizer pieces, checkpoints and the trainers."""
