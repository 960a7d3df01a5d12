"""Training: losses, density control, the optimizer and the step."""
