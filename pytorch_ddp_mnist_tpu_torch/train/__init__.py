"""Training: config, the train/eval loop, checkpoints."""
