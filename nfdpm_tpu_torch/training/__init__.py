"""Stage-1 training: optimizer, train and eval steps, the training loop,
checkpoints and experiment tracking."""
