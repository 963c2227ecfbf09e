"""Training of both stages: optimizer, train and eval steps, the training
loops, checkpoints, experiment tracking, and rebuilding a model from a run
directory (runload)."""
