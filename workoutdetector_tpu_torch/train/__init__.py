"""Training: optimizer policies, checkpoints, loggers, the trainer."""
