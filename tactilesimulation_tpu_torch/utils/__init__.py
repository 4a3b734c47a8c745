"""Training utilities: running statistics, logging, checkpoints."""
