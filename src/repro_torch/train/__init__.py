"""Training substrate: optimizer, train-step factory, data, checkpointing."""
