"""Training substrate: optimizer, train step, checkpointing, supervision."""
