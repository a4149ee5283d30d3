"""Training step of the port: trainable subset, optimizer, EMA, step."""
