"""Training substrate: optimizers, gradient compression, checkpoints and the
training loop (twins of `repro.train`)."""
