"""Training infrastructure: train-time random generators, optimizers with the
reference's torch.optim semantics, and the train-state containers."""
