"""Training: optimizers, algorithms and the trainer loop."""
