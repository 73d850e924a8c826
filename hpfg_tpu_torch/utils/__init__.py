"""Utilities: the JAX-to-port weight mapper and checkpoints."""
