"""Utilities: the JAX-to-port weight mapper."""
