"""Kernels and their plain versions, losses, ramp-ups and EMA."""
