"""Evaluation: batched volume forward through the port's kernels."""
