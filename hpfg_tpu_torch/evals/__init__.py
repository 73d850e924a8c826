"""Evaluation: batched volume and 2-D image forwards through the port's
kernels, and the segmentation metrics."""
