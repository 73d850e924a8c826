"""Segmentation metrics of the volume evaluation (port of the part of
``hpfg_tpu/evals/metrics.py`` that evaluation uses), in numpy and scipy.

  * dice   2|A and B| / (|A| + |B|), medpy's dc
  * hd95   max(P95(d(A->B)), P95(d(B->A))) over connectivity-1 borders,
           distances from a Euclidean distance transform, unit spacing
           (medpy's hd95)
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def _as_binary(x) -> np.ndarray:
    return np.asarray(x) > 0


def binary_dice(pred, gt) -> float:
    """medpy.metric.binary.dc semantics: 0.0 when both sets are empty."""
    pred, gt = _as_binary(pred), _as_binary(gt)
    inter = np.count_nonzero(pred & gt)
    size = np.count_nonzero(pred) + np.count_nonzero(gt)
    if size == 0:
        return 0.0
    return 2.0 * inter / size


def _border(a: np.ndarray) -> np.ndarray:
    """Connectivity-1 border voxels of a binary mask (medpy convention)."""
    footprint = ndimage.generate_binary_structure(a.ndim, 1)
    return a ^ ndimage.binary_erosion(a, structure=footprint, iterations=1)


def _surface_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distances from border voxels of ``a`` to the border of ``b``."""
    a, b = _as_binary(a), _as_binary(b)
    if not a.any() or not b.any():
        raise ValueError("surface distance undefined for empty masks")
    return ndimage.distance_transform_edt(~_border(b))[_border(a)]


def binary_hd95(pred, gt) -> float:
    """95th-percentile symmetric Hausdorff distance (medpy hd95)."""
    d1 = _surface_distances(pred, gt)
    d2 = _surface_distances(gt, pred)
    return float(max(np.percentile(d1, 95), np.percentile(d2, 95)))


def calculate_metric_percase(pred, gt) -> tuple[float, float]:
    """Dice + HD95 for one class with the reference's three-branch rule:
    both non-empty -> (dc, hd95); pred non-empty but gt empty -> (1, 0);
    else -> (0, 0)."""
    pred, gt = _as_binary(pred), _as_binary(gt)
    if pred.sum() > 0 and gt.sum() > 0:
        return binary_dice(pred, gt), binary_hd95(pred, gt)
    if pred.sum() > 0 and gt.sum() == 0:
        return 1.0, 0.0
    return 0.0, 0.0
