"""Segmentation metrics (port of ``hpfg_tpu/evals/metrics.py``), in numpy
and scipy, with medpy's definitions:

  * dice     2|A and B| / (|A| + |B|)
  * jaccard  |A and B| / |A or B|
  * hd95     max(P95(d(A->B)), P95(d(B->A))) over connectivity-1 borders,
             distances from a Euclidean distance transform, unit spacing
  * asd      mean(d(A->B))

plus the streaming accumulators: per-class dice / hd95 (``MedicalMetric``),
the confusion-matrix mIoU and accuracies (``SegMetrics``) and a running
average (``AverageMeter``).
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


def binary_jaccard(pred, gt) -> float:
    """medpy.metric.binary.jc semantics: 0.0 when both sets are empty."""
    pred, gt = _as_binary(pred), _as_binary(gt)
    inter = np.count_nonzero(pred & gt)
    union = np.count_nonzero(pred | gt)
    if union == 0:
        return 0.0
    return inter / union


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


def gt_surface_cache(gt) -> dict:
    """The ground truth's side of :func:`binary_hd95`, computed once: its
    border and the distance transform to it. Several models scored against
    the same ground truth share it (``evaluate_volumes_multi``)."""
    g = _as_binary(gt)
    border = _border(g)
    return {"any": bool(g.any()), "border": border,
            "dt": ndimage.distance_transform_edt(~border)}


def binary_hd95(pred, gt, gt_cache: dict | None = None) -> float:
    """95th-percentile symmetric Hausdorff distance (medpy hd95).
    ``gt_cache``: :func:`gt_surface_cache` of this ``gt``, which skips
    recomputing its border and distance transform; the result is the
    same."""
    if gt_cache is None:
        d1 = _surface_distances(pred, gt)
        d2 = _surface_distances(gt, pred)
    else:
        p = _as_binary(pred)
        if not p.any() or not gt_cache["any"]:
            raise ValueError("surface distance undefined for empty masks")
        p_border = _border(p)
        d1 = gt_cache["dt"][p_border]
        d2 = ndimage.distance_transform_edt(~p_border)[gt_cache["border"]]
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


def binary_asd(pred, gt) -> float:
    """Average surface distance pred -> gt (medpy asd)."""
    return float(np.mean(_surface_distances(pred, gt)))


def calculate_metric_percase_full(pred, gt) -> tuple[float, float, float,
                                                     float]:
    """Dice, HD95, Jaccard and ASD of one class under the same three-branch
    rule: both non-empty -> the four metrics; pred non-empty but gt empty
    -> (1, 0, 1, 0); else -> (0, 0, 0, 0)."""
    pred, gt = _as_binary(pred), _as_binary(gt)
    if pred.sum() > 0 and gt.sum() > 0:
        return (binary_dice(pred, gt), binary_hd95(pred, gt),
                binary_jaccard(pred, gt), binary_asd(pred, gt))
    if pred.sum() > 0 and gt.sum() == 0:
        return 1.0, 0.0, 1.0, 0.0
    return 0.0, 0.0, 0.0, 0.0


class MedicalMetric:
    """Streaming per-class dice / hd95 over cases (classes 1..C-1)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self) -> None:
        self._sums = np.zeros((self.num_classes - 1, 2), dtype=np.float64)
        self._count = 0

    def update(self, pred: np.ndarray, gt: np.ndarray) -> None:
        """pred, gt: integer label arrays of one case."""
        for i in range(1, self.num_classes):
            self._sums[i - 1] += np.asarray(
                calculate_metric_percase(pred == i, gt == i))
        self._count += 1

    def compute(self) -> dict:
        per_class = self._sums / max(self._count, 1)
        return {
            "dice_per_class": per_class[:, 0],
            "hd95_per_class": per_class[:, 1],
            "dice": float(per_class[:, 0].mean()),
            "hd95": float(per_class[:, 1].mean()),
        }


class SegMetrics:
    """Confusion-matrix metrics: overall and mean class accuracy, mean and
    per-class IoU."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.confusion = np.zeros((num_classes, num_classes), dtype=np.int64)

    def update(self, gts: np.ndarray, preds: np.ndarray) -> None:
        for gt, pred in zip(np.asarray(gts), np.asarray(preds)):
            self.confusion += self._hist(gt.flatten(), pred.flatten())

    def _hist(self, gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
        mask = (gt >= 0) & (gt < self.num_classes)
        return np.bincount(
            self.num_classes * gt[mask].astype(int) + pred[mask],
            minlength=self.num_classes ** 2,
        ).reshape(self.num_classes, self.num_classes)

    def compute(self) -> dict:
        h = self.confusion.astype(np.float64)
        acc = np.diag(h).sum() / max(h.sum(), 1)
        acc_cls = np.diag(h) / np.maximum(h.sum(axis=1), 1)
        denom = h.sum(axis=1) + h.sum(axis=0) - np.diag(h)
        iu = np.divide(np.diag(h), denom, out=np.zeros_like(np.diag(h)),
                       where=denom > 0)
        return {
            "overall_acc": float(acc),
            "mean_acc": float(np.nanmean(acc_cls)),
            "mean_iou": float(np.nanmean(iu)),
            "class_iou": dict(enumerate(iu)),
        }

    def reset(self) -> None:
        self.confusion.fill(0)


class AverageMeter:
    """Running average of a scalar, weighted by ``n``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
