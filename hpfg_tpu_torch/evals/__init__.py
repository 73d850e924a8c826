"""Evaluation: batched volume and 2-D image forwards through the port's
kernels, and the segmentation metrics."""

from hpfg_tpu_torch.evals.metrics import (  # noqa: F401
    AverageMeter,
    MedicalMetric,
    SegMetrics,
    binary_asd,
    binary_dice,
    binary_hd95,
    binary_jaccard,
    calculate_metric_percase,
)
