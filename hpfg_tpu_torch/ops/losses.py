"""Segmentation / SSL losses used by the main path (port of
``hpfg_tpu/ops/losses.py``). Class axis last (NHWC); reductions in fp32."""

from __future__ import annotations

import torch

SMOOTH = 1e-5
IGNORE_INDEX = 255


def one_hot_labels(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """One-hot over a new last axis; labels outside [0, C) (the 255 ignore
    value) one-hot to all zeros."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long().unsqueeze(-1) == classes).float()


def soft_dice_per_class(probs: torch.Tensor, target_one_hot: torch.Tensor,
                        smooth: float = SMOOTH) -> torch.Tensor:
    """Per-class soft dice loss (1 - dice) over all pixels of the batch:
    dice = (2*sum(p*t)+s) / (sum(p^2)+sum(t^2)+s). Returns [C]."""
    p = probs.float()
    t = target_one_hot.float()
    dims = tuple(range(p.dim() - 1))
    intersect = (p * t).sum(dims)
    z_sum = (p * p).sum(dims)
    y_sum = (t * t).sum(dims)
    return 1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)


def dice_loss_multiclass(probs: torch.Tensor, labels: torch.Tensor,
                         num_classes: int,
                         weight: torch.Tensor | None = None) -> torch.Tensor:
    """Mean over classes (background included) of the soft dice loss."""
    per_class = soft_dice_per_class(probs, one_hot_labels(labels, num_classes))
    if weight is not None:
        per_class = per_class * torch.as_tensor(weight, dtype=per_class.dtype,
                                                device=per_class.device)
    return per_class.mean()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Pixel cross-entropy, mean over non-ignored pixels."""
    labels = labels.long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


def med_sup_loss(logits: torch.Tensor, labels: torch.Tensor,
                 num_classes: int, ce_weight: float = 0.5,
                 dice_weight: float = 0.5) -> torch.Tensor:
    """0.5*CE(ignore 255) + 0.5*Dice(softmax, labels)."""
    ce = cross_entropy_loss(logits, labels)
    dl = dice_loss_multiclass(torch.softmax(logits.float(), dim=-1), labels,
                              num_classes)
    return ce_weight * ce + dice_weight * dl


def softmax_mse_loss(input_logits: torch.Tensor, target_logits: torch.Tensor,
                     sigmoid: bool = False) -> torch.Tensor:
    """Elementwise (softmax(in) - softmax(tgt))^2; the caller reduces and
    detaches the target side."""
    if sigmoid:
        a = torch.sigmoid(input_logits.float())
        b = torch.sigmoid(target_logits.float())
    else:
        a = torch.softmax(input_logits.float(), dim=-1)
        b = torch.softmax(target_logits.float(), dim=-1)
    return (a - b) ** 2
