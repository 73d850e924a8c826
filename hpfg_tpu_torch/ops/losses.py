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


def _l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12
                  ) -> torch.Tensor:
    norm = torch.sqrt((x * x).sum(dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def _nt_xent(out_1: torch.Tensor, out_2: torch.Tensor,
             temperature: float) -> torch.Tensor:
    """SimCLR NT-Xent over the 2B x 2B similarity matrix of normalised rows
    out_1, out_2 [B, D]; the diagonal is zeroed, which leaves the row sums
    of the masked-select form."""
    b = out_1.shape[0]
    out = torch.cat([out_1, out_2], dim=0)
    sim = torch.exp(out @ out.T / temperature)
    sim = sim * (1.0 - torch.eye(2 * b, dtype=sim.dtype, device=sim.device))
    pos = torch.exp((out_1 * out_2).sum(-1) / temperature)
    pos = torch.cat([pos, pos], dim=0)
    return (-torch.log(pos / sim.sum(-1))).mean()


def dense_contrastive_loss(student, teacher,
                           temperature: float = 0.7) -> torch.Tensor:
    """HPFG's dense contrastive loss between projection-neck outputs
    (global [B, D], dense [B, S, D]) of a student and its teacher (the
    teacher side is detached): 0.5 * (NT-Xent of the global vectors +
    NT-Xent of the flattened, per-position normalised dense maps)."""
    sg, sd = student
    tg, td = (t.detach() for t in teacher)
    sg = _l2_normalize(sg.float(), -1)
    tg = _l2_normalize(tg.float(), -1)
    sd = _l2_normalize(sd.float(), -1).reshape(sd.shape[0], -1)
    td = _l2_normalize(td.float(), -1).reshape(td.shape[0], -1)
    return 0.5 * (_nt_xent(sg, tg, temperature)
                  + _nt_xent(sd, td, temperature))
