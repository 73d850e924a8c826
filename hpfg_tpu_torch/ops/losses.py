"""The segmentation / SSL loss library (port of
``hpfg_tpu/ops/losses.py``): the main path's losses and the rest of the
reference's library (soft-target, binary and per-sample dice, KL, MSE,
entropy, focal, BCE + dice (+ smooth L1)). Class axis last (NHWC);
reductions in fp32.

Each loss that reduces over the batch takes ``mesh`` (default None, one
process): under data parallelism over W > 1 ranks
(``parallel.mesh.Mesh``) the inputs are this rank's rows, every sum behind
the loss is all-reduced over the ranks and every count is the global one,
so each rank computes the loss of the global batch (the contrastive losses
run on the gathered rows of both views). Their backward follows the
scaling rule of ``parallel/distributed.py``. The pointwise
``softmax_mse_loss`` and ``entropy_loss_map`` take none.
"""

from __future__ import annotations

import math

import torch

from hpfg_tpu_torch.parallel.distributed import (
    all_gather_rows,
    all_reduce_sum,
    spans_ranks,
)

SMOOTH = 1e-5
IGNORE_INDEX = 255


def one_hot_labels(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """One-hot over a new last axis; labels outside [0, C) (the 255 ignore
    value) one-hot to all zeros."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long().unsqueeze(-1) == classes).float()


def global_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The mean of ``x`` over the global batch: x.mean() in one process,
    else the all-reduced sum over W times this rank's count."""
    if not spans_ranks(mesh):
        return x.mean()
    return all_reduce_sum(x.sum(), mesh) / (x.numel() * mesh.world)


def _dice_loss(smooth: float, mesh, intersect: torch.Tensor,
               z_sum: torch.Tensor, y_sum: torch.Tensor) -> torch.Tensor:
    """1 - (2*intersect+s) / (z_sum+y_sum+s), the three sums all-reduced
    together over the ranks."""
    if spans_ranks(mesh):
        intersect, z_sum, y_sum = all_reduce_sum(
            torch.stack([intersect, z_sum, y_sum]), mesh)
    return 1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)


def soft_dice_per_class(probs: torch.Tensor, target_one_hot: torch.Tensor,
                        smooth: float = SMOOTH, mesh=None) -> torch.Tensor:
    """Per-class soft dice loss (1 - dice) over all pixels of the batch:
    dice = (2*sum(p*t)+s) / (sum(p^2)+sum(t^2)+s). Returns [C]."""
    p = probs.float()
    t = target_one_hot.float()
    dims = tuple(range(p.dim() - 1))
    return _dice_loss(smooth, mesh, (p * t).sum(dims), (p * p).sum(dims),
                      (t * t).sum(dims))


def dice_loss_multiclass(probs: torch.Tensor, labels: torch.Tensor,
                         num_classes: int,
                         weight: torch.Tensor | None = None,
                         mesh=None) -> torch.Tensor:
    """Mean over classes (background included) of the soft dice loss."""
    per_class = soft_dice_per_class(probs, one_hot_labels(labels, num_classes),
                                    mesh=mesh)
    if weight is not None:
        per_class = per_class * torch.as_tensor(weight, dtype=per_class.dtype,
                                                device=per_class.device)
    return per_class.mean()


def dice_loss_from_probs(probs: torch.Tensor, target_probs: torch.Tensor,
                         smooth: float = SMOOTH, mesh=None) -> torch.Tensor:
    """Soft-target dice loss, mean over classes; sum(t), not sum(t^2), in
    the denominator."""
    p = probs.float()
    t = target_probs.float()
    dims = tuple(range(p.dim() - 1))
    return _dice_loss(smooth, mesh, (p * t).sum(dims), p.sum(dims),
                      t.sum(dims)).mean()


def softmax_dice_loss(input_logits: torch.Tensor,
                      target_logits: torch.Tensor,
                      mesh=None) -> torch.Tensor:
    """Softmax of both sides, then the soft-target dice loss."""
    return dice_loss_from_probs(torch.softmax(input_logits.float(), dim=-1),
                                torch.softmax(target_logits.float(), dim=-1),
                                mesh=mesh)


def dice_loss_binary(probs: torch.Tensor, targets: torch.Tensor,
                     smooth: float = SMOOTH, mesh=None) -> torch.Tensor:
    """1 - the batch mean of each sample's dice over its flattened
    pixels."""
    n = probs.shape[0]
    p = probs.float().reshape(n, -1)
    t = targets.float().reshape(n, -1)
    dice = (2.0 * (p * t).sum(1) + smooth) / (p.sum(1) + t.sum(1) + smooth)
    return 1.0 - global_mean(dice, mesh)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = IGNORE_INDEX,
                       mesh=None) -> torch.Tensor:
    """Pixel cross-entropy, mean over non-ignored pixels."""
    labels = labels.long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    total = all_reduce_sum(nll.sum(), mesh)
    count = all_reduce_sum(valid.sum(), mesh)
    return total / count.clamp(min=1)


def med_sup_loss(logits: torch.Tensor, labels: torch.Tensor,
                 num_classes: int, ce_weight: float = 0.5,
                 dice_weight: float = 0.5, mesh=None) -> torch.Tensor:
    """0.5*CE(ignore 255) + 0.5*Dice(softmax, labels)."""
    ce = cross_entropy_loss(logits, labels, mesh=mesh)
    dl = dice_loss_multiclass(torch.softmax(logits.float(), dim=-1), labels,
                              num_classes, mesh=mesh)
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


def _kl_pointwise(logp: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """torch ``kl_div`` pointwise: q * (log q - log p), 0 where q == 0."""
    return torch.where(q > 0, q * (torch.log(torch.clamp(q, min=1e-30))
                                   - logp), 0.0)


def softmax_kl_loss(input_logits: torch.Tensor, target_logits: torch.Tensor,
                    sigmoid: bool = False, mesh=None) -> torch.Tensor:
    """KL(target || input), mean over all elements (torch
    ``F.kl_div(reduction="mean")``)."""
    if sigmoid:
        logp = torch.log(torch.sigmoid(input_logits.float()))
        q = torch.sigmoid(target_logits.float())
    else:
        logp = torch.log_softmax(input_logits.float(), dim=-1)
        q = torch.softmax(target_logits.float(), dim=-1)
    return global_mean(_kl_pointwise(logp, q), mesh)


def symmetric_mse_loss(a: torch.Tensor, b: torch.Tensor,
                       mesh=None) -> torch.Tensor:
    """Mean squared difference, gradients to both sides."""
    return global_mean((a.float() - b.float()) ** 2, mesh)


def entropy_loss_map(probs: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-pixel entropy over the class axis, normalised by log(C)
    ([..., 1])."""
    p = probs.float()
    return -(p * torch.log(p + 1e-6)).sum(-1, keepdim=True) / math.log(
        num_classes)


def entropy_loss(probs: torch.Tensor, num_classes: int,
                 mesh=None) -> torch.Tensor:
    """Mean normalised pixel entropy."""
    return global_mean(entropy_loss_map(probs, num_classes), mesh)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0, alpha=None, size_average: bool = True,
               mesh=None) -> torch.Tensor:
    """Focal loss -(1 - pt)^gamma * alpha_t * log pt, with no gradient
    through pt; the mean over pixels, or with ``size_average=False`` the
    sum."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    oh = one_hot_labels(labels, logits.shape[-1])
    logpt = (logp * oh).sum(-1)
    pt = torch.exp(logpt.detach())
    if alpha is not None:
        logpt = logpt * (torch.as_tensor(alpha, dtype=torch.float32,
                                         device=oh.device) * oh).sum(-1)
    loss = -((1.0 - pt) ** gamma) * logpt
    if size_average:
        return global_mean(loss, mesh)
    return all_reduce_sum(loss.sum(), mesh)


def _binary_ce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                           mesh=None) -> torch.Tensor:
    """Mean BCE with logits in the stable form
    max(x, 0) - x*t + log1p(exp(-|x|))."""
    x = logits.float()
    t = targets.float()
    return global_mean(torch.clamp(x, min=0) - x * t
                       + torch.log1p(torch.exp(-x.abs())), mesh)


def bce_dice_loss(logits: torch.Tensor, targets: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """0.5 * BCE with logits + the binary per-sample dice loss."""
    bce = _binary_ce_with_logits(logits, targets, mesh)
    dice = dice_loss_binary(torch.sigmoid(logits.float()), targets,
                            mesh=mesh)
    return 0.5 * bce + dice


def bce_dice_l1_loss(logits: torch.Tensor, targets: torch.Tensor,
                     mesh=None) -> torch.Tensor:
    """bce_dice_loss + 0.1 * the mean smooth L1 of (logits - targets),
    quadratic below |x - t| = 1."""
    diff = (logits.float() - targets.float()).abs()
    l1 = global_mean(torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5),
                     mesh)
    return bce_dice_loss(logits, targets, mesh) + 0.1 * l1


def _l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12
                  ) -> torch.Tensor:
    norm = torch.sqrt((x * x).sum(dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def _nt_xent(out_1: torch.Tensor, out_2: torch.Tensor,
             temperature: float, mesh=None) -> torch.Tensor:
    """SimCLR NT-Xent over the 2B x 2B similarity matrix of normalised rows
    out_1, out_2 [B, D]; the diagonal is zeroed, which leaves the row sums
    of the masked-select form. With a mesh, over the gathered rows of every
    rank (the loss is invariant to a permutation of the rows applied to
    both views alike, so the gathered order need not be the global one)."""
    out_1 = all_gather_rows(out_1, mesh)
    out_2 = all_gather_rows(out_2, mesh)
    b = out_1.shape[0]
    out = torch.cat([out_1, out_2], dim=0)
    sim = torch.exp(out @ out.T / temperature)
    sim = sim * (1.0 - torch.eye(2 * b, dtype=sim.dtype, device=sim.device))
    pos = torch.exp((out_1 * out_2).sum(-1) / temperature)
    pos = torch.cat([pos, pos], dim=0)
    return (-torch.log(pos / sim.sum(-1))).mean()


def dense_contrastive_loss(student, teacher, temperature: float = 0.7,
                           mesh=None) -> torch.Tensor:
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
    return 0.5 * (_nt_xent(sg, tg, temperature, mesh)
                  + _nt_xent(sd, td, temperature, mesh))
