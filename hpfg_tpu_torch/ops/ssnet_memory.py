"""SS-Net's prototype feature memory, fixed-shape (port of
``hpfg_tpu/ops/ssnet_memory.py``).

The bank is a [C, K, F] tensor with a [C, K] validity mask, held in the
algorithm's state. A refresh keeps, per class, the K correctly predicted
non-background labelled rows of LOWEST selector score (the reference sorts
ascending and takes the head); a class without candidates keeps its old
slots. Ties keep the lower row first, as ``jax.lax.top_k`` does: on the
card the scores come out of a bf16 Dense and a bf16 sigmoid, so equal
scores among the labelled rows are common, and ``torch.topk`` promises no
order among them; a stable descending sort does. The class axis is batched
([C, ...] ops); only the per-class selector heads run one call each.
"""

from __future__ import annotations

from typing import Callable

import torch

NEG = -1e9


def update_memory(features: torch.Tensor, labels: torch.Tensor,
                  candidate_mask: torch.Tensor,
                  scores_per_class: torch.Tensor, memory: torch.Tensor,
                  memory_valid: torch.Tensor, num_classes: int):
    """One bank refresh. ``features`` [N, F] projected rows (detached),
    ``labels`` [N], ``candidate_mask`` [N] bool, ``scores_per_class``
    [C, N] (lower is kept), ``memory`` [C, K, F], ``memory_valid`` [C, K]
    bool. Returns (new memory, new validity)."""
    c_dim, k, _ = memory.shape
    if c_dim != num_classes:
        raise ValueError(f"memory has {c_dim} classes, not {num_classes}")
    features = features.detach().float()
    classes = torch.arange(num_classes, device=labels.device)
    mask = candidate_mask[None, :] & (labels[None, :] == classes[:, None])
    count = mask.sum(1)
    key = torch.where(mask, -scores_per_class, NEG)
    idx = torch.sort(key, dim=1, descending=True, stable=True)[1][:, :k]
    gathered = features[idx]
    slots = torch.arange(k, device=memory.device)[None, :]
    slot_valid = slots < torch.clamp(count, max=k)[:, None]
    new_mem = torch.where(slot_valid[:, :, None], gathered, memory)
    has_any = (count > 0)[:, None]
    new_valid = torch.where(has_any, slot_valid, memory_valid)
    new_mem = torch.where(has_any[:, :, None], new_mem, memory)
    return new_mem, new_valid


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def contrastive_class_to_class_learned_memory(
        features: torch.Tensor, labels: torch.Tensor, num_classes: int,
        memory: torch.Tensor, memory_valid: torch.Tensor,
        selector_fn: Callable[[int, torch.Tensor], torch.Tensor],
        selector_memory_fn: Callable[[int, torch.Tensor], torch.Tensor]
        ) -> torch.Tensor:
    """The reference's class-to-class contrastive loss over masked pairs.
    ``features`` [N, F] prediction-head rows, ``labels`` [N]. For each
    class c with more than one row and more than one valid slot: cosine
    distances between the L2-normalized rows and slots, weighted by the
    sigmoid of the two learned selectors (the feature side's input
    detached), mean over the valid pairs; the sum over classes / C."""
    feats32 = features.float()
    c_dim, _, _ = memory.shape
    if c_dim != num_classes:
        raise ValueError(f"memory has {c_dim} classes, not {num_classes}")
    distances = 1.0 - torch.einsum("nf,ckf->cnk", _l2n(feats32),
                                   _l2n(memory))
    classes = torch.arange(num_classes, device=labels.device)
    mask_f = labels[None, :] == classes[:, None]
    m_count = mask_f.sum(1).float()
    k_count = memory_valid.sum(1).float()

    sg_feats = feats32.detach()
    w_f = torch.stack([torch.sigmoid(selector_fn(c, sg_feats))[:, 0]
                       for c in range(num_classes)])
    w_f_sum = torch.where(mask_f, w_f, 0.0).sum(1)
    w_f = (m_count / torch.clamp(w_f_sum, min=1e-8))[:, None] * w_f
    w_m = torch.stack([torch.sigmoid(selector_memory_fn(c, memory[c]))[:, 0]
                       for c in range(num_classes)])
    w_m_sum = torch.where(memory_valid, w_m, 0.0).sum(1)
    w_m = (k_count / torch.clamp(w_m_sum, min=1e-8))[:, None] * w_m

    pair_mask = mask_f[:, :, None] & memory_valid[:, None, :]
    weighted = distances * w_f[:, :, None] * w_m[:, None, :]
    mean_c = torch.where(pair_mask, weighted, 0.0).sum((1, 2)) / torch.clamp(
        m_count * k_count, min=1.0)
    use = (m_count > 1) & (k_count > 1)
    return torch.where(use, mean_c, 0.0).sum() / num_classes
