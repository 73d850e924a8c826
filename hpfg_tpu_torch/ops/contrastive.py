"""Auxiliary contrastive / knowledge-distillation loss library (port of
``hpfg_tpu/ops/contrastive.py``).

The reference's library losses that no trainer wires up: SimCLR
(``simclr_loss`` / ``contrastive_loss``), the distributed NT-Xent, SimSiam,
InfoNCE, structural and cross-image-pair KD, the batchmean KL, entropy
minimisation, the symmetric KL and the pixel-class contrastive loss. NHWC
inputs, masked selects instead of boolean packing, reductions in fp32.

``nt_xent_distributed`` takes a data-parallel mesh where the JAX function
takes a mesh axis name: its views are gathered over the ranks with
``parallel.distributed.all_gather_rows`` (differentiable), the role of the
reference's GatherLayer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hpfg_tpu_torch.models.layers import adaptive_avg_pool
from hpfg_tpu_torch.ops.losses import _kl_pointwise, softmax_kl_loss
from hpfg_tpu_torch.parallel.distributed import all_gather_rows

_NEG_INF = torch.finfo(torch.float32).min


def _l2n(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)


def simclr_loss(out_1: torch.Tensor, out_2: torch.Tensor,
                temperature: float = 0.5) -> torch.Tensor:
    """SimCLR NT-Xent over 2B local examples (reference SimCLRLoss;
    ContrastiveLoss is the same computation)."""
    b = out_1.shape[0]
    o1, o2 = _l2n(out_1.float()), _l2n(out_2.float())
    out = torch.cat([o1, o2], dim=0)
    sim = torch.exp(out @ out.T / temperature)
    sim = sim * (1.0 - torch.eye(2 * b, dtype=sim.dtype, device=sim.device))
    pos = torch.exp((o1 * o2).sum(-1) / temperature)
    pos = torch.cat([pos, pos], dim=0)
    return (-torch.log(pos / sim.sum(-1))).mean()


contrastive_loss = simclr_loss


def nt_xent_distributed(z_i: torch.Tensor, z_j: torch.Tensor,
                        temperature: float = 0.5, mesh=None) -> torch.Tensor:
    """Distributed SimCLR loss (reference NT_Xent): with a data-parallel
    ``mesh`` of W > 1 ranks the local views are gathered over the ranks
    (rank-major, the global order of contiguous shards) and the CE-form
    NT-Xent runs over the global 2·B·W batch, the same value on every
    rank."""
    z_i = all_gather_rows(z_i.float(), mesh)
    z_j = all_gather_rows(z_j.float(), mesh)
    bw = z_i.shape[0]
    n = 2 * bw
    z = _l2n(torch.cat([z_i, z_j], dim=0))
    sim = z @ z.T / temperature
    positives = torch.cat([torch.diagonal(sim, bw),
                           torch.diagonal(sim, -bw)])[:, None]
    idx = torch.arange(n, device=z.device)
    other = (idx + bw) % n
    mask = (idx[:, None] != idx[None, :]) & (other[:, None] != idx[None, :])
    negatives = torch.where(mask, sim, _NEG_INF)
    lse = torch.logsumexp(torch.cat([positives, negatives], dim=1), dim=1)
    return (lse - positives[:, 0]).sum() / n


def simsiam_loss(z1, z2, p1, p2, version: str = "simplified") -> torch.Tensor:
    """SimSiam negative cosine (reference SimSiamLoss); both versions are
    the same math. No gradient through z."""

    def asym(p, z):
        return -(_l2n(p.float()) * _l2n(z.detach().float())).sum(-1).mean()

    return 0.5 * asym(p1, z2) + 0.5 * asym(p2, z1)


def info_nce_loss(features: torch.Tensor, batch_size: int,
                  temperature: float = 0.7, n_views: int = 2) -> torch.Tensor:
    """InfoNCE over stacked views (reference Info_Nce_Loss): features
    [n_views·B, D]; positives are same-index pairs across views; CE against
    the positive column."""
    dev = features.device
    labels = torch.arange(batch_size, device=dev).repeat(n_views)
    same = labels[None, :] == labels[:, None]
    n = n_views * batch_size
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    f = _l2n(features.float())
    sim = f @ f.T
    positives = torch.where(same & ~eye, sim, 0.0).sum(1, keepdim=True)
    negatives = torch.where(~same, sim, _NEG_INF)
    logits = torch.cat([positives, negatives], dim=1) / temperature
    return (torch.logsumexp(logits, dim=1) - logits[:, 0]).mean()


def _max_pool4(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool((4, 4), strides=(4, 4))`` (VALID) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 4, 4).permute(0, 2, 3, 1)


def structural_kd_loss(feat_s: torch.Tensor,
                       feat_t: torch.Tensor) -> torch.Tensor:
    """Structured KD pairwise-similarity MSE (reference
    CriterionStructuralKD): 4x4 max pool, channels L2-normalised,
    per-sample token-similarity maps, MSE. NHWC in."""
    s = _l2n(_max_pool4(feat_s.float()))
    t = _l2n(_max_pool4(feat_t.float()))
    b = s.shape[0]
    s = s.reshape(b, -1, s.shape[-1])
    t = t.reshape(b, -1, t.shape[-1])
    sim_s = torch.einsum("bic,bjc->bij", s, s)
    sim_t = torch.einsum("bic,bjc->bij", t, t)
    return ((sim_s - sim_t) ** 2).mean()


def kld_loss(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """batchmean KL (reference Kld_Loss)."""
    logp = torch.log_softmax(inputs.float(), dim=-1)
    q = torch.softmax(targets.float(), dim=-1)
    return _kl_pointwise(logp, q).sum() / inputs.shape[0]


def cross_image_pair_kd(feat_s: torch.Tensor, feat_t: torch.Tensor,
                        temperature: float = 0.7,
                        pooling: int | None = 56) -> torch.Tensor:
    """Cross-image pairwise KD (reference CriterionMiniBatchCrossImagePair):
    the [B, B, N, N] token-similarity maps of every image pair as one
    einsum each; the mean over all (i, j) pairs of the batchmean KL."""
    if pooling is not None:
        feat_s = adaptive_avg_pool(feat_s, (pooling, pooling))
        feat_t = adaptive_avg_pool(feat_t, (pooling, pooling))
    s = _l2n(feat_s.float())
    t = _l2n(feat_t.float())
    b = s.shape[0]
    s = s.reshape(b, -1, s.shape[-1])
    t = t.reshape(b, -1, t.shape[-1])
    sim_s = torch.einsum("inc,jmc->ijnm", s, s) / temperature
    sim_t = torch.einsum("inc,jmc->ijnm", t, t) / temperature
    pointwise = _kl_pointwise(torch.log_softmax(sim_s, dim=-1),
                              torch.softmax(sim_t, dim=-1))
    return pointwise.sum() / (s.shape[1] * b * b)


def entropy_minimization(p: torch.Tensor) -> torch.Tensor:
    """Mean pixel entropy of probability maps (reference
    entropy_minmization)."""
    return (-(p * torch.log(p + 1e-6)).sum(-1)).mean()


def compute_kl_loss(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Symmetric mean KL between logits (reference compute_kl_loss)."""
    return 0.5 * (softmax_kl_loss(p, q) + softmax_kl_loss(q, p))


def _take_rows(mask: torch.Tensor, rows: torch.Tensor, k: int):
    """The first k rows where ``mask`` holds, in order (k clamped to the
    row count), their validity and the count of such rows."""
    k = min(k, rows.shape[0])
    order = torch.argsort((~mask).to(torch.int8), stable=True)[:k]
    count = mask.sum()
    valid = torch.arange(k, device=rows.device) < count
    return rows[order], valid, count


def pixel_class_contrastive_loss(features: torch.Tensor,
                                 memory_features: torch.Tensor,
                                 labels: torch.Tensor,
                                 student_logits: torch.Tensor,
                                 teacher_logits: torch.Tensor,
                                 num_classes: int, length: int = 1024,
                                 temperature: float = 0.1) -> torch.Tensor:
    """Pixel-level class contrastive loss (reference
    Pixel_Class_Contrastive_Loss). For each foreground class c: positives
    are the first ``length`` correctly predicted student pixels of class c
    paired with teacher pixels of class c; negatives are
    ``num_classes * length`` teacher pixels of the other classes; InfoNCE
    with the positive in column 0. A class without enough pixels adds 0.
    NHWC features / memory [B, H, W, C], labels [B, H, W], logits
    [B, H, W, K]."""
    opp_length = num_classes * length
    f = features.reshape(-1, features.shape[-1]).float()
    m = memory_features.reshape(-1, memory_features.shape[-1]).float()
    lab = labels.reshape(-1).long()
    s_pred = student_logits.argmax(-1).reshape(-1)
    t_pred = teacher_logits.argmax(-1).reshape(-1)
    s_ok = (s_pred == lab) & (s_pred > 0)
    t_ok = (t_pred == lab) & (t_pred > 0)
    total = f.new_zeros(())
    for c in range(1, num_classes):
        fc, f_valid, _ = _take_rows(s_ok & (s_pred == c), f, length)
        mc, m_valid, m_count = _take_rows(t_ok & (t_pred == c), m, length)
        oc, o_valid, o_count = _take_rows(t_ok & (t_pred != c), m,
                                          opp_length)
        fc, mc, oc = _l2n(fc), _l2n(mc), _l2n(oc)
        l_pos = (fc * mc).sum(-1, keepdim=True)
        l_neg = torch.where(o_valid[None, :], fc @ oc.T, _NEG_INF)
        logits = torch.cat([l_pos, l_neg], dim=1) / temperature
        ce = torch.logsumexp(logits, dim=1) - logits[:, 0]
        row_valid = f_valid & m_valid
        loss_c = torch.where(row_valid, ce, 0.0).sum() / torch.clamp(
            row_valid.sum(), min=1)
        enough = (m_count >= length) & (o_count >= opp_length)
        total = total + torch.where(enough, loss_c, 0.0)
    return total
