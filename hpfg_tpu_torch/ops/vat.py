"""Virtual Adversarial Training (port of ``hpfg_tpu/ops/vat.py``).

One power-iteration adversarial perturbation of the model INPUT:
  * the clean prediction, the (detached) target;
  * a random unit direction d, refined ``ip`` times by the gradient of the
    distance with respect to d (``torch.autograd.grad`` to d alone);
  * LDS = the distance between the clean prediction and the prediction at
    x + epi * d, differentiable with respect to the parameters.

``apply_fn_frozen`` is the same forward with DETACHED parameters (for
example ``torch.func.functional_call`` with ``p.detach()``); the clean
target and the power iteration run on it, as JAX's ``apply_fn_frozen``:
the inner gradient then reaches d only, so the conv Functions launch no
weight-gradient kernel, and it adds nothing to the parameters' gradients.
Both callables run train mode without folding the BN statistics (the
reference's ``_disable_tracking_bn_stats``); the caller gives all passes
one dropout draw.

Under data parallelism (``mesh``) ``x`` and ``d`` are this rank's rows of
the global batch (the caller draws d for the global batch), the
distance's sums are all-reduced, so it is the global batch's, and the
per-image normalizations stay local. The inner gradient reaches d through
the collectives' backward (every rank's gradient is W times its rows'
share, which the normalization removes).
"""

from __future__ import annotations

from typing import Callable

import torch

from hpfg_tpu_torch.parallel.distributed import all_reduce_sum, spans_ranks


def _l2_normalize(d: torch.Tensor) -> torch.Tensor:
    """Per-sample L2 normalization over every non-batch axis."""
    norm = torch.linalg.vector_norm(d.reshape(d.shape[0], -1), dim=1)
    return d / (norm.reshape((-1,) + (1,) * (d.dim() - 1)) + 1e-8)


def soft_dice_probs(probs: torch.Tensor, target_probs: torch.Tensor,
                    smooth: float = 1e-10, mesh=None) -> torch.Tensor:
    """The reference's softDiceLoss over probability maps: per class global
    sums with sum(p^2) / sum(t^2) denominators, 1 - dice averaged over the
    classes."""
    p, t = probs.float(), target_probs.float()
    dims = tuple(range(p.dim() - 1))
    intersect = (p * t).sum(dims)
    z = (p * p).sum(dims)
    y = (t * t).sum(dims)
    if spans_ranks(mesh):  # one all-reduce of the three sums
        intersect, z, y = all_reduce_sum(torch.stack([intersect, z, y]),
                                         mesh)
    return (1.0 - (2.0 * intersect + smooth) / (z + y + smooth)).mean()


def binary_dice_probs(probs: torch.Tensor, target_probs: torch.Tensor,
                      ep: float = 1e-8, mesh=None) -> torch.Tensor:
    """The reference's Binary_dice_loss over probability maps: ONE global
    intersection / union over every element, sum(p) / sum(t)
    denominators."""
    p, t = probs.float(), target_probs.float()
    inter, ps, ts = (p * t).sum(), p.sum(), t.sum()
    if spans_ranks(mesh):
        inter, ps, ts = all_reduce_sum(torch.stack([inter, ps, ts]), mesh)
    return 1.0 - (2.0 * inter + ep) / (ps + ts + ep)


def vat_loss(apply_fn: Callable[[torch.Tensor], torch.Tensor],
             x: torch.Tensor, d: torch.Tensor | None = None,
             generator: torch.Generator | None = None, xi: float = 10.0,
             epi: float = 6.0, ip: int = 1,
             apply_fn_frozen: Callable[[torch.Tensor], torch.Tensor]
             | None = None,
             distance: Callable[..., torch.Tensor] = soft_dice_probs,
             mesh=None) -> torch.Tensor:
    """``apply_fn(x)`` -> logits [..., C]. ``d``: the raw random direction
    (JAX's ``uniform(rng, x.shape) - 0.5``), else drawn from ``generator``
    on x's device (one process); it is normalized here. ``distance`` takes
    ``mesh``."""
    frozen = apply_fn_frozen if apply_fn_frozen is not None else apply_fn
    with torch.no_grad():
        pred = torch.softmax(frozen(x), dim=-1)
    if d is None:
        d = torch.rand(x.shape, generator=generator, device=x.device) - 0.5
    d = _l2_normalize(d.to(x.device, torch.float32))
    for _ in range(ip):
        d = d.detach().requires_grad_(True)
        with torch.enable_grad():
            p_hat = torch.softmax(frozen(x + xi * d), dim=-1)
            (grad_d,) = torch.autograd.grad(
                distance(p_hat, pred, mesh=mesh), d)
        d = _l2_normalize(grad_d.detach())
    p_hat = torch.softmax(apply_fn(x + epi * d), dim=-1)
    return distance(p_hat, pred, mesh=mesh)


def vat_loss_3d(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor, d: torch.Tensor | None = None,
                generator: torch.Generator | None = None, xi: float = 10.0,
                epi: float = 6.0, ip: int = 1,
                apply_fn_frozen: Callable[[torch.Tensor], torch.Tensor]
                | None = None, mesh=None) -> torch.Tensor:
    """VAT3d: :func:`vat_loss`'s power iteration with the global
    :func:`binary_dice_probs` distance (rank-agnostic: x may be
    [N, D, H, W, 1])."""
    return vat_loss(apply_fn, x, d, generator, xi=xi, epi=epi, ip=ip,
                    apply_fn_frozen=apply_fn_frozen,
                    distance=binary_dice_probs, mesh=mesh)
