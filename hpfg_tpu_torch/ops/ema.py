"""EMA teacher update (port of ``hpfg_tpu/ops/ema.py``)."""

from __future__ import annotations

import torch
from torch import nn


def effective_alpha(alpha: float, step: int) -> float:
    """Warm-up: min(1 - 1/(step+1), alpha), step 1-based."""
    return min(1.0 - 1.0 / (step + 1.0), alpha)


@torch.no_grad()
def ema_update(model: nn.Module, ema_model: nn.Module, alpha: float,
               step: int) -> None:
    """ema = a*ema + (1-a)*param over PARAMETERS only, in place on
    ``ema_model``. BN buffers are not copied: the teacher's running
    statistics evolve from its own train-mode forwards."""
    _ema(list(ema_model.parameters()), list(model.parameters()),
         effective_alpha(alpha, step))


def _ema(ema_params: list, params: list, a: float) -> None:
    """ema = a*ema + (1-a)*param, in place, as two multi-tensor launches
    (the same per-element multiply and add as one pair per parameter)."""
    torch._foreach_mul_(ema_params, a)
    torch._foreach_add_(ema_params, params, alpha=1.0 - a)


@torch.no_grad()
def ema_update_subtree(model: nn.Module, ema_model: nn.Module, alpha: float,
                       step: int, keys: tuple[str, ...]) -> None:
    """The EMA step of :func:`ema_update` on the PARAMETERS of the named
    child modules only (HPFG: model2's encoder and decoder follow model1's,
    while model2's projection necks keep their own gradient-trained
    weights). Buffers are not touched."""
    ema_params, params = [], []
    for key in keys:
        ema_params += getattr(ema_model, key).parameters()
        params += getattr(model, key).parameters()
    _ema(ema_params, params, effective_alpha(alpha, step))
