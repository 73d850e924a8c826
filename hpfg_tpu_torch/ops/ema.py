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
    a = effective_alpha(alpha, step)
    for e, p in zip(ema_model.parameters(), model.parameters()):
        e.mul_(a).add_(p, alpha=1.0 - a)
