"""Consistency-weight ramp-ups (port of ``hpfg_tpu/ops/rampup.py``), as
plain functions of a host-side step count."""

from __future__ import annotations

import math

#: iterations per nominal "epoch" of the ramp-ups (the reference's
#: ``iter // 150``); algorithms read ``cfg.epoch_unit_iters`` first
DEFAULT_EPOCH_ITERS = 150


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """exp(-5 * (1 - t)^2) with t = clip(current, 0, length) / length."""
    if rampup_length == 0:
        return 1.0
    current = min(max(float(current), 0.0), float(rampup_length))
    phase = 1.0 - current / rampup_length
    return math.exp(-5.0 * phase * phase)


def linear_rampup(current: float, rampup_length: float) -> float:
    """Linear 0 -> 1 ramp."""
    if rampup_length == 0:
        return 1.0
    return min(max(float(current) / rampup_length, 0.0), 1.0)
