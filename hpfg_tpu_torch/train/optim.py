"""Optimizers and LR schedules (port of ``hpfg_tpu/train/optim.py``).

Schedules are plain functions of the 0-based update count, as optax counts
them: the caller sets the lr from ``schedule(step)`` before each update
(``set_lr``). No ``torch.optim.lr_scheduler``: its stepping convention is
off by one against optax's count.

  * "medical":  base * (1 - it/max_iters)^0.9
  * "poly":     max(base * (1 - it/max_iters)^0.1, min_lr)
  * "cosine":   linear warmup warmup_lr -> base, then cosine to min_lr
  * "constant": base
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def medical_lr(base_lr: float, max_iterations: int) -> Schedule:
    def schedule(step: int) -> float:
        frac = min(max(1.0 - step / max_iterations, 0.0), 1.0)
        return base_lr * frac ** 0.9

    return schedule


def poly_lr(base_lr: float, max_iters: int, power: float = 0.1,
            min_lr: float = 1e-6) -> Schedule:
    def schedule(step: int) -> float:
        frac = min(max(1.0 - step / max_iters, 0.0), 1.0)
        return max(base_lr * frac ** power, min_lr)

    return schedule


def warmup_cosine_lr(base_lr: float, warmup_epochs: int, warmup_lr: float,
                     final_lr: float, iter_per_epoch: int,
                     num_epochs: int) -> Schedule:
    warmup_iters = max(int(iter_per_epoch * warmup_epochs), 0)
    decay_iters = max(int(iter_per_epoch * (num_epochs - warmup_epochs)) + 1,
                      1)

    def schedule(step: int) -> float:
        if step < warmup_iters:
            return warmup_lr + (base_lr - warmup_lr) * (
                step / max(warmup_iters, 1))
        i = min(max(step - warmup_iters, 0.0), decay_iters - 1)
        return final_lr + 0.5 * (base_lr - final_lr) * (
            1.0 + math.cos(math.pi * i / decay_iters))

    return schedule


def build_lr_schedule(cfg) -> Schedule:
    """Rate keys are float()-coerced (YAML 1.1 reads ``1e-05`` as a
    string)."""
    sched = cfg.get("sched", "medical")
    lr = float(cfg.get("lr"))
    total = int(cfg.get("total_itrs"))
    if sched == "medical":
        return medical_lr(lr, total)
    if sched == "poly":
        return poly_lr(lr, total, power=0.1,
                       min_lr=float(cfg.get("min_lr", 1e-6)))
    if sched == "cosine":
        step_size = int(cfg.get("step_size"))
        return warmup_cosine_lr(
            base_lr=lr, warmup_epochs=cfg.get("warmup_epochs", 0),
            warmup_lr=float(cfg.get("warmup_lr", 1e-4)),
            final_lr=float(cfg.get("min_lr", 1e-6)),
            iter_per_epoch=step_size,
            num_epochs=max(total // step_size, 1))
    if sched == "constant":
        return lambda step: lr
    raise ValueError(f"unknown sched {sched!r}")


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter]):
    """(optimizer, schedule) with torch semantics: weight decay added to the
    gradient for sgd and adam, decoupled for adamw. The optimizer's lr is
    a placeholder until ``set_lr``."""
    schedule = build_lr_schedule(cfg)
    opt = cfg.get("opt", "sgd")
    wd = float(cfg.get("weight_decay", 0.0))
    lr0 = schedule(0)
    if opt == "sgd":
        optimizer = torch.optim.SGD(params, lr=lr0,
                                    momentum=float(cfg.get("momentum", 0.9)),
                                    weight_decay=wd)
    elif opt in ("adamw", "adamW"):
        optimizer = torch.optim.AdamW(params, lr=lr0, weight_decay=wd)
    elif opt == "adam":
        optimizer = torch.optim.Adam(params, lr=lr0, weight_decay=wd)
    else:
        raise ValueError(f"unknown opt {opt!r}")
    return optimizer, schedule


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
