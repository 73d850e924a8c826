"""Training algorithms (port of ``hpfg_tpu/train/algorithms``).

Each algorithm owns its modules and optimizer and advances one iteration
per ``step(batch)``. Ported so far: Supervised, Mean-Teacher, CPS, CTCT,
HPFG and S4CVNet (ROADMAP.md)."""

from __future__ import annotations

import importlib

ALGORITHMS: dict[str, type] = {}

_MODULES = ("supervised", "mean_teacher", "cps", "ctct", "hpfg", "s4cvnet")


def register(names):
    """Class decorator: register an algorithm under one or more names."""
    names = [names] if isinstance(names, str) else list(names)

    def deco(cls):
        for name in names:
            ALGORITHMS[name.lower()] = cls
        return cls

    return deco


def build_algorithm(name: str, cfg, **kwargs):
    for mod in _MODULES:
        importlib.import_module(f"hpfg_tpu_torch.train.algorithms.{mod}")
    key = str(name).lower()
    if key not in ALGORITHMS:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported to hpfg_tpu_torch yet "
            f"(ported: {sorted(ALGORITHMS)}; see ROADMAP.md, Queue 1)")
    return ALGORITHMS[key](cfg, **kwargs)
