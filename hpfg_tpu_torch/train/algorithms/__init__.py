"""Training algorithms (port of ``hpfg_tpu/train/algorithms``).

Each algorithm owns its modules and optimizer and advances one iteration
per ``step(batch)``. Ported so far: Supervised, Mean-Teacher, CPS, CTCT,
HPFG, S4CVNet, ICT-MedSeg, UAMT, SS-Net and Swin-MAE (ROADMAP.md)."""

from __future__ import annotations

import importlib

ALGORITHMS: dict[str, type] = {}

_MODULES = ("supervised", "mean_teacher", "cps", "ctct", "hpfg", "s4cvnet",
            "ict", "uamt", "ssnet", "swin_mae")


def register(names):
    """Class decorator: register an algorithm under one or more names; a
    name registered twice raises KeyError, as ``hpfg_tpu/registry.py``."""
    names = [names] if isinstance(names, str) else list(names)

    def deco(cls):
        for name in names:
            key = name.lower()
            if key in ALGORITHMS:
                raise KeyError(f"algorithm {key!r} registered twice")
            ALGORITHMS[key] = cls
        return cls

    return deco


def build_algorithm(name: str, cfg, **kwargs):
    for mod in _MODULES:
        importlib.import_module(f"hpfg_tpu_torch.train.algorithms.{mod}")
    key = str(name).lower()
    if key not in ALGORITHMS:
        raise KeyError(f"unknown algorithm {name!r}; known: "
                       f"{', '.join(sorted(ALGORITHMS))}")
    return ALGORITHMS[key](cfg, **kwargs)
