"""Data loading (port of ``hpfg_tpu/data``: the loaders of ACDC, LIDC,
ISIC, Synapse and Building, their augmentations, preflight and synthetic
trees)."""

from hpfg_tpu_torch.data.builder import build_loader  # noqa: F401
