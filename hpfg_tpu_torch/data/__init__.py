"""Data loading (port of ``hpfg_tpu/data``: the loaders of ACDC, LIDC,
ISIC, Synapse and Building, their augmentations, preflight and synthetic
trees)."""
