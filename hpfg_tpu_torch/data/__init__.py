"""Data loading (port of ``hpfg_tpu/data``: the ACDC loaders)."""
