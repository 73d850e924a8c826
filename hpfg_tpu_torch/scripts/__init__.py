"""The port's entry scripts (counterparts of ``scripts/train_*.py``): each
runs ``hpfg_tpu_torch.run.run`` on its algorithm's default config, e.g.

    python -m hpfg_tpu_torch.scripts.train_hpfg --set data_path=...
"""
