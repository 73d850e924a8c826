"""Entry script (counterpart of ``scripts/train_hpfg.py``; reference
counterpart: main.py (HPFG flagship)).

    python -m hpfg_tpu_torch.scripts.train_hpfg --set data_path=...
"""

from hpfg_tpu_torch.run import run

CONFIG = "configs/hpfg_unet_plus_30k_224x224_ACDC.yaml"

if __name__ == "__main__":
    run(default_config=CONFIG)
