"""Entry script (counterpart of ``scripts/train_supervised.py``; reference
counterpart: sup_ACDC.py).

    python -m hpfg_tpu_torch.scripts.train_supervised --set data_path=...
"""

from hpfg_tpu_torch.run import run

CONFIG = "configs/unet_30k_224x224_ACDC.yaml"

if __name__ == "__main__":
    run(default_config=CONFIG)
