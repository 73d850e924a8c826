"""Entry script (counterpart of ``scripts/train_ssnet.py``; reference
counterpart: 2022_03_MICCAI_SS-Net_ACDC.py).

    python -m hpfg_tpu_torch.scripts.train_ssnet --set data_path=...
"""

from hpfg_tpu_torch.run import run

CONFIG = "configs/ssnet_unet_30k_224x224_ACDC.yaml"

if __name__ == "__main__":
    run(default_config=CONFIG)
