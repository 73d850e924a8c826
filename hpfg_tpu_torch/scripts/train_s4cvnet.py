"""Entry script (counterpart of ``scripts/train_s4cvnet.py``; reference
counterpart: 2022_08_CVPR_S4CVNet_ACDC.py).

    python -m hpfg_tpu_torch.scripts.train_s4cvnet --set data_path=...
"""

from hpfg_tpu_torch.run import run

CONFIG = "configs/s4cvnet_unet_30k_224x224_ACDC.yaml"

if __name__ == "__main__":
    run(default_config=CONFIG)
