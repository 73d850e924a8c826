"""Entry script (counterpart of ``scripts/train_uamt.py``; reference
counterpart: 2019_07_MICCAI_Uncertainty_Aware_ACDC.py).

    python -m hpfg_tpu_torch.scripts.train_uamt --set data_path=...
"""

from hpfg_tpu_torch.run import run

CONFIG = "configs/uncertainty_aware_unet_30k_224x224_ACDC.yaml"

if __name__ == "__main__":
    run(default_config=CONFIG)
