"""Entry script (counterpart of ``scripts/train_ict.py``; reference
counterpart: 2022_02_ISBI_ICT-MedSeg_ACDC.py).

    python -m hpfg_tpu_torch.scripts.train_ict --set data_path=...
"""

from hpfg_tpu_torch.run import run

CONFIG = "configs/ict-medseg_unet_30k_224x224_ACDC.yaml"

if __name__ == "__main__":
    run(default_config=CONFIG)
