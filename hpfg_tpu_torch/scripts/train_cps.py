"""Entry script (counterpart of ``scripts/train_cps.py``; reference
counterpart: 2021_06_CVPR_CPS_ACDC.py).

    python -m hpfg_tpu_torch.scripts.train_cps --set data_path=...
"""

from hpfg_tpu_torch.run import run

CONFIG = "configs/cps_unet_30k_224x224_ACDC.yaml"

if __name__ == "__main__":
    run(default_config=CONFIG)
