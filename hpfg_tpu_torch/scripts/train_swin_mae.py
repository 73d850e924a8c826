"""Entry script (counterpart of ``scripts/train_swin_mae.py``; reference
counterpart: 2022_12_CVPR_Swin-MAE.py).

    python -m hpfg_tpu_torch.scripts.train_swin_mae --set data_path=...
"""

from hpfg_tpu_torch.run import run

CONFIG = "configs/swinmae_30k_224x224_ACDC.yaml"

if __name__ == "__main__":
    run(default_config=CONFIG)
