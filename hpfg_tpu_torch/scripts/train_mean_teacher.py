"""Entry script (counterpart of ``scripts/train_mean_teacher.py``; reference
counterpart: 2017_03_NIPS_Mean-Teacher_ACDC.py).

    python -m hpfg_tpu_torch.scripts.train_mean_teacher --set data_path=...
"""

from hpfg_tpu_torch.run import run

CONFIG = "configs/mean_teacher_unet_30k_224x224_ACDC.yaml"

if __name__ == "__main__":
    run(default_config=CONFIG)
