"""Entry script (counterpart of ``scripts/train_ctct.py``; reference
counterpart: 2021_12_MIDL_CTCT_ACDC.py).

    python -m hpfg_tpu_torch.scripts.train_ctct --set data_path=...
"""

from hpfg_tpu_torch.run import run

CONFIG = "configs/ctct_unet_segformer_30k_224x224_ACDC.yaml"

if __name__ == "__main__":
    run(default_config=CONFIG)
