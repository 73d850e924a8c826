"""Training entry point of the port (counterpart of ``scripts/run.py``).

Usage:
    python -m hpfg_tpu_torch.run \
        --config configs/mean_teacher_unet_30k_224x224_ACDC.yaml \
        --set data_path=... --set total_itrs=100 --set step_size=50

Reads the same YAML configs and dotted ``--set`` overrides as the JAX
runner (the port's ``config.parse_config``) and checks the data tree first
(``data.preflight``). ``device`` (default ``cuda``) picks the card; a CPU
run must ask for ``--set device=cpu``: the runner never falls back to the
CPU by itself. ``precision: bf16`` computes in bf16 with fp32 parameters and
BN statistics.

Resume, as ``scripts/run.py`` does: ``--set ckpt=<tag>`` restores that
checkpoint of ``<save_path>/model`` (``best_model1``, ``last``, ...) and
raises if it is missing; ``--set auto_resume=true`` restores the newest of
``last``, ``last_a`` and ``last_b`` where one exists, else starts from
scratch.
"""

from __future__ import annotations

import sys

import torch

DEFAULT_CONFIG = "configs/mean_teacher_unet_30k_224x224_ACDC.yaml"


def run(argv=None, default_config: str = DEFAULT_CONFIG):
    from hpfg_tpu_torch.config import parse_config
    from hpfg_tpu_torch.data.preflight import preflight_or_raise
    from hpfg_tpu_torch.train.algorithms import build_algorithm
    from hpfg_tpu_torch.train.trainer import Trainer

    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = parse_config("hpfg_tpu_torch trainer", default_config, argv)
    preflight_or_raise(cfg)

    device = torch.device(str(cfg.get("device", "cuda")))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("device=cuda but no CUDA device is available "
                         "(pass --set device=cpu for a CPU run)")
    algo_name = cfg.get("algorithm")
    if algo_name is None:
        raise SystemExit("config must define `algorithm:`")
    dtype = (torch.bfloat16 if str(cfg.get("precision", "bf16")) == "bf16"
             else torch.float32)
    algo = build_algorithm(algo_name, cfg, dtype=dtype, device=device)
    trainer = Trainer(cfg, algo)
    ckpt_tag = cfg.get("ckpt")
    if ckpt_tag and str(ckpt_tag).lower() not in ("none", "null"):
        trainer.resume(str(ckpt_tag), strict=True)
    elif cfg.get("auto_resume"):
        trainer.resume("last")
    trainer.fit()
    return trainer


if __name__ == "__main__":
    run()
