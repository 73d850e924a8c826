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

``--validate-data`` checks the data tree alone, as ``scripts/run.py``
does: it prints one ``[validate-data]`` line per problem and a verdict, and
exits 0 (no problem) or 1 without building a model.

Resume, as ``scripts/run.py`` does: ``--set ckpt=<tag>`` restores that
checkpoint of ``<save_path>/model`` (``best_model1``, ``last``, ...) and
raises if it is missing; ``--set auto_resume=true`` restores the newest of
``last``, ``last_a`` and ``last_b`` where one exists, else starts from
scratch.

Data parallelism, as ``scripts/run.py``: ``--set distributed=true`` joins
the process group (``parallel.distributed.init_distributed``, from
torchrun's variables) before anything is built; each rank runs on
``cuda:LOCAL_RANK`` unless ``device`` names one (``--set device=cuda:0``
puts every rank on one card), and ``dist_backend`` (default none: NCCL on
CUDA devices, gloo on the CPU) picks the backend; ranks that share a card
need ``--set dist_backend=gloo``. With nothing to join (no torchrun
variables) ``distributed=true`` stops instead of training alone. The
config's batch sizes are the global batch. Launch with

    python -m torch.distributed.run --nproc-per-node 2 -m hpfg_tpu_torch.run \
        --config ... --set distributed=true
"""

from __future__ import annotations

import sys

import torch

DEFAULT_CONFIG = "configs/mean_teacher_unet_30k_224x224_ACDC.yaml"


def _device(cfg) -> torch.device:
    """The config's ``device``; under ``distributed`` a bare ``cuda`` (the
    default) is this rank's card, ``cuda:LOCAL_RANK``."""
    import os

    name = str(cfg.get("device", "cuda"))
    if cfg.get("distributed") and name == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device(name)


def run(argv=None, default_config: str = DEFAULT_CONFIG,
        algorithm: str | None = None):
    """Parse the config (``default_config`` unless ``--config``), train, and
    return the Trainer; ``algorithm`` overrides the config's
    ``algorithm:``."""
    from hpfg_tpu_torch.config import parse_config
    from hpfg_tpu_torch.data.preflight import (
        preflight_or_raise,
        validate_data_tree,
    )
    from hpfg_tpu_torch.train.algorithms import build_algorithm
    from hpfg_tpu_torch.train.trainer import Trainer

    argv = list(sys.argv[1:] if argv is None else argv)
    validate_only = "--validate-data" in argv
    if validate_only:
        argv.remove("--validate-data")
    cfg = parse_config("hpfg_tpu_torch trainer", default_config, argv)
    if validate_only:
        issues = validate_data_tree(str(cfg.get("data_path", "")),
                                    str(cfg.get("datasets", "")),
                                    int(cfg.get("num_classes", 4)))
        for line in issues:
            print(f"[validate-data] {line}")
        print(f"[validate-data] {'FAIL' if issues else 'OK'}: "
              f"{cfg.get('data_path')!r} ({cfg.get('datasets')})")
        raise SystemExit(1 if issues else 0)
    preflight_or_raise(cfg)

    device = _device(cfg)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("device=cuda but no CUDA device is available "
                         "(pass --set device=cpu for a CPU run)")
    if cfg.get("distributed"):
        import torch.distributed as dist

        from hpfg_tpu_torch.parallel.distributed import init_distributed

        backend = cfg.get("dist_backend")
        init_distributed(device=device, backend=None if backend in (
            None, "none", "null") else str(backend))
        if not dist.is_initialized():
            raise SystemExit(
                "distributed=true but no process group to join: launch "
                "through python -m torch.distributed.run (or set "
                "MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)")
    algo_name = algorithm or cfg.get("algorithm")
    if algo_name is None:
        raise SystemExit("config must define `algorithm:` (or pass one)")
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
