"""Training: optimizers, algorithms and the trainer loop."""

from hpfg_tpu_torch.train.optim import (  # noqa: F401
    build_lr_schedule,
    build_optimizer,
)
