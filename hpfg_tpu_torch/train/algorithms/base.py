"""Algorithm base class and batch streams (port of
``hpfg_tpu/train/algorithms/base.py``).

The JAX package threads an immutable state pytree through a pure step; here
the state is the algorithm's modules (parameters plus BN buffers), its
optimizers, its generators and ``step_count``, updated in place by ``step``;
``state_dict`` / ``load_state_dict`` carry all of it for a checkpoint.
"""

from __future__ import annotations

import copy
from typing import Iterator

import numpy as np
import torch

from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.ops.rampup import DEFAULT_EPOCH_ITERS
from hpfg_tpu_torch.utils.checkpoint import MODEL_FIELDS, OPTIMIZER_FIELDS


def tree_copy(module: torch.nn.Module) -> torch.nn.Module:
    """An independent copy (parameters and buffers): the EMA teacher starts
    as a copy of the student."""
    return copy.deepcopy(module)


def to_device(batch: dict, device: torch.device) -> dict:
    """Host numpy batch -> tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


class Algorithm:
    """Base: a config-built training algorithm.

    Subclasses define ``step(batch) -> metrics`` (metrics are 0-d tensors or
    floats, read by the trainer when it logs), ``batches(loaders)`` and
    ``eval_models() -> {name: module}``. ``cfg`` is any mapping with
    ``get``. The algorithm runs on the card unless the caller asks for
    another ``device``; without a card the default raises, it never builds
    on the CPU by itself."""

    name: str = "base"

    def __init__(self, cfg, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"algorithm {self.name!r}: device {self.device} asked for "
                "(the default) but no CUDA device is available; pass "
                "device='cpu' for a CPU run")
        self.num_classes = int(cfg.get("num_classes", 4))
        crop = cfg.get("train_crop_size", [224, 224])
        self.crop = (tuple(crop) if isinstance(crop, (list, tuple))
                     else (crop, crop))
        self.in_channels = int(cfg.get("in_channels", 1))
        self.epoch_iters = int(cfg.get("epoch_unit_iters",
                                       DEFAULT_EPOCH_ITERS))
        seed = int(cfg.get("seed", 0))
        #: parameter init draws
        self.init_generator = torch.Generator().manual_seed(seed)
        #: dropout seeds (one per ConvBlock forward), drawn on the host
        self.dropout_generator = torch.Generator().manual_seed(seed + 1)
        self.step_count = 0

    def _build(self, model_cfg) -> torch.nn.Module:
        model = build_model(model_cfg, dtype=self.dtype,
                            generator=self.init_generator)
        return model.to(self.device)

    def state_dict(self) -> dict:
        """What a checkpoint holds, as the JAX state pytree does: each
        model's parameters and buffers, each optimizer's state, every
        generator's state (the algorithm's ``torch.Generator`` attributes:
        ``init_generator``, ``dropout_generator`` and device generators such
        as HPFG's ``cutmix_generator``) and ``step_count``."""
        return {
            "step_count": self.step_count,
            "models": {k: getattr(self, k).state_dict()
                       for k in MODEL_FIELDS if hasattr(self, k)},
            "optimizers": {k: getattr(self, k).state_dict()
                           for k in OPTIMIZER_FIELDS if hasattr(self, k)},
            "generators": {k: g.get_state() for k, g in vars(self).items()
                           if isinstance(g, torch.Generator)},
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s output exactly; every field must match
        one of this algorithm's (strict)."""
        own = self.state_dict()
        for group in ("models", "optimizers", "generators"):
            if set(state[group]) != set(own[group]):
                raise KeyError(f"checkpoint {group} {sorted(state[group])} "
                               f"!= algorithm's {sorted(own[group])}")
        for k, sd in state["models"].items():
            getattr(self, k).load_state_dict(sd, strict=True)
        for k, sd in state["optimizers"].items():
            getattr(self, k).load_state_dict(sd)
        for k, gs in state["generators"].items():
            getattr(self, k).set_state(gs)
        self.step_count = int(state["step_count"])

    def step(self, batch: dict) -> dict:
        raise NotImplementedError

    def batches(self, loaders) -> Iterator[dict]:
        raise NotImplementedError

    def eval_models(self) -> dict:
        raise NotImplementedError


def zero_missing_grads(*models: torch.nn.Module) -> None:
    """Give every parameter off the loss (a *_plus model's necks under a
    logits-only loss) a zero gradient, as autodiff gives it, so that the
    optimizer still applies weight decay and momentum to it as optax
    does; torch's optimizers skip a parameter whose gradient is None."""
    for model in models:
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def ssl_batches(label_loader, unlabel_loader) -> Iterator[dict]:
    """Iterate the unlabeled loader, cycling the labeled one."""
    label_iter = label_loader.cycle()
    while True:
        for unlabel_img, _ in unlabel_loader:
            label_img, label = next(label_iter)
            yield {"label_img": label_img, "label": label,
                   "unlabel_img": unlabel_img}


def sup_batches(train_loader) -> Iterator[dict]:
    while True:
        for image, label in train_loader:
            yield {"image": image, "label": label}
