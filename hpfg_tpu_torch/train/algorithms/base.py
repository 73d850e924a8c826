"""Algorithm base class and batch streams (port of
``hpfg_tpu/train/algorithms/base.py``).

The JAX package threads an immutable state pytree through a pure step; here
the state is the algorithm's modules (parameters plus BN buffers), its
optimizer and ``step_count``, updated in place by ``step``.
"""

from __future__ import annotations

import copy
from typing import Iterator

import numpy as np
import torch

from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.ops.rampup import DEFAULT_EPOCH_ITERS


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

    def step(self, batch: dict) -> dict:
        raise NotImplementedError

    def batches(self, loaders) -> Iterator[dict]:
        raise NotImplementedError

    def eval_models(self) -> dict:
        raise NotImplementedError


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
