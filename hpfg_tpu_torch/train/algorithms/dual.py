"""Shared machinery of the dual-student algorithms (port of
``hpfg_tpu/train/algorithms/dual.py``).

Two models with an optimizer each, built from the nested ``model1:`` /
``model2:`` config blocks (configs/hpfg_unet_plus_30k_224x224_ACDC.yaml), or
from one flat (ccnet-style) model and optimizer spec that drives both. One
backward over the summed loss fills both models' gradients; each optimizer
then steps its own model.
"""

from __future__ import annotations

import torch

from hpfg_tpu_torch.models import returns_features
from hpfg_tpu_torch.train.algorithms.base import Algorithm, zero_missing_grads
from hpfg_tpu_torch.train.optim import build_optimizer, set_lr


class DualAlgorithm(Algorithm):
    """Builds ``model1``/``model2`` and their optimizers and schedules."""

    #: keys copied from a flat (ccnet-style) config into model1/model2
    _FLAT_KEYS = ("model", "num_classes", "in_channels", "train_crop_size",
                  "feature_chns", "dropout",
                  "opt", "lr", "weight_decay", "momentum", "sched",
                  "warmup_epochs", "warmup_lr", "min_lr", "total_itrs",
                  "step_size")

    #: set by algorithms (hpfg) whose loss unpacks the *_plus
    #: (logits, h1, h2) output of both students
    requires_features = False

    def __init__(self, cfg, dtype=torch.float32, device="cuda"):
        super().__init__(cfg, dtype, device)
        cfg1, cfg2 = cfg.get("model1"), cfg.get("model2")
        flat = {k: cfg.get(k) for k in self._FLAT_KEYS
                if cfg.get(k) is not None}
        cfg1 = dict(flat) if cfg1 is None else dict(cfg1)
        cfg2 = dict(flat) if cfg2 is None else dict(cfg2)
        # nested blocks may omit dataset-level keys; inherit them
        for sub in (cfg1, cfg2):
            for key in ("num_classes", "in_channels", "train_crop_size"):
                if key not in sub and cfg.get(key) is not None:
                    sub[key] = cfg.get(key)
        if self.requires_features:
            for sub in (cfg1, cfg2):
                if not returns_features(sub.get("model")):
                    raise ValueError(
                        f"algorithm {self.name!r} needs *_plus students that "
                        f"return (logits, h1, h2) for its dense-contrastive "
                        f"loss, but got model {sub.get('model')!r} (logits "
                        "only). Use the *_plus variant of the model.")
        self.model1 = self._build(cfg1)
        self.model2 = self._build(cfg2)
        self.optimizer1, self.schedule1 = build_optimizer(
            cfg1, self.model1.parameters())
        self.optimizer2, self.schedule2 = build_optimizer(
            cfg2, self.model2.parameters())
        self.label_bs = int(cfg.get("batch_size"))
        self.unlabel_bs = int(cfg.get("unlabel_batch_size"))
        self.consistency = float(cfg.get("consistency", 0.1))
        self.rampup = float(cfg.get("consistency_rampup", 200.0))
        self.ema_decay = float(cfg.get("ema_decay", 0.99))
        self.broadcast_models()

    def update(self, loss: torch.Tensor) -> tuple[float, float]:
        """One backward over the joint loss, then each optimizer steps with
        the lr of its schedule at the current (0-based) update count;
        parameters off the loss take a zero gradient, and under data
        parallelism the gradients are averaged over the ranks. Returns
        (lr1, lr2)."""
        self.optimizer1.zero_grad(set_to_none=True)
        self.optimizer2.zero_grad(set_to_none=True)
        loss.backward()
        zero_missing_grads(self.model1, self.model2)
        self.sync_grads(self.model1, self.model2)
        lrs = (self.schedule1(self.step_count),
               self.schedule2(self.step_count))
        for opt, lr in zip((self.optimizer1, self.optimizer2), lrs):
            set_lr(opt, lr)
            opt.step()
        return lrs
