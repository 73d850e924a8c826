"""Supervised baseline (port of ``hpfg_tpu/train/algorithms/supervised.py``).

One model and one optimizer: Med_Sup (``ce_weight`` CE + ``dice_weight``
Dice, both 0.5 by default) on the labelled batch; a *_plus model's
(logits, h1, h2) output is reduced to its logits, and its necks, off the
loss, take a zero gradient. The lr is ``schedule(step)``, read before the
update.
"""

from __future__ import annotations

import torch

from hpfg_tpu_torch.ops.losses import med_sup_loss
from hpfg_tpu_torch.train.algorithms import register
from hpfg_tpu_torch.train.algorithms.base import (
    Algorithm,
    sup_batches,
    to_device,
    zero_missing_grads,
)
from hpfg_tpu_torch.train.optim import build_optimizer, set_lr


@register(["supervised", "sup"])
class Supervised(Algorithm):
    name = "supervised"

    def __init__(self, cfg, dtype=torch.float32, device="cuda"):
        super().__init__(cfg, dtype, device)
        self.model = self._build(cfg)
        self.optimizer, self.schedule = build_optimizer(
            cfg, self.model.parameters())
        self.ce_weight = float(cfg.get("ce_weight", 0.5))
        self.dice_weight = float(cfg.get("dice_weight", 0.5))
        self.broadcast_models()

    def step(self, batch: dict) -> dict:
        batch = to_device(batch, self.device)
        out = self.model(batch["image"], **self.train_kwargs(
            len(batch["image"]) * self.mesh.world))
        if isinstance(out, tuple):
            out = out[0]
        loss = med_sup_loss(out, batch["label"], self.num_classes,
                            self.ce_weight, self.dice_weight, mesh=self.mesh)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        zero_missing_grads(self.model)
        self.sync_grads(self.model)
        lr = self.schedule(self.step_count)
        set_lr(self.optimizer, lr)
        self.optimizer.step()
        self.step_count += 1
        return {"loss": loss.detach(), "lr": lr}

    def batches(self, loaders):
        return sup_batches(loaders[0])

    def eval_models(self) -> dict:
        return {"model1": self.model}
