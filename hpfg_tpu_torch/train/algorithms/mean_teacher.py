"""Mean-Teacher (port of ``hpfg_tpu/train/algorithms/mean_teacher.py``).

Per iteration: the EMA teacher forwards concat(labeled, unlabeled) under
``no_grad`` in TRAIN mode (dropout on, its own BN running statistics
evolve); the student forwards the same batch; the loss is Med_Sup on the
labeled part plus consistency * sigmoid_rampup(iter // epoch_iters) times
the softmax MSE on the unlabeled part; SGD updates the student with the lr
of ``schedule(step)``; the teacher's parameters (not its buffers) take an
EMA step with alpha = min(1 - 1/(iter+1), decay), iter 1-based.
"""

from __future__ import annotations

import torch

from hpfg_tpu_torch.ops.ema import ema_update
from hpfg_tpu_torch.ops.losses import med_sup_loss, softmax_mse_loss
from hpfg_tpu_torch.ops.rampup import sigmoid_rampup
from hpfg_tpu_torch.train.algorithms import register
from hpfg_tpu_torch.train.algorithms.base import (
    Algorithm,
    ssl_batches,
    to_device,
    tree_copy,
)
from hpfg_tpu_torch.train.optim import build_optimizer, set_lr


@register(["mean_teacher", "mt"])
class MeanTeacher(Algorithm):
    name = "mean_teacher"

    def __init__(self, cfg, dtype=torch.float32, device="cpu"):
        super().__init__(cfg, dtype, device)
        self.model = self._build(cfg)
        self.ema = tree_copy(self.model)
        for p in self.ema.parameters():
            p.requires_grad_(False)
        self.optimizer, self.schedule = build_optimizer(
            cfg, self.model.parameters())
        self.label_bs = int(cfg.get("batch_size"))
        self.unlabel_bs = int(cfg.get("unlabel_batch_size"))
        self.consistency = float(cfg.get("consistency", 0.1))
        self.rampup = float(cfg.get("consistency_rampup", 200.0))
        self.ema_decay = float(cfg.get("ema_decay", 0.99))

    def step(self, batch: dict) -> dict:
        cur_itrs = self.step_count + 1
        batch = to_device(batch, self.device)
        lb = self.label_bs
        x = torch.cat([batch["label_img"], batch["unlabel_img"]], dim=0)

        with torch.no_grad():
            ema_out = self.ema(x, train=True,
                               generator=self.dropout_generator)
        consistency_weight = self.consistency * sigmoid_rampup(
            cur_itrs // self.epoch_iters, self.rampup)

        out = self.model(x, train=True, generator=self.dropout_generator)
        loss_sup = med_sup_loss(out[:lb], batch["label"], self.num_classes)
        loss_cons = softmax_mse_loss(out[lb:], ema_out[lb:]).mean()
        loss = loss_sup + consistency_weight * loss_cons

        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = self.schedule(self.step_count)
        set_lr(self.optimizer, lr)
        self.optimizer.step()
        ema_update(self.model, self.ema, self.ema_decay, cur_itrs)
        self.step_count = cur_itrs
        return {"loss": loss.detach(), "loss_sup": loss_sup.detach(),
                "loss_consistency": loss_cons.detach(),
                "consistency_weight": consistency_weight, "lr": lr}

    def batches(self, loaders):
        return ssl_batches(loaders[0], loaders[1])

    def eval_models(self) -> dict:
        return {"model1": self.model, "model2": self.ema}
