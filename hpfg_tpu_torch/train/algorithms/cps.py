"""CPS, cross pseudo supervision (port of
``hpfg_tpu/train/algorithms/cps.py``).

Two students forward the concat of the labelled and unlabelled batches in
train mode. Each gets Med_Sup on the labelled part and, on the unlabelled
part, Med_Sup against the other student's argmax (no gradient through the
pseudo-labels); the semi term is weighted by consistency *
sigmoid_rampup(iter // epoch_iters, rampup). One backward over the joint
loss, then each optimizer steps with the lr of its ``schedule(step)``.
"""

from __future__ import annotations

import torch

from hpfg_tpu_torch.ops.losses import med_sup_loss
from hpfg_tpu_torch.ops.rampup import sigmoid_rampup
from hpfg_tpu_torch.train.algorithms import register
from hpfg_tpu_torch.train.algorithms.base import ssl_batches, to_device
from hpfg_tpu_torch.train.algorithms.dual import DualAlgorithm


@register("cps")
class CPS(DualAlgorithm):
    name = "cps"

    def step(self, batch: dict) -> dict:
        cur_itrs = self.step_count + 1
        batch = to_device(batch, self.device)
        lb, nc, mesh = self.local(self.label_bs), self.num_classes, self.mesh
        kw = self.train_kwargs(self.label_bs, self.unlabel_bs)
        x = torch.cat([batch["label_img"], batch["unlabel_img"]], dim=0)
        w = self.consistency * sigmoid_rampup(cur_itrs // self.epoch_iters,
                                              self.rampup)

        out1 = self.model1(x, **kw)
        out2 = self.model2(x, **kw)
        label = batch["label"]
        loss_sup = (med_sup_loss(out1[:lb], label, nc, mesh=mesh)
                    + med_sup_loss(out2[:lb], label, nc, mesh=mesh))
        pseudo1 = out1[lb:].detach().argmax(-1)
        pseudo2 = out2[lb:].detach().argmax(-1)
        loss_semi = (med_sup_loss(out1[lb:], pseudo2, nc, mesh=mesh)
                     + med_sup_loss(out2[lb:], pseudo1, nc, mesh=mesh))
        loss = loss_sup + w * loss_semi

        lr1, _ = self.update(loss)
        self.step_count = cur_itrs
        return {"loss": loss.detach(), "loss_sup": loss_sup.detach(),
                "loss_semi": loss_semi.detach(), "consistency_weight": w,
                "lr": lr1}

    def batches(self, loaders):
        return ssl_batches(loaders[0], loaders[1])

    def eval_models(self) -> dict:
        return {"model1": self.model1, "model2": self.model2}
