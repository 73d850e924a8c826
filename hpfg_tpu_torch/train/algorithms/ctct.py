"""CTCT, cross teaching between a CNN and a transformer (port of
``hpfg_tpu/train/algorithms/ctct.py``).

CPS with two different students, each with its own optimizer from its
``model1:`` / ``model2:`` block (configs/ctct_unet_segformer_30k_224x224_ACDC
.yaml: a UNet with SGD and a SegFormer B0 with adamW). Both forward the
concat of the labelled and unlabelled batches in train mode. Each gets
Med_Sup on the labelled part and, on the unlabelled part, a Dice-only
pseudo-supervision: the Dice loss of its softmax against the argmax of the
other's softmax (no gradient through the pseudo-labels), weighted by
consistency * sigmoid_rampup(iter // epoch_iters, rampup). One backward
over the joint loss, then each optimizer steps with the lr of its
``schedule(step)``.
"""

from __future__ import annotations

import torch

from hpfg_tpu_torch.ops.losses import dice_loss_multiclass, med_sup_loss
from hpfg_tpu_torch.ops.rampup import sigmoid_rampup
from hpfg_tpu_torch.train.algorithms import register
from hpfg_tpu_torch.train.algorithms.base import ssl_batches, to_device
from hpfg_tpu_torch.train.algorithms.dual import DualAlgorithm


@register("ctct")
class CTCT(DualAlgorithm):
    name = "ctct"

    def step(self, batch: dict) -> dict:
        cur_itrs = self.step_count + 1
        batch = to_device(batch, self.device)
        lb, nc = self.label_bs, self.num_classes
        gen = self.dropout_generator
        x = torch.cat([batch["label_img"], batch["unlabel_img"]], dim=0)
        w = self.consistency * sigmoid_rampup(cur_itrs // self.epoch_iters,
                                              self.rampup)

        out1 = self.model1(x, train=True, generator=gen)
        out2 = self.model2(x, train=True, generator=gen)
        soft1 = torch.softmax(out1, dim=-1)
        soft2 = torch.softmax(out2, dim=-1)
        label = batch["label"]
        loss1 = med_sup_loss(out1[:lb], label, nc)
        loss2 = med_sup_loss(out2[:lb], label, nc)
        pseudo1 = soft1[lb:].detach().argmax(-1)
        pseudo2 = soft2[lb:].detach().argmax(-1)
        ps1 = dice_loss_multiclass(soft1[lb:], pseudo2, nc)
        ps2 = dice_loss_multiclass(soft2[lb:], pseudo1, nc)
        loss = loss1 + w * ps1 + loss2 + w * ps2

        lr1, lr2 = self.update(loss)
        self.step_count = cur_itrs
        return {"loss": loss.detach(), "loss_sup": (loss1 + loss2).detach(),
                "loss_semi": (ps1 + ps2).detach(), "consistency_weight": w,
                "lr1": lr1, "lr2": lr2}

    def batches(self, loaders):
        return ssl_batches(loaders[0], loaders[1])

    def eval_models(self) -> dict:
        return {"model1": self.model1, "model2": self.model2}
