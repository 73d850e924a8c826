"""S4CVNet (port of ``hpfg_tpu/train/algorithms/s4cvnet.py``).

Two students (model1 a UNet with SGD, model2 a SwinUNet with adamW in the
224² ACDC config) and an EMA teacher of model2. Per iteration:
  * both students forward [labelled, unlabelled] in train mode;
  * the teacher forwards the NOISED unlabelled batch, noise
    clamp(N(0, 0.1), +-0.2), in TRAIN mode under ``no_grad``;
  * loss_sup = Med_Sup of each student on the labelled part;
    cross pseudo supervision both ways, dice only, on the other student's
    argmax: 7 w (ps1 + ps2), w = consistency * linear_rampup(iter //
    epoch_iters, rampup);
    the MT softmax MSE of each student against the teacher, w (cons1 +
    cons2), on from iteration 1000;
  * one backward over the summed loss; each optimizer steps with the lr of
    its ``schedule(step)``; then the teacher's parameters take an EMA step
    towards model2's.

The noise comes from a ``torch.Generator`` on the device, so it is not
``jax.random``'s: ``step`` takes an injected ``noise`` so that a test can give
both implementations the same draw.
"""

from __future__ import annotations

import torch

from hpfg_tpu_torch.ops.ema import ema_update
from hpfg_tpu_torch.ops.losses import dice_loss_multiclass, med_sup_loss
from hpfg_tpu_torch.ops.rampup import linear_rampup
from hpfg_tpu_torch.train.algorithms import register
from hpfg_tpu_torch.train.algorithms.base import (
    ssl_batches,
    to_device,
    tree_copy,
)
from hpfg_tpu_torch.train.algorithms.dual import DualAlgorithm

NOISE_STD, NOISE_CLIP = 0.1, 0.2


@register("s4cvnet")
class S4CVNet(DualAlgorithm):
    name = "s4cvnet"
    mt_gate_iters: int = 1000
    cps_scale: float = 7.0

    def __init__(self, cfg, dtype=torch.float32, device="cuda"):
        super().__init__(cfg, dtype, device)
        self.ema = tree_copy(self.model2)
        for p in self.ema.parameters():
            p.requires_grad_(False)
        #: the teacher's input-noise draws, on the device
        self.noise_generator = torch.Generator(device=self.device)
        self.noise_generator.manual_seed(int(cfg.get("seed", 0)) + 3)

    def step(self, batch: dict, noise: torch.Tensor | None = None) -> dict:
        """One iteration; ``noise`` (the unlabelled batch's shape) replaces
        the teacher's input-noise draw."""
        cur_itrs = self.step_count + 1
        batch = to_device(batch, self.device)
        lb = self.label_bs
        gen = self.dropout_generator
        unlabel = batch["unlabel_img"]
        x = torch.cat([batch["label_img"], unlabel], dim=0)
        if noise is None:
            noise = torch.clamp(
                torch.randn(unlabel.shape, generator=self.noise_generator,
                            device=self.device) * NOISE_STD,
                -NOISE_CLIP, NOISE_CLIP)

        with torch.no_grad():
            ema_out = self.ema(unlabel + noise.to(self.device), train=True,
                               generator=gen)
            ema_soft = torch.softmax(ema_out, dim=-1)
        w = self.consistency * linear_rampup(cur_itrs // self.epoch_iters,
                                             self.rampup)
        mt_on = float(cur_itrs >= self.mt_gate_iters)

        out1 = self.model1(x, train=True, generator=gen)
        out2 = self.model2(x, train=True, generator=gen)
        soft1 = torch.softmax(out1, dim=-1)
        soft2 = torch.softmax(out2, dim=-1)
        loss_sup = (med_sup_loss(out1[:lb], batch["label"], self.num_classes)
                    + med_sup_loss(out2[:lb], batch["label"],
                                   self.num_classes))
        pseudo1 = soft1[lb:].detach().argmax(-1)
        pseudo2 = soft2[lb:].detach().argmax(-1)
        ps1 = dice_loss_multiclass(soft1[lb:], pseudo2, self.num_classes)
        ps2 = dice_loss_multiclass(soft2[lb:], pseudo1, self.num_classes)
        cons1 = mt_on * ((soft1[lb:] - ema_soft) ** 2).mean()
        cons2 = mt_on * ((soft2[lb:] - ema_soft) ** 2).mean()
        loss_semi = self.cps_scale * w * (ps1 + ps2) + w * (cons1 + cons2)
        loss = loss_sup + loss_semi

        lr1, lr2 = self.update(loss)
        ema_update(self.model2, self.ema, self.ema_decay, cur_itrs)
        self.step_count = cur_itrs
        return {"loss": loss.detach(), "loss_sup": loss_sup.detach(),
                "loss_semi": loss_semi.detach(), "consistency_weight": w,
                "lr1": lr1, "lr2": lr2}

    def batches(self, loaders):
        return ssl_batches(loaders[0], loaders[1])

    def eval_models(self) -> dict:
        return {"model1": self.model1, "model2": self.model2,
                "ema": self.ema}
