"""HPFG, hybrid pseudo-labelling and feature-guided SSL (port of
``hpfg_tpu/train/algorithms/hpfg.py``, the paper's method).

Per iteration:
  * one unlabelled batch (U) and TWO independent labelled batches (L each);
    the second labelled batch is tiled U/L times;
  * CutMix box masks M; batch_un_mix = label1 * (1 - M) + unlabel * M;
    model1 (student A, a *_plus model) forwards [label, batch_un_mix];
  * model2 (student B) and its EMA teacher forward [label, unlabel]; the
    teacher in TRAIN mode under ``no_grad`` (its BN running statistics
    evolve, its dropout is on);
  * loss_sup = Med_Sup of each student on the labelled part;
    loss_contr = dense contrastive loss of model2's necks against the
    teacher's (high and head);
    pseudo labels: the teacher's argmax on the unlabelled part, CutMix-
    composited with the tiled labelled ground truth; dice pseudo-supervision
    of model1 on them;
    the MT softmax MSE teacher -> model2, on from iteration 1000;
  * loss = sup + 7 w pseudo_sup1 + w (consistency2 + loss_contr),
    w = consistency * linear_rampup(iter // epoch_iters, rampup);
  * one backward over the summed loss; each optimizer steps with the lr of
    its ``schedule(step)``; then model2's encoder and decoder take an EMA
    step towards model1's, and the teacher one towards model2 (parameters
    only, in that order).

The CutMix masks come from a ``torch.Generator`` on the device, so they are
not ``jax.random``'s: ``step`` takes an injected ``mask`` so that a test can
give both implementations the same one.

Under data parallelism (``algorithms/base.py``) the masks are drawn for the
global unlabelled batch and each rank keeps its rows, and the tiled second
labelled batch is built from the gathered global label1 rows: global
unlabelled row k pairs with label1 row k mod L, which usually lies on
another rank.
"""

from __future__ import annotations

import torch

from hpfg_tpu_torch.ops.cutmix import box_masks
from hpfg_tpu_torch.ops.ema import ema_update, ema_update_subtree
from hpfg_tpu_torch.ops.losses import (
    dense_contrastive_loss,
    dice_loss_multiclass,
    global_mean,
    med_sup_loss,
)
from hpfg_tpu_torch.ops.rampup import linear_rampup
from hpfg_tpu_torch.parallel.distributed import gather_rows
from hpfg_tpu_torch.parallel.mesh import shard_batch
from hpfg_tpu_torch.train.algorithms import register
from hpfg_tpu_torch.train.algorithms.base import to_device, tree_copy
from hpfg_tpu_torch.train.algorithms.dual import DualAlgorithm


@register("hpfg")
class HPFG(DualAlgorithm):
    name = "hpfg"
    requires_features = True
    mt_gate_iters: int = 1000
    cps_scale: float = 7.0
    backbone_keys = ("encoder", "decoder")

    def __init__(self, cfg, dtype=torch.float32, device="cuda"):
        super().__init__(cfg, dtype, device)
        self.ema = tree_copy(self.model2)
        for p in self.ema.parameters():
            p.requires_grad_(False)
        #: CutMix box draws, on the device
        self.cutmix_generator = torch.Generator(device=self.device)
        self.cutmix_generator.manual_seed(int(cfg.get("seed", 0)) + 2)

    def step(self, batch: dict, mask: torch.Tensor | None = None) -> dict:
        """One iteration; ``mask`` [U, H, W, 1] (over the global unlabelled
        batch) replaces the CutMix draw."""
        cur_itrs = self.step_count + 1
        batch = to_device(batch, self.device)
        lb, ub = self.label_bs, self.unlabel_bs
        reps = ub // lb
        mesh = self.mesh
        kw = self.train_kwargs(lb, ub)

        # the tiled label1 rows of this rank's unlabelled rows
        label_img1 = shard_batch(mesh, gather_rows(
            batch["label_img1"], mesh).repeat(reps, 1, 1, 1))
        target_label1 = shard_batch(mesh, gather_rows(
            batch["label1"], mesh).repeat(reps, 1, 1))
        if mask is None:
            mask = box_masks(self.cutmix_generator, ub, self.crop,
                             self.device)
        mask = shard_batch(mesh, mask.to(self.device, torch.float32))
        lb = self.local(lb)
        batch_un_mix = label_img1 * (1.0 - mask) + batch["unlabel_img"] * mask
        batch_mix = torch.cat([batch["label_img"], batch_un_mix], dim=0)
        volume_batch = torch.cat([batch["label_img"], batch["unlabel_img"]],
                                 dim=0)

        with torch.no_grad():
            ema_out, ema_h1, ema_h2 = self.ema(volume_batch, **kw)
            ema_soft = torch.softmax(ema_out, dim=-1)
            mask_hw = mask[..., 0]
            pseudo1 = ema_soft[lb:].argmax(-1).float()
            pseudo1 = (target_label1.float() * (1.0 - mask_hw)
                       + pseudo1 * mask_hw).to(torch.int32)
        w = self.consistency * linear_rampup(cur_itrs // self.epoch_iters,
                                             self.rampup)
        mt_on = float(cur_itrs >= self.mt_gate_iters)

        out1, _, _ = self.model1(batch_mix, **kw)
        out2, h1, h2 = self.model2(volume_batch, **kw)
        soft1 = torch.softmax(out1, dim=-1)
        soft2 = torch.softmax(out2, dim=-1)
        loss_sup = (med_sup_loss(out1[:lb], batch["label"], self.num_classes,
                                 mesh=mesh)
                    + med_sup_loss(out2[:lb], batch["label"],
                                   self.num_classes, mesh=mesh))
        loss_contr = (dense_contrastive_loss(h1, ema_h1, mesh=mesh)
                      + dense_contrastive_loss(h2, ema_h2, mesh=mesh))
        pseudo_sup1 = dice_loss_multiclass(soft1[lb:], pseudo1,
                                           self.num_classes, mesh=mesh)
        consistency2 = mt_on * global_mean((soft2[lb:] - ema_soft[lb:]) ** 2,
                                           mesh)
        loss_semi = (self.cps_scale * w * pseudo_sup1
                     + w * consistency2 + w * loss_contr)
        loss = loss_sup + loss_semi

        lr1, lr2 = self.update(loss)  # model1's necks are off the loss
        ema_update_subtree(self.model1, self.model2, self.ema_decay, cur_itrs,
                           self.backbone_keys)
        ema_update(self.model2, self.ema, self.ema_decay, cur_itrs)
        self.step_count = cur_itrs
        return {"loss": loss.detach(), "loss_sup": loss_sup.detach(),
                "loss_semi": loss_semi.detach(),
                "loss_contrastive": loss_contr.detach(),
                "pseudo_sup1": pseudo_sup1.detach(),
                "consistency_weight": w, "lr1": lr1, "lr2": lr2}

    def batches(self, loaders):
        """The unlabelled stream and TWO independent labelled cycles."""
        label_loader, unlabel_loader = loaders[0], loaders[1]
        it_a = label_loader.cycle()
        it_b = label_loader.cycle()
        while True:
            for unlabel_img, _ in unlabel_loader:
                label_img, label = next(it_a)
                label_img1, label1 = next(it_b)
                yield {"label_img": label_img, "label": label,
                       "label_img1": label_img1, "label1": label1,
                       "unlabel_img": unlabel_img}

    def eval_models(self) -> dict:
        return {"model1": self.model1, "model2": self.model2,
                "ema": self.ema}
