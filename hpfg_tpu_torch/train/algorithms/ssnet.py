"""SS-Net, smoothness and class separation (port of
``hpfg_tpu/train/algorithms/ssnet.py``).

Per iteration, on [labelled, unlabelled]:
  * the main train-mode forward of SSNet -> (logits, 16-channel features);
    it folds the BN statistics;
  * the memory refresh, under ``no_grad``: the labelled rows projected in
    EVAL mode (the heads' running statistics never move, so that is mean 0
    and variance 1), the selector scores in train mode, then
    ``update_memory`` with the correctly predicted non-background rows;
  * two class-to-class contrastive terms, labelled rows against their
    labels and unlabelled rows against their pseudo-labels, through the
    train-mode heads;
  * the VAT smoothness term (LDS) over the whole batch (``ops/vat.py``):
    the clean and inner passes on detached parameters, the final pass on
    the live ones, all three train mode without folding and with one
    dropout draw (the dropout generator's state is saved before the first
    pass and restored before each later one);
  * loss = dice + w (LDS + 0.1 (contr_l + contr_u)), w = consistency *
    sigmoid_rampup(iter // epoch_iters); CE is logged only, as in the
    reference. No head call folds (the JAX step drops their statistics).

The memory bank [C, 32, 32] and its validity [C, 32] are part of the
algorithm's state: ``state_dict`` / ``load_state_dict`` carry them, so a
resume is exact. VAT's random direction is drawn on a device generator, so
it is not ``jax.random``'s: ``step`` takes an injected ``d`` (over the
global batch).

Under data parallelism every rank computes the global batch's step: the
UNet and the heads take their rows (global BatchNorm statistics); the
bank's refresh runs on the gathered labelled rows, the same on every rank
(top-k over the global rows, the lower row first on ties), so the bank
stays bitwise equal across ranks, and ``load_state_dict`` broadcasts rank
0's; the contrastive terms run on the gathered prediction-head rows (the
selectors on every rank's rows, as in one process); VAT's direction is
drawn for the global batch and its distance is the global one; the dice
and CE are global.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from hpfg_tpu_torch.ops.losses import cross_entropy_loss, dice_loss_multiclass
from hpfg_tpu_torch.ops.rampup import sigmoid_rampup
from hpfg_tpu_torch.ops.ssnet_memory import (
    contrastive_class_to_class_learned_memory,
    update_memory,
)
from hpfg_tpu_torch.ops.vat import vat_loss
from hpfg_tpu_torch.parallel.distributed import (
    all_gather_rows,
    broadcast_tensors,
    gather_rows,
)
from hpfg_tpu_torch.train.algorithms import register
from hpfg_tpu_torch.train.algorithms.base import (
    Algorithm,
    ssl_batches,
    to_device,
    zero_missing_grads,
)
from hpfg_tpu_torch.train.optim import build_optimizer, set_lr


@register("ssnet")
class SSNetAlgorithm(Algorithm):
    name = "ssnet"
    elements_per_class: int = 32

    def __init__(self, cfg, dtype=torch.float32, device="cuda"):
        super().__init__(cfg, dtype, device)
        self.model = self._build(dict(cfg, model="ssnet"))
        self.optimizer, self.schedule = build_optimizer(
            cfg, self.model.parameters())
        self.label_bs = int(cfg.get("batch_size"))
        self.unlabel_bs = int(cfg.get("unlabel_batch_size"))
        self.consistency = float(cfg.get("consistency", 0.1))
        self.rampup = float(cfg.get("consistency_rampup", 200.0))
        self.magnitude = float(cfg.get("magnitude", 6.0))
        self.feat_dim = int(cfg.get("feat_dim", 32))
        c, k = self.num_classes, self.elements_per_class
        self.memory = torch.zeros((c, k, self.feat_dim), device=self.device)
        self.memory_valid = torch.zeros((c, k), dtype=torch.bool,
                                        device=self.device)
        #: VAT's random directions, on the device
        self.vat_generator = torch.Generator(device=self.device)
        self.vat_generator.manual_seed(int(cfg.get("seed", 0)) + 3)
        self.broadcast_models()

    def state_dict(self) -> dict:
        state = super().state_dict()
        state["memory"] = {"memory": self.memory.clone(),
                           "memory_valid": self.memory_valid.clone()}
        return state

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.memory = state["memory"]["memory"].to(self.device).clone()
        valid = state["memory"]["memory_valid"].to(self.device, torch.uint8)
        broadcast_tensors([self.memory, valid], self.mesh)
        self.memory_valid = valid.bool()

    def _contrastive(self, feats, labels, train_kw, rows):
        """A class-to-class term: this rank's rows through the projection
        and prediction heads, then the loss over every rank's rows."""
        model, mesh = self.model, self.mesh
        pred = model.predict(model.project(feats, rows=rows, **train_kw),
                             rows=rows, **train_kw)
        return contrastive_class_to_class_learned_memory(
            all_gather_rows(pred, mesh), gather_rows(labels, mesh),
            self.num_classes, self.memory, self.memory_valid,
            lambda c, f: model.select(c, f, **train_kw),
            lambda c, f: model.select_memory(c, f, **train_kw))

    def _refresh(self, labeled_feat, flat_target, correct) -> None:
        """The bank's refresh from every rank's labelled rows."""
        model, mesh, nc = self.model, self.mesh, self.num_classes
        head = dict(train=True, fold=False)
        proj_mem = gather_rows(model.project(labeled_feat, train=False,
                                             fold=False), mesh)
        scores = torch.stack([
            torch.sigmoid(model.select(c, proj_mem, **head))[:, 0]
            for c in range(nc)])
        self.memory, self.memory_valid = update_memory(
            proj_mem, gather_rows(flat_target, mesh),
            gather_rows(correct.to(torch.uint8), mesh).bool(), scores,
            self.memory, self.memory_valid, nc)

    def _direction(self, shape) -> torch.Tensor:
        """VAT's raw direction uniform - 0.5 over the global batch of
        ``shape``'s images."""
        return torch.rand(shape, generator=self.vat_generator,
                          device=self.device) - 0.5

    def _vat(self, x: torch.Tensor, d, rows) -> torch.Tensor:
        """The LDS term: three train-mode passes without folding, one
        dropout draw."""
        model, gen = self.model, self.dropout_generator
        gen_state = gen.get_state()
        frozen = {k: p.detach() for k, p in model.named_parameters()}
        kw = dict(train=True, generator=gen, fold=False)
        if rows is not None:
            kw["rows"] = rows
        total = len(x) if rows is None else rows.total
        if d is None:
            d = self._direction((total,) + tuple(x.shape[1:]))
        d = d.to(self.device)
        if rows is not None:
            d = rows.take(d)

        def apply(xv):
            gen.set_state(gen_state)
            return model(xv, **kw)[0]

        def apply_frozen(xv):
            gen.set_state(gen_state)
            return functional_call(model, frozen, (xv,), kw)[0]

        return vat_loss(apply, x, d, epi=self.magnitude,
                        apply_fn_frozen=apply_frozen, mesh=self.mesh)

    def step(self, batch: dict, d: torch.Tensor | None = None) -> dict:
        """One iteration; ``d`` (the global batch's image shape, JAX's
        ``uniform(rng) - 0.5``) replaces VAT's random direction."""
        cur_itrs = self.step_count + 1
        batch = to_device(batch, self.device)
        model, mesh, nc = self.model, self.mesh, self.num_classes
        x = torch.cat([batch["label_img"], batch["unlabel_img"]], dim=0)
        target = batch["label"].long()
        consistency_weight = self.consistency * sigmoid_rampup(
            cur_itrs // self.epoch_iters, self.rampup)

        kw = self.train_kwargs(self.label_bs, self.unlabel_bs)
        rows = kw.get("rows")
        outputs, embedding = model(x, **kw)
        lb = self.local(self.label_bs)
        soft = torch.softmax(outputs, dim=-1)
        feat_dim = embedding.shape[-1]
        labeled_feat = embedding[:lb].reshape(-1, feat_dim)
        unlabeled_feat = embedding[lb:].reshape(-1, feat_dim)
        pred_label = soft[:lb].argmax(-1)
        pseudo_label = soft[lb:].argmax(-1).reshape(-1)
        flat_target = target.reshape(-1)
        correct = ((pred_label == target) & (pred_label > 0)).reshape(-1)

        with torch.no_grad():
            self._refresh(labeled_feat, flat_target, correct)

        head = dict(train=True, fold=False)
        loss_contr_l = self._contrastive(labeled_feat, flat_target, head,
                                         rows)
        loss_contr_u = self._contrastive(unlabeled_feat, pseudo_label, head,
                                         rows)
        loss_lds = self._vat(x, d, rows)
        loss_ce = cross_entropy_loss(outputs[:lb], target, mesh=mesh)
        loss_dice = dice_loss_multiclass(soft[:lb], target, nc, mesh=mesh)
        loss = loss_dice + consistency_weight * (
            loss_lds + 0.1 * (loss_contr_l + loss_contr_u))

        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        zero_missing_grads(model)
        self.sync_grads(model)
        lr = self.schedule(self.step_count)
        set_lr(self.optimizer, lr)
        self.optimizer.step()
        self.step_count = cur_itrs
        return {"loss": loss.detach(), "loss_ce": loss_ce.detach(),
                "loss_dice": loss_dice.detach(),
                "loss_lds": loss_lds.detach(),
                "loss_contrastive": (loss_contr_l + loss_contr_u).detach(),
                "consistency_weight": consistency_weight, "lr": lr}

    def batches(self, loaders):
        return ssl_batches(loaders[0], loaders[1])

    def eval_models(self) -> dict:
        return {"model1": self.model}
