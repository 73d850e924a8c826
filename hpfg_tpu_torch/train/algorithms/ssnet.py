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
it is not ``jax.random``'s: ``step`` takes an injected ``d``.
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

    def state_dict(self) -> dict:
        state = super().state_dict()
        state["memory"] = {"memory": self.memory.clone(),
                           "memory_valid": self.memory_valid.clone()}
        return state

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.memory = state["memory"]["memory"].to(self.device).clone()
        self.memory_valid = state["memory"]["memory_valid"].to(
            self.device).clone()

    def _contrastive(self, feats, labels, train_kw):
        model = self.model
        pred = model.predict(model.project(feats, **train_kw), **train_kw)
        return contrastive_class_to_class_learned_memory(
            pred, labels, self.num_classes, self.memory, self.memory_valid,
            lambda c, f: model.select(c, f, **train_kw),
            lambda c, f: model.select_memory(c, f, **train_kw))

    def _vat(self, x: torch.Tensor, d) -> torch.Tensor:
        """The LDS term: three train-mode passes without folding, one
        dropout draw."""
        model, gen = self.model, self.dropout_generator
        gen_state = gen.get_state()
        frozen = {k: p.detach() for k, p in model.named_parameters()}
        kw = dict(train=True, generator=gen, fold=False)

        def apply(xv):
            gen.set_state(gen_state)
            return model(xv, **kw)[0]

        def apply_frozen(xv):
            gen.set_state(gen_state)
            return functional_call(model, frozen, (xv,), kw)[0]

        return vat_loss(apply, x, d, self.vat_generator, epi=self.magnitude,
                        apply_fn_frozen=apply_frozen)

    def step(self, batch: dict, d: torch.Tensor | None = None) -> dict:
        """One iteration; ``d`` (the batch's image shape, JAX's
        ``uniform(rng) - 0.5``) replaces VAT's random direction."""
        cur_itrs = self.step_count + 1
        batch = to_device(batch, self.device)
        model, lb, nc = self.model, self.label_bs, self.num_classes
        x = torch.cat([batch["label_img"], batch["unlabel_img"]], dim=0)
        target = batch["label"].long()
        consistency_weight = self.consistency * sigmoid_rampup(
            cur_itrs // self.epoch_iters, self.rampup)

        outputs, embedding = model(x, train=True,
                                   generator=self.dropout_generator)
        soft = torch.softmax(outputs, dim=-1)
        feat_dim = embedding.shape[-1]
        labeled_feat = embedding[:lb].reshape(-1, feat_dim)
        unlabeled_feat = embedding[lb:].reshape(-1, feat_dim)
        pred_label = soft[:lb].argmax(-1)
        pseudo_label = soft[lb:].argmax(-1).reshape(-1)
        flat_target = target.reshape(-1)
        correct = ((pred_label == target) & (pred_label > 0)).reshape(-1)

        head = dict(train=True, fold=False)
        with torch.no_grad():
            proj_mem = model.project(labeled_feat, train=False, fold=False)
            scores = torch.stack([
                torch.sigmoid(model.select(c, proj_mem, **head))[:, 0]
                for c in range(nc)])
            self.memory, self.memory_valid = update_memory(
                proj_mem, flat_target, correct, scores, self.memory,
                self.memory_valid, nc)

        loss_contr_l = self._contrastive(labeled_feat, flat_target, head)
        loss_contr_u = self._contrastive(unlabeled_feat, pseudo_label, head)
        loss_lds = self._vat(x, d)
        loss_ce = cross_entropy_loss(outputs[:lb], target)
        loss_dice = dice_loss_multiclass(soft[:lb], target, nc)
        loss = loss_dice + consistency_weight * (
            loss_lds + 0.1 * (loss_contr_l + loss_contr_u))

        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        zero_missing_grads(model)
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
