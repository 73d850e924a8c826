"""ICT-MedSeg, Interpolation Consistency Training (port of
``hpfg_tpu/train/algorithms/ict.py``; names ``ict``, ``ict_medseg`` and
``scc``, whose config is ICT-shaped).

Per iteration: the unlabelled batch is split in half, (u0, u1), and mixed
pairwise as u0 (1 - f) + u1 f with one factor f ~ Beta(ict_alpha,
ict_alpha) per pair; the student forwards [labelled, mixed] in train mode;
the EMA teacher forwards u0 and then u1 in train mode under ``no_grad``,
each folding its batch statistics into the teacher's running ones (the
second starts from the first's), and its softmaxes are mixed with the same
factors; the loss is Med_Sup on the labelled part plus consistency *
sigmoid_rampup(iter // epoch_iters) times the softmax MSE between the
student's mixed predictions and the mixed teacher target. SGD steps the
student, then the teacher's parameters take an EMA step.

The factors are drawn on the card as G1 / (G1 + G2), G1 and G2 ~
Gamma(alpha) from ``torch._standard_gamma`` on a device generator
(``torch.distributions.Beta`` takes no generator), so they are not
``jax.random.beta``'s: ``step`` takes injected ``factors`` (over the global
batch's U/2 pairs) so that a test can give both implementations the same
draw.

Under data parallelism the pairs cross ranks: global unlabelled row k
mixes with row k + U/2, which another rank usually holds (at W = 2 rank 0
holds all of u0 and rank 1 all of u1). So the unlabelled rows are gathered,
u0, u1 and the factors (drawn for the global batch) formed whole, and each
rank keeps its rows of each; the teacher's u0 and u1 forwards and the
student's [labelled, mixed] forward take their rows in their global
batches, and the losses are the global batch's.
"""

from __future__ import annotations

import torch

from hpfg_tpu_torch.ops.ema import ema_update
from hpfg_tpu_torch.ops.losses import global_mean, med_sup_loss
from hpfg_tpu_torch.ops.rampup import sigmoid_rampup
from hpfg_tpu_torch.parallel.distributed import gather_rows
from hpfg_tpu_torch.parallel.mesh import shard_batch
from hpfg_tpu_torch.train.algorithms import register
from hpfg_tpu_torch.train.algorithms.base import (
    Algorithm,
    ssl_batches,
    to_device,
    tree_copy,
)
from hpfg_tpu_torch.train.optim import build_optimizer, set_lr


def sample_beta(alpha: float, shape, generator: torch.Generator,
                device) -> torch.Tensor:
    """Beta(alpha, alpha) draws of ``shape`` on ``device``: G1 / (G1 + G2)
    from two Gamma(alpha) draws (0 where both underflow to 0)."""
    conc = torch.full(shape, float(alpha), device=device)
    g1 = torch._standard_gamma(conc, generator=generator)
    g2 = torch._standard_gamma(conc, generator=generator)
    return g1 / torch.clamp(g1 + g2, min=torch.finfo(torch.float32).tiny)


@register(["ict", "ict_medseg", "scc"])
class ICTMedSeg(Algorithm):
    name = "ict"

    def __init__(self, cfg, dtype=torch.float32, device="cuda"):
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
        self.ict_alpha = float(cfg.get("ict_alpha", 0.2))
        #: the mixing factors' draws, on the device
        self.mix_generator = torch.Generator(device=self.device)
        self.mix_generator.manual_seed(int(cfg.get("seed", 0)) + 3)
        self.broadcast_models()

    def step(self, batch: dict, factors: torch.Tensor | None = None) -> dict:
        """One iteration; ``factors`` [U/2, 1, 1, 1] (over the global
        batch's pairs) replaces the Beta draw."""
        cur_itrs = self.step_count + 1
        batch = to_device(batch, self.device)
        mesh = self.mesh
        lb, half = self.label_bs, self.unlabel_bs // 2
        unlabel = gather_rows(batch["unlabel_img"], mesh)
        if factors is None:
            factors = sample_beta(self.ict_alpha, (half, 1, 1, 1),
                                  self.mix_generator, self.device)
        factors = shard_batch(mesh, factors.to(self.device, torch.float32))
        u0 = shard_batch(mesh, unlabel[:half])
        u1 = shard_batch(mesh, unlabel[half:2 * half])
        mixed = u0 * (1.0 - factors) + u1 * factors
        x = torch.cat([batch["label_img"], mixed], dim=0)

        with torch.no_grad():
            ema0 = self.ema(u0, **self.train_kwargs(half))
            ema1 = self.ema(u1, **self.train_kwargs(half))
            pred_mixed = (torch.softmax(ema0, dim=-1) * (1.0 - factors)
                          + torch.softmax(ema1, dim=-1) * factors)
        consistency_weight = self.consistency * sigmoid_rampup(
            cur_itrs // self.epoch_iters, self.rampup)

        out = self.model(x, **self.train_kwargs(lb, half))
        out_soft = torch.softmax(out, dim=-1)
        lb = self.local(lb)
        loss_sup = med_sup_loss(out[:lb], batch["label"], self.num_classes,
                                mesh=mesh)
        loss_cons = global_mean((out_soft[lb:] - pred_mixed) ** 2, mesh)
        loss = loss_sup + consistency_weight * loss_cons

        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.sync_grads(self.model)
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
