"""UAMT, Uncertainty-Aware Mean Teacher (port of
``hpfg_tpu/train/algorithms/uamt.py``; names ``uamt`` and
``uncertainty_aware``).

Mean-Teacher with Monte-Carlo uncertainty gating. Per iteration:
  * the consistency target is ONE noisy teacher pass over the unlabelled
    batch (noise clamp(N(0, 0.1), +-0.2)), in train mode under ``no_grad``;
    it folds its batch statistics into the teacher's running ones;
  * T = 8 more noisy teacher passes, under ``no_grad`` and without folding
    (the JAX step throws their statistics away), give the uncertainty: the
    entropy of their mean softmax;
  * threshold (0.75 + 0.25 sigmoid_rampup(iter, total_itrs)) ln 2; the
    mask keeps the pixels whose uncertainty lies below it;
  * loss = Med_Sup on the labelled part + consistency *
    sigmoid_rampup(iter // epoch_iters) * sum(mask * mse) / (2 sum(mask) +
    1e-16), mse the softmax MSE between student and target;
  * SGD steps the student, then the teacher's parameters take an EMA step.

``mc_mode`` ``map`` (the default) runs the T passes one by one at the
unlabelled batch; ``unroll`` runs T / ``mc_chunk`` passes, each over the
batch tiled ``mc_chunk`` times with noise of its own for every copy (at
chunk 2 the reference's doubled-batch BN statistics).

The noise comes from a device generator, so it is not ``jax.random``'s:
``step`` takes injected ``noise`` (T + 1 tensors of the unlabelled batch's
shape: the target pass's, then one per MC copy) and ``dropout_seeds`` (T + 1
ints: the target pass's, then one per MC pass, of which ``unroll`` reads
each chunk's first), each seeding the host generator that draws that pass's
dropout seeds.

Under data parallelism each noise tensor is drawn (or injected) for the
global unlabelled batch and this rank's rows are kept; every teacher and
student forward takes its rows in the global batch (an ``unroll`` chunk's
input, the batch tiled c times, is c global segments of U rows), and the
loss's sums are all-reduced over the ranks.
"""

from __future__ import annotations

import math

import torch

from hpfg_tpu_torch.ops.ema import ema_update
from hpfg_tpu_torch.ops.losses import med_sup_loss, softmax_mse_loss
from hpfg_tpu_torch.ops.rampup import sigmoid_rampup
from hpfg_tpu_torch.parallel.distributed import all_reduce_sum, spans_ranks
from hpfg_tpu_torch.parallel.mesh import shard_batch
from hpfg_tpu_torch.train.algorithms import register
from hpfg_tpu_torch.train.algorithms.base import (
    Algorithm,
    ssl_batches,
    to_device,
    tree_copy,
)
from hpfg_tpu_torch.train.optim import build_optimizer, set_lr

NOISE_STD, NOISE_CLIP = 0.1, 0.2


@register(["uamt", "uncertainty_aware"])
class UAMT(Algorithm):
    name = "uamt"
    T: int = 8

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
        self.total_itrs = int(cfg.get("total_itrs"))
        self.mc_mode = str(cfg.get("mc_mode", "map"))
        self.mc_chunk = int(cfg.get("mc_chunk", 2))
        if self.mc_mode not in ("map", "unroll"):
            raise ValueError(f"mc_mode must be map|unroll, got {self.mc_mode}")
        if self.mc_mode == "unroll" and self.T % self.mc_chunk:
            raise ValueError(f"mc_chunk={self.mc_chunk} must divide T={self.T}")
        #: the teacher passes' input-noise draws, on the device
        self.noise_generator = torch.Generator(device=self.device)
        self.noise_generator.manual_seed(int(cfg.get("seed", 0)) + 3)
        self.broadcast_models()

    def _noise(self, like: torch.Tensor) -> torch.Tensor:
        """One noise draw over the global unlabelled batch."""
        return torch.clamp(
            torch.randn((self.unlabel_bs,) + tuple(like.shape[1:]),
                        generator=self.noise_generator,
                        device=self.device) * NOISE_STD,
            -NOISE_CLIP, NOISE_CLIP)

    def _kw(self, seeds, i: int, *segments: int) -> dict:
        """A teacher pass's train-mode keywords: pass ``i``'s dropout
        generator and its rows."""
        return dict(self.train_kwargs(*segments),
                    generator=self._generator(seeds, i))

    def _generator(self, seeds, i: int) -> torch.Generator:
        if seeds is None:
            return self.dropout_generator
        return torch.Generator().manual_seed(int(seeds[i]))

    def threshold(self, cur_itrs: int) -> float:
        """The uncertainty threshold at 1-based iteration ``cur_itrs``."""
        return (0.75 + 0.25 * sigmoid_rampup(cur_itrs, self.total_itrs)) \
            * math.log(2.0)

    @torch.no_grad()
    def _mean_softmax(self, unlabel, noise, seeds) -> torch.Tensor:
        """The mean softmax of the T noisy MC passes (no folding)."""
        t, u, ub = self.T, unlabel.shape[0], self.unlabel_bs
        if self.mc_mode == "map":
            psum = 0.0
            for i in range(t):
                out = self.ema(unlabel + noise[1 + i], fold=False,
                               **self._kw(seeds, 1 + i, ub))
                psum = psum + torch.softmax(out, dim=-1)
            return psum / t
        c = self.mc_chunk
        psum = 0.0
        for i in range(t // c):
            xin = unlabel.repeat(c, *([1] * (unlabel.dim() - 1)))
            xin = xin + torch.cat([noise[1 + i * c + j] for j in range(c)])
            out = self.ema(xin, fold=False,
                           **self._kw(seeds, 1 + i * c, *[ub] * c))
            sm = torch.softmax(out, dim=-1)
            psum = psum + sm.reshape((c, u) + sm.shape[1:]).sum(0)
        return psum / t

    def step(self, batch: dict, noise=None, dropout_seeds=None) -> dict:
        """One iteration; ``noise`` and ``dropout_seeds`` (module doc)
        replace the step's own draws."""
        cur_itrs = self.step_count + 1
        batch = to_device(batch, self.device)
        mesh, lb = self.mesh, self.label_bs
        unlabel = batch["unlabel_img"]
        x = torch.cat([batch["label_img"], unlabel], dim=0)
        if noise is None:
            noise = [self._noise(unlabel) for _ in range(self.T + 1)]
        noise = [shard_batch(mesh, n.to(self.device)) for n in noise]

        with torch.no_grad():
            ema_out = self.ema(unlabel + noise[0],
                               **self._kw(dropout_seeds, 0, self.unlabel_bs))
        preds = self._mean_softmax(unlabel, noise, dropout_seeds)
        uncertainty = -torch.sum(preds * torch.log(preds + 1e-6), dim=-1,
                                 keepdim=True)
        threshold = self.threshold(cur_itrs)
        mask = (uncertainty < threshold).float()
        consistency_weight = self.consistency * sigmoid_rampup(
            cur_itrs // self.epoch_iters, self.rampup)

        out = self.model(x, **self.train_kwargs(lb, self.unlabel_bs))
        lb = self.local(lb)
        loss_sup = med_sup_loss(out[:lb], batch["label"], self.num_classes,
                                mesh=mesh)
        dist = softmax_mse_loss(out[lb:], ema_out)
        masked, count = torch.sum(mask * dist), torch.sum(mask)
        if spans_ranks(mesh):  # one all-reduce of the two sums
            masked, count = all_reduce_sum(torch.stack([masked, count]), mesh)
        loss_cons = masked / (2 * count + 1e-16)
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
                "consistency_weight": consistency_weight,
                "threshold": threshold, "lr": lr}

    def batches(self, loaders):
        return ssl_batches(loaders[0], loaders[1])

    def eval_models(self) -> dict:
        return {"model1": self.model, "model2": self.ema}
