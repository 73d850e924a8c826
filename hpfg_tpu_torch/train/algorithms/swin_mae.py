"""Swin-MAE self-supervised pretraining (port of
``hpfg_tpu/train/algorithms/swin_mae.py``; names ``swin_mae`` and
``swinmae``).

Per batch: (pred, mask) = SwinMAE(img) in train mode; loss =
mean((pred - img)^2 * mask) / mask_ratio (the reference script's
image-space loss); adamW with the warmup-cosine schedule of the config
(``train/optim.py``). There is no dice evaluation: ``eval_models`` is
empty. ``image_panels`` gives the image, masked-input and reconstruction
panels as uint8 arrays (the TensorBoard writer that shows them is not
ported yet). The mask noise is drawn on the device from a seed of the
dropout generator: ``step`` takes an injected ``noise`` [B, d^2] (over the
global batch) so that a test can give both implementations the same draw.
Under data parallelism the noise is the global batch's at this rank's rows
and the loss is the global batch's mean.
"""

from __future__ import annotations

import numpy as np
import torch

from hpfg_tpu_torch.ops.losses import global_mean
from hpfg_tpu_torch.parallel.mesh import shard_batch
from hpfg_tpu_torch.train.algorithms import register
from hpfg_tpu_torch.train.algorithms.base import (
    Algorithm,
    sup_batches,
    to_device,
)
from hpfg_tpu_torch.train.optim import build_optimizer, set_lr


def _to_uint8(x: np.ndarray) -> np.ndarray:
    """[H, W, C] -> [H, W, 3] uint8, min-max scaled (grey repeated)."""
    x = np.asarray(x, np.float32)
    x = (x - x.min()) / max(float(x.max() - x.min()), 1e-6)
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return (x * 255).astype(np.uint8)


@register(["swin_mae", "swinmae"])
class SwinMAEPretrain(Algorithm):
    name = "swin_mae"

    def __init__(self, cfg, dtype=torch.float32, device="cuda"):
        super().__init__(cfg, dtype, device)
        self.model = self._build(dict(cfg, model="swinmae"))
        self.mask_ratio = float(cfg.get("mask_ratio", 0.75))
        self.optimizer, self.schedule = build_optimizer(
            cfg, self.model.parameters())
        self.broadcast_models()

    def step(self, batch: dict, noise: torch.Tensor | None = None) -> dict:
        """One iteration; ``noise`` (over the global batch) replaces the
        mask's uniform draw."""
        batch = to_device(batch, self.device)
        img = batch["image"]
        if noise is not None:
            noise = shard_batch(self.mesh, noise.to(self.device))
        pred, mask = self.model(img, noise=noise, **self.train_kwargs(
            len(img) * self.mesh.world))
        loss = global_mean((pred - img) ** 2 * mask, self.mesh) \
            / self.mask_ratio
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.sync_grads(self.model)
        lr = self.schedule(self.step_count)
        set_lr(self.optimizer, lr)
        self.optimizer.step()
        self.step_count += 1
        return {"loss": loss.detach(), "lr": lr}

    def batches(self, loaders):
        return sup_batches(loaders[0])

    def eval_models(self) -> dict:
        return {}

    @torch.no_grad()
    def image_panels(self, batch: dict) -> dict:
        """The first image, its masked input and the reconstruction (the
        masked places from the prediction), each [H, W, 3] uint8, from an
        eval-mode forward."""
        img = to_device({"image": batch["image"][:1]}, self.device)["image"]
        pred, mask = self.model(img, train=False)
        img, pred, mask = (t.float().cpu().numpy() for t in (img, pred, mask))
        masked = img * (1.0 - mask)
        recon = masked + pred * mask
        return {"swin_mae/image": _to_uint8(img[0]),
                "swin_mae/masked": _to_uint8(masked[0]),
                "swin_mae/reconstruction": _to_uint8(recon[0])}
