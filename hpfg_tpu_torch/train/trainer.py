"""The training loop (port of ``hpfg_tpu/train/trainer.py``).

``Trainer.fit`` runs ``algorithm.step`` until ``total_itrs``, logs the
step metrics every ``log_every`` iterations (one device read per flush)
and evaluates every ``step_size`` iterations on the last loader, ending
with a ``done: N iters`` line. ACDC and Synapse evaluate 3-D volumes
(Synapse resizes its slices with a cubic zoom); LIDC, ISIC and Building
evaluate 2-D image batches (``evaluate_images``). Loaders come from
the port's ``data.build_loader`` unless the caller passes its own.

A set ``pretrain_ckpt`` (a Swin-MAE run's ``<save_path>/model``; tag
``pretrain_tag``, default ``last``) transfers that encoder into every
module of the algorithm with a SwinUNet encoder (``model``, ``model1``,
``model2``, ``ema``) when the Trainer is built, so before any resume
(``utils/pretrain.py``); the report's counts go to the log.

Checkpoints go to ``<workdir>/model`` (``utils/checkpoint.py``), as the JAX
trainer writes them: ``last`` at the end of ``fit``, the crash-recovery
rotation ``last_a`` / ``last_b`` at each eval boundary, and
``best_<model>`` on each new best dice of that model. Each holds the
algorithm's whole state and ``best_dice``; ``resume`` restores it exactly.
Not ported yet (ROADMAP.md): the overlapped eval worker, TensorBoard (and
the writer of Swin-MAE's image panels), the device cache, on-device
augmentation and the prefetcher.
"""

from __future__ import annotations

import logging
import os
import time

import torch

from hpfg_tpu_torch.evals.volume import evaluate_images, evaluate_volumes
from hpfg_tpu_torch.utils.checkpoint import MODEL_FIELDS, CheckpointManager

VOLUME_DATASETS = {"acdc", "sup_acdc", "synapse", "sup_synapse"}


def get_logger(filename: str | None = None) -> logging.Logger:
    """Console (and optionally file) logger, idempotent per process."""
    logger = logging.getLogger("hpfg_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s][%(filename)s][line:%(lineno)d][%(levelname)s] "
        "%(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if filename and not any(getattr(h, "baseFilename", None)
                            == os.path.abspath(filename)
                            for h in logger.handlers):
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fh = logging.FileHandler(filename, encoding="utf-8")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class Trainer:
    def __init__(self, cfg, algorithm, loaders=None,
                 workdir: str | None = None, log_every: int = 20):
        self.cfg = cfg
        self.algorithm = algorithm
        self.workdir = workdir or cfg.get("save_path", "checkpoint/run")
        self.logger = get_logger(os.path.join(self.workdir, "log.log"))
        self.log_every = log_every
        self.ckpt = CheckpointManager(os.path.join(self.workdir, "model"))
        #: the best mean dice of each evaluated model so far
        self.best_dice: dict[str, float] = {}
        if loaders is None:
            from hpfg_tpu_torch.data.builder import build_loader

            loaders = build_loader(cfg)
        self.loaders = loaders
        self.test_loader = loaders[-1]
        self.total_itrs = int(cfg.get("total_itrs"))
        self.step_size = int(cfg.get("step_size"))
        self.num_classes = int(cfg.get("num_classes", 4))
        self.test_crop = tuple(cfg.get("test_crop_size",
                                       cfg.get("train_crop_size")))
        #: [(iter, {metric: float})] for every logged iteration
        self.metrics_log: list[tuple[int, dict]] = []
        #: [{"iter": n, "results": {model: (dice, hd95)}}]
        self.history: list[dict] = []
        #: {module field: transfer report} of the pretrain_ckpt transfer
        self.pretrain_reports = self._apply_pretrain()

    def _apply_pretrain(self) -> dict:
        """Transfer a Swin-MAE encoder (config ``pretrain_ckpt``) into every
        module of the algorithm that has a SwinUNet encoder; returns the
        reports by module field (empty without ``pretrain_ckpt``)."""
        ckpt_dir = self.cfg.get("pretrain_ckpt")
        if not ckpt_dir or str(ckpt_dir).lower() in ("none", "null"):
            return {}
        from hpfg_tpu_torch.models.swinunet import SwinUNetEncoder
        from hpfg_tpu_torch.utils.pretrain import (
            extract_mae_params,
            transfer_mae_encoder,
        )

        tag = str(self.cfg.get("pretrain_tag", "last"))
        mae = extract_mae_params(CheckpointManager(ckpt_dir).restore(tag))
        reports = {}
        for name in MODEL_FIELDS:
            module = getattr(self.algorithm, name, None)
            if not isinstance(getattr(module, "encoder", None),
                              SwinUNetEncoder):
                continue
            state, report = transfer_mae_encoder(mae, module.state_dict())
            module.load_state_dict(state)
            reports[name] = report
            self.logger.info(
                "pretrain_ckpt %s -> %s: %d tensors transferred, "
                "%d shape-skipped, %d missing", ckpt_dir, name,
                len(report["transferred"]), len(report["skipped_shape"]),
                len(report["missing_target"]))
        return reports

    def fit(self, eval_enabled: bool = True):
        algo = self.algorithm
        batches = algo.batches(self.loaders)
        self.logger.info("start training %s for %d iterations", algo.name,
                         self.total_itrs)
        t_start = time.time()
        start = algo.step_count
        t_window, iter_window = t_start, start
        pending: list[tuple[int, dict]] = []
        while algo.step_count < self.total_itrs:
            batch = next(batches)
            images = sum(len(v) for k, v in batch.items() if "img" in k
                         or k == "image")
            metrics = algo.step(batch)
            cur = algo.step_count
            pending.append((cur, metrics))
            if cur % self.log_every == 0 or cur == self.total_itrs:
                last = self._flush_metrics(pending)
                now = time.time()
                self.logger.info(
                    "iter %d/%d loss %.4f (%.1f img/s window, %.1f avg)",
                    cur, self.total_itrs, last.get("loss", float("nan")),
                    (cur - iter_window) * images / max(now - t_window, 1e-9),
                    (cur - start) * images / max(now - t_start, 1e-9))
                t_window, iter_window = now, cur
            if eval_enabled and cur % self.step_size == 0:
                self._flush_metrics(pending)
                self.evaluate(cur)
                self.ckpt.save_rotating(self.state_dict())
        self.save("last")
        elapsed = time.time() - t_start
        done = algo.step_count - start
        self.logger.info("done: %d iters in %.1fs (%.2f it/s)",
                         algo.step_count, elapsed, done / max(elapsed, 1e-9))
        return self.history

    def state_dict(self) -> dict:
        """What a checkpoint holds: the algorithm's state and the best
        dice so far."""
        return {"algorithm": self.algorithm.state_dict(),
                "best_dice": dict(self.best_dice)}

    def save(self, tag: str) -> None:
        self.ckpt.save(tag, self.state_dict())

    def resume(self, tag: str = "last", strict: bool = False) -> bool:
        """Restore checkpoint ``tag`` into the algorithm and ``best_dice``;
        returns whether one was restored. ``tag="last"`` means the newest
        of ``last``, ``last_a`` and ``last_b``. ``strict``: a missing tag
        raises FileNotFoundError instead of leaving the run to start from
        scratch."""
        resolved = (self.ckpt.latest_resume_tag("last") if tag == "last"
                    else tag if self.ckpt.exists(tag) else None)
        if resolved is None:
            if strict:
                raise FileNotFoundError(
                    f"requested checkpoint {tag!r} not found under "
                    f"{self.ckpt.directory}")
            return False
        self.logger.info("resuming from checkpoint %r", resolved)
        state = self.ckpt.restore(resolved)
        self.algorithm.load_state_dict(state["algorithm"])
        self.best_dice = dict(state["best_dice"])
        return True

    def _flush_metrics(self, pending: list) -> dict:
        """One device read for the whole window of tensor metrics."""
        if not pending:
            return self.metrics_log[-1][1] if self.metrics_log else {}
        names = sorted(pending[0][1])
        tensors = [m[k] for _, m in pending for k in names
                   if torch.is_tensor(m[k])]
        host = (torch.stack([t.float() for t in tensors]).cpu().tolist()
                if tensors else [])
        it = iter(host)
        for cur, m in pending:
            row = {k: (next(it) if torch.is_tensor(m[k]) else float(m[k]))
                   for k in names}
            self.metrics_log.append((cur, row))
        pending.clear()
        return self.metrics_log[-1][1]

    def evaluate(self, cur_itrs: int) -> dict:
        dsname = str(self.cfg.get("datasets")).lower()
        order = 3 if "synapse" in dsname else 0
        results = {}
        for name, model in self.algorithm.eval_models().items():
            if dsname in VOLUME_DATASETS:
                dice, hd95, _ = evaluate_volumes(
                    model, self.test_loader, self.num_classes, self.test_crop,
                    self.algorithm.device, zoom_order=order)
            else:
                dice, hd95 = evaluate_images(model, self.test_loader,
                                             self.algorithm.device)
            results[name] = (dice, hd95)
            self.logger.info("iter %d %s dice %.4f hd95 %.4f", cur_itrs,
                             name, dice, hd95)
            if dice > self.best_dice.get(name, 0.0):
                self.best_dice[name] = dice
                self.save(f"best_{name}")
        self.history.append({"iter": cur_itrs, "results": results})
        return results
