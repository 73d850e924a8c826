"""The training loop (port of ``hpfg_tpu/train/trainer.py``).

``Trainer.fit`` runs ``algorithm.step`` until ``total_itrs``, writes the
step metrics to TensorBoard every ``log_every`` iterations (one device read
per flush) with an info line every ``10 * log_every`` and at the last
iteration, and evaluates every ``step_size`` iterations on the last loader,
ending with a ``done: N iters`` line. ACDC and Synapse evaluate 3-D volumes
(Synapse resizes its slices with a cubic zoom), the models that share an
architecture together (``evaluate_volumes_multi``); LIDC, ISIC and
Building evaluate 2-D image batches (``evaluate_images``). Loaders come
from the port's ``data.build_loader`` unless the caller passes its own.

Batches reach the card through ``data.prefetch.DevicePrefetcher`` (config
``prefetch``, the depth, default 2; 0 uploads each batch in the step). It
takes no more batches than the fit has steps left, so consecutive fits see
the batches and epochs they would see without it.

Evaluation overlaps training (config ``async_eval``, default on): at each
boundary the previous eval is joined, the whole state (``state_dict()``:
models, optimizers, generators, step count) is cloned on the device, on the
training stream, with copies of the eval models, and a worker thread
evaluates that snapshot on a CUDA stream of its own, then saves the
crash-recovery checkpoint from it. What is evaluated and saved is the state
of the boundary iteration, bit for bit, as with ``async_eval`` off, where
the loop evaluates and saves inline. An eval error re-raises in ``fit``;
one during shutdown after a training error is logged and the training
error propagates.

Data parallelism (JAX ``trainer.py``: every process steps and evaluates,
process 0 writes): every rank runs ``fit`` on its rank-sharded loaders,
steps its algorithm and, at each boundary, evaluates its share of the test
set (overlapped as in one process; ``evals/volume.py`` splits the volumes or
batches over the ranks and exchanges their rows through the rendezvous
store, never through the training group), so every rank's ``history`` and
``best_dice`` hold one process's results. Only rank 0 makes the workdir,
writes the log file, TensorBoard and the checkpoints. At each eval boundary
and at the end of ``fit`` every rank meets the others in
``coordination_barrier`` (``BARRIER_TIMEOUT_S``, 1800 s), which raises
where a peer is dead or hung instead of waiting for ever; the eval's
exchange of rows has the same deadline. ``resume`` reads the same files on
every rank.

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
TensorBoard events go to ``<workdir>/tensorboardX``: ``<algorithm>/<metric>``
scalars, ``<algorithm>/<model>_dice`` / ``_hd95`` at each eval, the first
volume's image, prediction and label panels, and Swin-MAE's image panels.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import time

import numpy as np
import torch

from hpfg_tpu_torch.evals.volume import evaluate_images, evaluate_volumes_multi
from hpfg_tpu_torch.parallel.distributed import (
    BARRIER_TIMEOUT_S,
    coordination_barrier,
    is_main_process,
    process_count,
)
from hpfg_tpu_torch.utils.checkpoint import MODEL_FIELDS, CheckpointManager
from hpfg_tpu_torch.utils.logging import get_logger, mk_path
from hpfg_tpu_torch.utils.tb import TBWriter

VOLUME_DATASETS = {"acdc", "sup_acdc", "synapse", "sup_synapse"}


def _clone_state(x):
    """A copy of a (nested) state dict whose tensors are cloned on their
    device, on the current stream."""
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        out = copy.copy(x)  # keeps an OrderedDict's _metadata
        for k, v in x.items():
            out[k] = _clone_state(v)
        return out
    if isinstance(x, (list, tuple)):
        return type(x)(_clone_state(v) for v in x)
    return copy.deepcopy(x)


def _architecture(model: torch.nn.Module) -> tuple:
    """Models with equal keys are evaluated together: class and parameter
    and buffer shapes."""
    return (type(model).__qualname__,
            tuple((k, tuple(v.shape)) for k, v in model.state_dict().items()))


class Trainer:
    def __init__(self, cfg, algorithm, loaders=None,
                 workdir: str | None = None, enable_tb: bool = True,
                 log_every: int = 20):
        self.cfg = cfg
        self.algorithm = algorithm
        #: rank 0 (or the one process) writes; every rank steps and evaluates
        self.is_main = is_main_process()
        self.workdir = workdir or cfg.get("save_path", "checkpoint/run")
        if self.is_main:
            mk_path(self.workdir)
        self.logger = get_logger(os.path.join(self.workdir, "log.log")
                                 if self.is_main else None)
        if not self.is_main:
            self.logger.setLevel(logging.WARNING)
        self.writer = TBWriter(os.path.join(self.workdir, "tensorboardX")
                               if enable_tb and self.is_main else None,
                               self.logger)
        if self.writer.enabled:
            self.logger.info("TensorBoard: %s", self.writer.backend)
        self.log_every = log_every
        self.ckpt = CheckpointManager(os.path.join(self.workdir, "model"),
                                      create=self.is_main)
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
        #: batches uploaded ahead of the step (0: in the step)
        self.prefetch = int(cfg.get("prefetch", 2))
        #: evaluate a snapshot on a worker thread, overlapping training
        self.async_eval = bool(cfg.get("async_eval", True))
        self._eval_pool = None
        self._eval_future = None
        self._eval_stream = None
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
        prefetcher = None
        if self.prefetch > 0:
            from hpfg_tpu_torch.data.prefetch import DevicePrefetcher

            prefetcher = DevicePrefetcher(
                batches, algo.device, depth=self.prefetch,
                limit=self.total_itrs - algo.step_count)
            batches = prefetcher
        self.logger.info("start training %s for %d iterations", algo.name,
                         self.total_itrs)
        t_start = time.time()
        start = algo.step_count
        t_window, iter_window = t_start, start
        pending: list[tuple[int, dict]] = []
        world = process_count()
        # the eval worker is joined even when training raises, and an error
        # of its own then must not hide the training error
        failed = False
        try:
            while algo.step_count < self.total_itrs:
                batch = next(batches)
                images = world * sum(len(v) for k, v in batch.items()
                                     if "img" in k or k == "image")
                metrics = algo.step(batch)
                cur = algo.step_count
                pending.append((cur, metrics))
                if cur % self.log_every == 0 or cur == self.total_itrs:
                    last = self._flush_metrics(pending)
                    if cur % (self.log_every * 10) == 0 \
                            or cur == self.total_itrs:
                        now = time.time()
                        self.logger.info(
                            "iter %d/%d loss %.4f (%.1f img/s window, %.1f "
                            "avg)", cur, self.total_itrs,
                            last.get("loss", float("nan")),
                            (cur - iter_window) * images
                            / max(now - t_window, 1e-9),
                            (cur - start) * images
                            / max(now - t_start, 1e-9))
                        t_window, iter_window = now, cur
                if eval_enabled and cur % self.step_size == 0:
                    self._flush_metrics(pending)
                    self._dispatch_eval(cur)
                    self._barrier(f"eval {cur}")
                    panels = getattr(algo, "image_panels", None)
                    if panels is not None and self.writer.enabled:
                        for tag, img in panels(batch).items():
                            self.writer.add_image(tag, img, cur)
        except BaseException:
            failed = True
            raise
        finally:
            if prefetcher is not None:
                prefetcher.close()
            try:
                self._join_eval()
            except Exception:
                if not failed:
                    raise
                self.logger.exception(
                    "overlapped eval also failed during shutdown (the "
                    "training error follows)")
            finally:
                # shut even when the join raises: the eval's error still
                # propagates, and no worker thread outlives fit
                if self._eval_pool is not None:
                    self._eval_pool.shutdown(wait=True)
                    self._eval_pool = None
        self.save("last")
        self._barrier("last")
        # a later fit's first write opens a new event file
        self.writer.close()
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
        """Write checkpoint ``tag`` (rank 0 only)."""
        if self.is_main:
            self.ckpt.save(tag, self.state_dict())

    def _barrier(self, tag: str) -> None:
        """Every rank meets the others (a no-op in one process)."""
        coordination_barrier(f"trainer {tag}", BARRIER_TIMEOUT_S)

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
        """One device read for the whole window of tensor metrics, which
        go to TensorBoard as ``<algorithm>/<metric>``."""
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
            self.writer.add_scalars(row, cur, prefix=self.algorithm.name)
        pending.clear()
        return self.metrics_log[-1][1]

    # -- evaluation ------------------------------------------------------
    def _dispatch_eval(self, cur_itrs: int) -> None:
        """Evaluate (every rank its share) and save the crash-recovery
        checkpoint (rank 0): inline, or with ``async_eval`` on a snapshot in
        the worker thread (evals run one at a time: a boundary first joins
        the previous one). Only rank 0 snapshots the whole state, which it
        alone writes."""
        if not self.async_eval:
            self._eval_task(cur_itrs)
            return
        from concurrent.futures import ThreadPoolExecutor

        if self._eval_pool is None:
            self._eval_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hpfg-eval")
        self._join_eval()
        device = self.algorithm.device
        with torch.no_grad():
            state = (_clone_state(self.algorithm.state_dict())
                     if self.is_main else None)
            models = copy.deepcopy(self.algorithm.eval_models())
        ready = None
        if device.type == "cuda":
            if self._eval_stream is None:
                self._eval_stream = torch.cuda.Stream(device)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        self._eval_future = self._eval_pool.submit(
            self._eval_task, cur_itrs, models, state, ready)

    def _eval_task(self, cur_itrs: int, models: dict | None = None,
                   state: dict | None = None, ready=None) -> None:
        """Evaluate, then save the crash-recovery rotation: the live models
        and state inline, or a snapshot in the worker, on its own stream
        once the event ``ready`` (the snapshot's clone) has passed."""
        stream = contextlib.nullcontext()
        if ready is not None:
            self._eval_stream.wait_event(ready)
            stream = torch.cuda.stream(self._eval_stream)
        with stream:
            self.evaluate(cur_itrs, models, state)
            if self.is_main:
                self.ckpt.save_rotating(self._checkpoint(state))
        if ready is not None:
            # the snapshot's memory belongs to the training stream: it is
            # freed only after this stream has finished reading it
            self._eval_stream.synchronize()

    def _join_eval(self) -> None:
        """Wait for the in-flight eval, re-raising its error."""
        fut, self._eval_future = self._eval_future, None
        if fut is not None:
            fut.result()

    def _checkpoint(self, state: dict | None) -> dict:
        """What a checkpoint of the evaluated state holds: the snapshot (or,
        inline, the live state) and the best dice so far."""
        if state is None:
            return self.state_dict()
        return {"algorithm": state, "best_dice": dict(self.best_dice)}

    def evaluate(self, cur_itrs: int, models: dict | None = None,
                 state: dict | None = None) -> dict:
        """Evaluate ``models`` (default: the algorithm's eval models), this
        rank's share of the test set under data parallelism, and save
        ``best_<model>`` from ``state`` (default: the live state) on each
        new best dice (rank 0)."""
        if models is None:
            models = self.algorithm.eval_models()
        device, mesh = self.algorithm.device, self.algorithm.mesh
        t0 = time.perf_counter()
        dsname = str(self.cfg.get("datasets")).lower()
        results = {}
        if dsname in VOLUME_DATASETS:
            order = 3 if "synapse" in dsname else 0
            groups: dict[tuple, dict] = {}
            for name, model in models.items():
                groups.setdefault(_architecture(model), {})[name] = model
            for group in groups.values():
                res = evaluate_volumes_multi(
                    group, self.test_loader, self.num_classes,
                    self.test_crop, device, zoom_order=order,
                    want_first=self.writer.enabled, mesh=mesh)
                for name, (dice, hd95, _, first) in res.items():
                    self._log_panels(name, first, cur_itrs)
                    results[name] = (dice, hd95)
            results = {name: results[name] for name in models}
        else:
            for name, model in models.items():
                results[name] = evaluate_images(model, self.test_loader,
                                                device, mesh=mesh)
        self.logger.info("iter %d eval over %d rank(s): %d model(s) in %.1f s",
                         cur_itrs, mesh.world, len(results),
                         time.perf_counter() - t0)
        for name, (dice, hd95) in results.items():
            self.writer.add_scalar(f"{self.algorithm.name}/{name}_dice",
                                   dice, cur_itrs)
            self.writer.add_scalar(f"{self.algorithm.name}/{name}_hd95",
                                   hd95, cur_itrs)
            self.logger.info("iter %d %s dice %.4f hd95 %.4f", cur_itrs,
                             name, dice, hd95)
            if dice > self.best_dice.get(name, 0.0):
                self.best_dice[name] = dice
                if self.is_main:
                    self.ckpt.save(f"best_{name}", self._checkpoint(state))
        self.history.append({"iter": cur_itrs, "results": results})
        return results

    def _log_panels(self, name: str, first, cur_itrs: int) -> None:
        """The first volume's middle slice: image, prediction and label
        (palette-rendered by the dataset's ``label_to_img``)."""
        if first is None:
            return
        to_img = getattr(getattr(self.test_loader, "source", None),
                         "label_to_img", None)
        if to_img is None:
            return
        image, label, pred = first
        mid = image.shape[0] // 2
        img = image[mid]
        img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
        self.writer.add_image(f"{name}/Image",
                              (img[..., None] * 255).astype(np.uint8),
                              cur_itrs)
        self.writer.add_image(f"{name}/label_pred", to_img(pred[mid]),
                              cur_itrs)
        self.writer.add_image(f"{name}/label_true", to_img(label[mid]),
                              cur_itrs)
