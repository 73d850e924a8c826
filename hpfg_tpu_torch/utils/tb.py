"""TensorBoard writing (port of ``hpfg_tpu/utils/tb.py``): scalars and
image panels, through ``tensorboardX`` where it imports, else
``torch.utils.tensorboard``, else a writer that writes nothing and says so
once in the log."""

from __future__ import annotations

import logging

import numpy as np


def _summary_writer():
    """(SummaryWriter class, its package) of the first TensorBoard package
    that imports, or (None, None)."""
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter, "tensorboardX"
    except ImportError:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter, "torch.utils.tensorboard"
    except ImportError:
        return None, None


class TBWriter:
    """A SummaryWriter over ``logdir``, or a no-op writer for
    ``logdir=None`` or when no TensorBoard package imports. ``backend``
    names the package in use (None for the no-op writer)."""

    def __init__(self, logdir: str | None,
                 logger: logging.Logger | None = None):
        self._writer = None
        self.backend = None
        if logdir is None:
            return
        cls, backend = _summary_writer()
        if cls is None:
            (logger or logging.getLogger("hpfg_tpu_torch")).warning(
                "TensorBoard: neither tensorboardX nor "
                "torch.utils.tensorboard imports; the writer is a no-op")
            return
        self._writer = cls(logdir)
        self.backend = backend

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(np.asarray(value)), step)

    def add_scalars(self, scalars: dict, step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}/{k}" if prefix else k, v, step)

    def add_image(self, tag: str, img, step: int,
                  dataformats: str = "HWC") -> None:
        if self._writer is not None:
            self._writer.add_image(tag, np.asarray(img), step,
                                   dataformats=dataformats)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
