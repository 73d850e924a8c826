"""Profiling utilities (port of ``hpfg_tpu/utils/profiling.py``): a
``torch.profiler`` trace, named spans, device memory statistics, a step
timer, FLOP counting and model-FLOPs utilization.

``count_flops`` runs the function under ``FlopCounterMode``, which sees the
aten ops (convolutions, matmuls, attention) but not a ctypes kernel launch:
the hand-written kernels report their analytic operations to it themselves
(``ops/_cuda.counted``), so a step on the card counts what the same step
counts on the CPU, where the wrappers run their plain versions.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (host ops, and the card's kernels where
    there is one) and write ``<logdir>/trace.json``, a Chrome trace that
    Perfetto and ``chrome://tracing`` read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span in the profiler's timeline, and an NVTX range where a
    card is in use."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of each card, by device name; an empty
    dict for the CPU, as the JAX package's CPU device gives."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


class StepTimer:
    """Rolling images/sec and ms/step meter for training loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def ms_per_step(self) -> float:
        if not self._times:
            return float("nan")
        return 1000.0 * sum(self._times) / len(self._times)

    def images_per_sec(self, batch_size: int) -> float:
        ms = self.ms_per_step
        return batch_size / (ms / 1000.0) if ms == ms else float("nan")


def count_flops(fn, *args) -> float:
    """FLOPs of ``fn(*args)`` (one call, forward and backward where ``fn``
    runs both) as ``FlopCounterMode`` counts them: 2 per multiply-add of
    the convolutions, matmuls and attention, nothing for elementwise ops."""
    from torch.utils.flop_counter import FlopCounterMode

    from hpfg_tpu_torch.ops._cuda import reporting_flops

    # reporting_flops registers the kernels' FLOP formula, which the
    # counter must find in the registry when it is built
    with reporting_flops(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


#: dense bf16 peak FLOP/s by ``torch.cuda.get_device_name`` (NVIDIA's data
#: sheet, without sparsity, at the full power limit)
_PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def chip_peak_flops(device=None) -> float | None:
    """bf16 peak FLOP/s of ``device`` (default: the current card), or None
    for the CPU and for a card this table does not know."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return _PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device))


def mfu(flops_per_step: float, step_seconds: float,
        device=None) -> float | None:
    """Model-FLOPs utilization: ``flops_per_step`` (``count_flops`` of the
    step) over ``step_seconds``, as a share of the card's bf16 peak. None
    where the peak is unknown (the CPU) or the inputs are not usable."""
    peak = chip_peak_flops(device)
    if peak is None or not (flops_per_step == flops_per_step) \
            or step_seconds <= 0:
        return None
    return flops_per_step / step_seconds / peak
