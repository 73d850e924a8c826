"""Double-buffered host-to-device batch pipeline (port of
``hpfg_tpu/data/prefetch.py``, without its compressed wire format).

A worker thread takes each host batch from the source iterator and, on the
card, copies it into pinned host memory and uploads it on a stream of its
own, recording an event; the training thread's ``next`` makes its current
stream wait on that event and marks each tensor as used on that stream
(``record_stream``), so the caching allocator does not hand the memory back
to the upload stream while a step still reads it. So batch N+1 crosses PCIe
while step N runs. Pinning that fails raises: there is no fallback to
pageable memory. On the CPU the worker only turns the arrays into tensors;
the thread and its error handling are the same.

Worker exceptions re-raise in the training thread (as the threaded loaders'
do, ``data/loader.py``).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator

import numpy as np
import torch

_SENTINEL = object()


class DevicePrefetcher:
    """Wrap a host batch iterator ({name: array}); yields the batches as
    tensors on ``device``, at most ``depth`` of them uploaded ahead. With
    ``limit`` the worker takes no more than that many batches from the
    source, so a fit that needs ``limit`` steps leaves the source (and its
    loaders' epochs) where the same fit without prefetching leaves it."""

    def __init__(self, batches: Iterator[dict], device, depth: int = 2,
                 limit: int | None = None):
        self._src = (batches if limit is None
                     else itertools.islice(batches, max(int(limit), 0)))
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def _upload(self, batch: dict):
        host = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
        if not self._cuda:
            return host, None
        pinned = {k: t.pin_memory() for k, t in host.items()}
        with torch.cuda.stream(self._stream):
            dev = {k: t.to(self.device, non_blocking=True)
                   for k, t in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return dev, event

    def _worker(self) -> None:
        try:
            for batch in self._src:
                if self._stop.is_set():
                    return
                if not self._put(self._upload(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 — surfaced to the consumer
            self._err = e
        self._put(_SENTINEL)

    def _put(self, item) -> bool:
        """Queue ``item`` unless ``close`` comes first; whether it was."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise RuntimeError("device prefetch worker failed") \
                    from self._err
            raise StopIteration
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)
        return batch

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker and wait up to ``timeout`` s for it to end (it
        ends once the source yields its next batch)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
