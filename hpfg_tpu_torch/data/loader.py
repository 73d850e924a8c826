"""Batch loading (port of the part of ``hpfg_tpu/data/loader.py`` the
dataset loaders use).

A thread pool assembles each batch while a background thread keeps a few
batches ready; numpy and scipy release the GIL, so decode and augmentation
overlap the step without worker processes. A transform that takes an
``rng`` argument (ACDC's and Synapse's ``RandomGenerator``) draws from a
generator derived from (loader seed, epoch, sample index), so the threaded
assembly is deterministic; the 2-D transforms (``data/augment2d.py``) draw
from the one generator they hold, as the JAX package's do, which makes
their batches reproducible at ``num_threads = 1`` only.
"""

from __future__ import annotations

import inspect
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Protocol, Sequence

import numpy as np


class SliceSource(Protocol):
    def __len__(self) -> int: ...

    def load(self, idx: int):
        """Return the raw (image, mask) numpy pair for one sample."""


class Subset:
    """Index-based view of a source (torch ``random_split``)."""

    def __init__(self, source: SliceSource, indices: Sequence[int]):
        self.source = source
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def load(self, idx: int):
        return self.source.load(self.indices[idx])


def random_split(source: SliceSource, first_len: int,
                 seed: int) -> tuple[Subset, Subset]:
    perm = np.random.default_rng(seed).permutation(len(source))
    return (Subset(source, perm[:first_len]),
            Subset(source, perm[first_len:]))


class BatchLoader:
    """Shuffled, drop-last batch iterator with threaded sample assembly.

    transform(image, mask[, rng]) runs per sample in the worker pool;
    batches are stacked into contiguous float32/int32 arrays (NHWC images,
    HxW masks).
    """

    def __init__(self, source: SliceSource, batch_size: int,
                 transform: Callable | None = None, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_threads: int = 8,
                 prefetch: int = 4):
        self.source = source
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self._epoch = 0
        self._transform_takes_rng = (
            transform is not None
            and "rng" in inspect.signature(transform.__call__).parameters)

    def __len__(self) -> int:
        n = len(self.source)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_one(self, idx: int, epoch: int = 0):
        image, mask = self.source.load(idx)
        if self.transform is not None:
            if self._transform_takes_rng:
                rng = np.random.default_rng((self.seed, epoch, int(idx)))
                image, mask = self.transform(image, mask, rng=rng)
            else:
                image, mask = self.transform(image, mask)
        return image, mask

    def _batches_for_epoch(self, epoch: int) -> list[np.ndarray]:
        n = len(self.source)
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(n)
        else:
            order = np.arange(n)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        return [order[i:i + self.batch_size]
                for i in range(0, end, self.batch_size)]

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        epoch = self._epoch
        self._epoch += 1
        batches = self._batches_for_epoch(epoch)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(
                            lambda i: self._load_one(i, epoch), idxs))
                        images = np.stack([s[0] for s in samples]).astype(np.float32)
                        masks = np.stack([s[1] for s in samples]).astype(np.int32)
                        q.put((images, masks))
                q.put(None)
            except BaseException as exc:  # surface worker errors to consumer
                q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so a blocked producer can observe `stop`
            while not q.empty():
                q.get_nowait()

    def cycle(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Eternal iteration (the labelled stream of the SSL trainers)."""
        if len(self) == 0:
            raise ValueError(
                f"loader over {len(self.source)} samples yields no batches "
                f"at batch_size={self.batch_size} (drop_last); decrease the "
                "batch size or enlarge the split")
        while True:
            yield from self


class VolumeLoader:
    """Batch-size-1 volume iterator for evaluation."""

    def __init__(self, source: SliceSource):
        self.source = source

    def __len__(self) -> int:
        return len(self.source)

    def __iter__(self):
        for i in range(len(self.source)):
            yield self.source.load(i)
