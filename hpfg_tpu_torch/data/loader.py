"""Batch loading (port of ``hpfg_tpu/data/loader.py``: what the dataset
loaders use, and the reference's ``patients_to_slices``).

A thread pool assembles each batch while a background thread keeps a few
batches ready; numpy and scipy release the GIL, so decode and augmentation
overlap the step without worker processes. A transform that takes an
``rng`` argument (ACDC's and Synapse's ``RandomGenerator``) draws from a
generator derived from (loader seed, epoch, sample index), so the threaded
assembly is deterministic; the 2-D transforms (``data/augment2d.py``) draw
from the one generator they hold, as the JAX package's do, which makes
their batches reproducible at ``num_threads = 1`` only.

Data parallelism (``BatchLoader.shard``): each rank's loader yields its
contiguous 1/W of every global batch, so each process materializes only
its own shard. The index permutation is seeded alike on every rank, so the
ranks together visit exactly the indices of a one-process run. The draws
of an ``rng`` transform depend on the sample alone and equal the
one-process ones; a 2-D transform's one generator is a per-rank stream
(each rank's copy draws for its own rows), so those draws differ from a
one-process run's. The eval is split by whole items instead
(``share``): rank r loads the volumes, or the test batches, whose index is
r modulo W.
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
        self.rank, self.world = 0, 1
        self._epoch = 0
        self._transform_takes_rng = (
            transform is not None
            and "rng" in inspect.signature(transform.__call__).parameters)

    def shard(self, rank: int, world: int) -> "BatchLoader":
        """Yield rank ``rank``'s contiguous 1/``world`` of each global batch
        of ``batch_size`` (which ``world`` must divide) from here on;
        returns the loader."""
        if self.batch_size % world:
            raise ValueError(f"global batch size {self.batch_size} does not "
                             f"divide over {world} ranks")
        if not self.drop_last:
            raise ValueError("a rank-sharded loader drops the last batch")
        self.rank, self.world = int(rank), int(world)
        return self

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
        per = self.batch_size // self.world
        lo = self.rank * per
        return [order[i + lo:i + lo + per]
                for i in range(0, end, self.batch_size)]

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        epoch = self._epoch
        self._epoch += 1
        yield from self._assemble(self._batches_for_epoch(epoch), epoch)

    def share(self, rank: int, world: int):
        """One pass (an epoch) of a loader that is not rank-sharded, over
        the batches whose index j is ``rank`` modulo ``world``, as (j,
        batch): a rank's part of an eval over the ranks."""
        if self.world > 1:
            raise ValueError("share() splits a whole loader's batches; this "
                             "one is rank-sharded")
        epoch = self._epoch
        self._epoch += 1
        batches = self._batches_for_epoch(epoch)
        picked = list(range(rank, len(batches), world))
        return zip(picked, self._assemble([batches[j] for j in picked],
                                          epoch))

    def _assemble(self, batches: list, epoch: int):
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

    def share(self, rank: int, world: int):
        """(i, volume) for the volumes whose index i is ``rank`` modulo
        ``world``: a rank's part of an eval over the ranks, which loads
        only its own volumes."""
        for i in range(rank, len(self.source), world):
            yield i, self.source.load(i)


def patients_to_slices(dataset: str, patients_num) -> int:
    """The reference's count of labelled slices for a count of labelled
    patients: ACDC's table, or for any ``dataset`` without "ACDC" in its
    name the Prostate table; an unlisted count raises KeyError."""
    if "ACDC" in dataset:
        ref = {"3": 68, "7": 136, "14": 256, "21": 396, "28": 512,
               "35": 664, "140": 1312}
    else:
        ref = {"2": 27, "4": 53, "8": 120, "12": 179, "16": 256,
               "21": 312, "42": 623}
    return ref[str(patients_num)]
