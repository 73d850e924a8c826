"""The data-parallel mesh and batch sharding (port of
``hpfg_tpu/parallel/mesh.py``).

A ``Mesh`` is the 1-D data axis over the ranks of a process group: world
size, this rank, its device and the group. Parameters, optimizer and EMA
state are replicated (every rank holds the same values); batches are split
along the leading axis, rank r holding the contiguous rows
[r*n/W, (r+1)*n/W) of a global batch of n. What GSPMD derives from the
global program in the JAX package, the port's step does with explicit
collectives (``parallel/distributed.py``); ``Rows`` tells the models where
a forward's local rows sit in the global batch, for the global BatchNorm
statistics, the hash dropout's image index and the global dropout draws.

``batch_sharding``, ``replicated`` and ``shard_cached`` have no torch
meaning and are not ported: there is no sharding object to build, and
``shard_cached`` serves the JAX trainer's ``device_cache``, which the port
does not have. A one-process mesh makes every helper the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """The data axis: ``world`` ranks, this ``rank``, its ``device`` and
    the process ``group`` (None: the default group, or one process)."""

    world: int
    rank: int
    device: torch.device
    group: Any = None
    axis: str = DATA_AXIS

    def rows(self, *segments: int, device=None) -> "Rows | None":
        """Where this rank's rows of a forward's input sit in its global
        batch, for an input that concatenates ``segments`` global batches
        (sizes n_0, n_1, ...; each split over the ranks): local row j of
        segment s is global row sum(n_<s) + rank*n_s/W + j. None in one
        process (the models then take arange, as always)."""
        if self.world == 1:
            return None
        parts, offset = [], 0
        for n in segments:
            per = local_rows(n, self.world)
            parts.append(np.arange(per) + offset + self.rank * per)
            offset += n
        index = torch.as_tensor(np.concatenate(parts), dtype=torch.int64,
                                device=device or self.device)
        return Rows(self, index, index.to(torch.int32), offset)


@dataclass(frozen=True)
class Rows:
    """A forward's local rows in the global batch: ``index`` (int64 [B]) and
    ``ids`` (the same as int32, the kernels' image-id map) on the device,
    and the global batch size ``total``."""

    mesh: Mesh
    index: torch.Tensor
    ids: torch.Tensor
    total: int

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor over the global batch."""
        return x.index_select(0, self.index)

    def expand(self, k: int) -> "Rows":
        """The rows of a tensor that holds k consecutive rows per image
        (a SwinUNet's windows): local row b*k + j is global row
        index[b]*k + j of total*k."""
        index = (self.index[:, None] * k + torch.arange(
            k, device=self.index.device)).reshape(-1)
        return Rows(self.mesh, index, index.to(torch.int32), self.total * k)


def local_rows(n: int, world: int) -> int:
    """n / world, refusing a global batch that ``world`` does not divide."""
    if n % world:
        raise ValueError(f"batch leading dim {n} does not divide the "
                         f"{world}-rank mesh; use pad_and_shard() for ragged "
                         "batches")
    return n // world


def make_mesh(device=None, group=None, axis_name: str = DATA_AXIS) -> Mesh:
    """The mesh over ``group``'s ranks (default: the default process group
    once it is formed, else this one process). ``device`` defaults to the
    one ``init_distributed`` gave this rank, else ``cuda:LOCAL_RANK``."""
    import os

    import torch.distributed as dist

    from hpfg_tpu_torch.parallel import distributed

    if device is None:
        device = distributed.rank_device() or torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        world, rank, group = 1, 0, None
    return Mesh(world, rank, torch.device(device), group, axis_name)


_MESH_CACHE: dict[tuple, Mesh] = {}


def get_mesh() -> Mesh:
    """The process-wide default mesh over every rank (cached)."""
    import torch.distributed as dist

    key = ((dist.get_world_size(), dist.get_rank())
           if dist.is_available() and dist.is_initialized() else (1, 0))
    if key not in _MESH_CACHE:
        _MESH_CACHE[key] = make_mesh()
    return _MESH_CACHE[key]


def shard_batch(mesh: Mesh, batch: Any, axis_name: str = DATA_AXIS) -> Any:
    """This rank's rows of a global host batch (a dict of arrays or
    tensors, or one array): the contiguous [r*n/W, (r+1)*n/W) of each
    leaf's leading axis; 0-d leaves stay whole. A leading dimension that W
    does not divide raises, as in the JAX package (use
    :func:`pad_and_shard` for ragged batches)."""
    if axis_name != mesh.axis:
        raise ValueError(f"unknown axis {axis_name!r}")

    def shard(x):
        if np.ndim(x) == 0:
            return x
        per = local_rows(len(x), mesh.world)
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    if isinstance(batch, dict):
        return {k: shard(v) for k, v in batch.items()}
    return shard(batch)


def pad_and_shard(mesh: Mesh, x, axis_name: str = DATA_AXIS):
    """Zero-pad the leading axis up to a multiple of W and take this rank's
    rows. Returns ``(rows, n_valid)``; consumers mask out the padded rows
    (global row index < n_valid)."""
    x = np.asarray(x)
    n_valid = x.shape[0]
    pad = (-n_valid) % mesh.world
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return shard_batch(mesh, x, axis_name), n_valid


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
