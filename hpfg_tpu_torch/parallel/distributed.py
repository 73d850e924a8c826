"""Multi-process data parallelism (port of ``hpfg_tpu/parallel/distributed.py``).

One process per rank, each on its own device (or several ranks on one card
over gloo). The JAX package gets its global program from GSPMD; torch has
none, so the port's step computes the one-process result with explicit
collectives:

  * ``init_distributed`` joins the process group, from its arguments or
    torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``); a plain run with neither stays one process;
  * per-process host data loading: each process materializes only its own
    shard of the global batch (``data.loader.BatchLoader.shard``) and the
    step sees only its rows;
  * process-0 gating for logging / TensorBoard / checkpoint writes
    (``is_main_process``), and barriers that never hang
    (``coordination_barrier``);
  * ``gather_objects``, the eval's exchange of its small per-volume rows
    over the rendezvous store, on a client connection of its own: the eval
    runs on a worker thread while the training thread's steps issue
    collectives, and collectives of one group issued from two threads can
    run in a different order on each rank;
  * the collectives the step needs, each the identity in one process:
    ``all_reduce_sum`` and ``all_gather_rows`` (differentiable),
    ``gather_rows`` (not), ``broadcast_tensors`` and ``all_reduce_grads``.
    They use only all_reduce, broadcast and barrier, which NCCL and gloo
    both take on CUDA and on CPU tensors.

The scaling rule the step relies on: every rank computes the same global
loss; the backward of each collective sums the W ranks' upstream
gradients, so every rank's parameter gradients come out W times its share
of the one-process gradient, and ``all_reduce_grads`` (the sum over ranks,
divided by W) gives that gradient exactly.
"""

from __future__ import annotations

import os
import pickle
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from hpfg_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

#: the default deadline of init and of every collective (seconds)
DEFAULT_TIMEOUT_S = 600.0
#: how long a rank waits for the others at the trainer's barriers and at
#: the eval's exchange of rows (seconds): a rank's share of the test set
#: may take longer than its peers'
BARRIER_TIMEOUT_S = 1800.0

_STATE: dict = {"store": None, "eval_store": None, "device": None,
                "barriers": {}}


def _address(coordinator_address: str) -> str:
    addr = str(coordinator_address)
    return addr if "://" in addr else f"tcp://{addr}"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device=None, backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group if one is asked for; return True when the
    run has more than one process.

    ``coordinator_address`` (``host:port`` or ``tcp://host:port``),
    ``num_processes`` and ``process_id`` default to torchrun's
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; with neither
    arguments nor variables this is a no-op. ``device`` (default
    ``cuda:LOCAL_RANK``) is this rank's device. ``backend=None`` picks NCCL
    when the ranks run on CUDA devices and gloo when they run on the CPU;
    ranks that share a card must pass ``backend="gloo"``, since NCCL refuses
    two ranks on one device. Nothing falls back: a group that cannot form
    raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes asked for without a "
                             "coordinator address (MASTER_ADDR)")
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and "
                         "process_id (WORLD_SIZE and RANK)")
    if device is None:
        device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if backend is None:
        backend = "gloo" if device.type == "cpu" else "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {device}")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)

    timeout = timedelta(seconds=timeout_s)
    store, rank, world = next(dist.rendezvous(
        _address(coordinator_address), rank=int(process_id),
        world_size=int(num_processes), timeout=timeout))
    store.set_timeout(timeout)
    if backend == "nccl":
        _refuse_shared_cards(store, rank, world, device)
    dist.init_process_group(backend, store=dist.PrefixStore("pg", store),
                            rank=rank, world_size=world, timeout=timeout)
    # the eval's rows go through a connection of their own: a store client
    # serves one request at a time, and the training thread's barrier must
    # not queue behind the eval thread's wait for its peers' rows
    _STATE.update(store=dist.PrefixStore("hpfg", store),
                  eval_store=dist.PrefixStore("hpfg-eval", store.clone()),
                  device=device, barriers={})
    return world > 1


def _refuse_shared_cards(store, rank: int, world: int, device) -> None:
    """Raise on every rank when two ranks of one host sit on one card."""
    import socket

    key = f"{socket.gethostname()}:{device.index}"
    store.set(f"card/{rank}", key)
    keys = [store.get(f"card/{r}").decode() for r in range(world)]
    if len(set(keys)) < world:
        raise ValueError(
            f"ranks share a CUDA device ({sorted(keys)}); NCCL allows one "
            "rank per device: pass backend=\"gloo\" (--set dist_backend=gloo)"
            " to run several ranks on one card")


def rank_device() -> torch.device | None:
    """The device ``init_distributed`` gave this rank (None before)."""
    return _STATE["device"]


def is_main_process() -> bool:
    """True on the process that owns logging / TB / checkpoint writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_batch_from_local(mesh: Mesh, local_batch: dict,
                            axis_name: str = DATA_AXIS) -> dict:
    """This rank's rows of a batch (its loader's 1/W of the global batch),
    placed on its device as tensors. Unlike the JAX function, no global
    array is assembled: each rank's step runs on its rows and the
    collectives make the result global."""
    if axis_name != mesh.axis:
        raise ValueError(f"unknown axis {axis_name!r}")
    return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)))
            .to(mesh.device) for k, v in local_batch.items()}


def sync_global_devices(tag: str = "barrier") -> None:
    """Barrier over every rank (around checkpoint writes); a no-op in one
    process."""
    if process_count() > 1:
        dist.barrier()


def coordination_barrier(tag: str = "barrier",
                         timeout_s: float = 1200.0) -> None:
    """Barrier over the rendezvous store, not a device collective: every
    rank writes its key for the tag's next round and waits for all W keys.
    A dead or hung peer makes it raise ``RuntimeError`` once ``timeout_s``
    has passed (at once where the process that hosts the store is gone); it
    never hangs. A no-op in one process."""
    if process_count() <= 1:
        return
    store = _STATE["store"]
    if store is None:
        raise RuntimeError("coordination_barrier: the process group was not "
                           "formed by init_distributed")
    n = _STATE["barriers"].get(tag, 0)
    _STATE["barriers"][tag] = n + 1
    rank, world = dist.get_rank(), dist.get_world_size()
    prefix = f"barrier/{tag}/{n}"
    try:
        store.set(f"{prefix}/{rank}", "1")
        store.wait([f"{prefix}/{r}" for r in range(world)],
                   timedelta(seconds=timeout_s))
    except Exception as exc:
        raise RuntimeError(f"coordination_barrier {tag!r} (round {n}): not "
                           f"every rank of {world} arrived within "
                           f"{timeout_s} s: {exc}") from exc


def gather_objects(tag: str, obj, timeout_s: float = BARRIER_TIMEOUT_S
                   ) -> list:
    """Every rank's ``obj`` (small and picklable), in rank order, on every
    rank: each rank writes its own under the tag's next round and reads
    the W entries once all are there. A rank writes round n only after it
    has read round n - 1, so once round n is complete rank 0 deletes
    round n - 1's entries: the store holds one round a tag. Goes through
    the rendezvous store on the eval's own connection, never through a
    process group, so it may run on a worker thread while the training
    thread issues collectives. A dead
    or hung peer makes it raise ``RuntimeError`` once ``timeout_s`` has
    passed; it never hangs. In one process: ``[obj]``, with no call at
    all."""
    if process_count() <= 1:
        return [obj]
    store = _STATE["eval_store"]
    if store is None:
        raise RuntimeError("gather_objects: the process group was not "
                           "formed by init_distributed")
    key = f"gather {tag}"
    n = _STATE["barriers"].get(key, 0)
    _STATE["barriers"][key] = n + 1
    rank, world = dist.get_rank(), dist.get_world_size()
    keys = [f"gather/{tag}/{n}/{r}" for r in range(world)]
    try:
        store.set(keys[rank], pickle.dumps(obj))
        store.wait(keys, timedelta(seconds=timeout_s))
        out = [pickle.loads(store.get(k)) for k in keys]
        if rank == 0 and n > 0:
            for r in range(world):
                store.delete_key(f"gather/{tag}/{n - 1}/{r}")
        return out
    except Exception as exc:
        raise RuntimeError(f"gather_objects {tag!r} (round {n}): not every "
                           f"rank of {world} arrived within {timeout_s} s: "
                           f"{exc}") from exc


# ---------------------------------------------------------------------------
# collectives (the identity in one process)
# ---------------------------------------------------------------------------

def spans_ranks(mesh: Mesh | None) -> bool:
    """Whether ``mesh`` is a data axis over more than one rank."""
    return mesh is not None and mesh.world > 1


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, group=mesh.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone().contiguous()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank; differentiable, its
    backward the sum of the ranks' upstream gradients."""
    if not spans_ranks(mesh):
        return x
    return _AllReduceSum.apply(x, mesh)


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = x.shape[0]
    buf = x.new_zeros((mesh.world * n,) + tuple(x.shape[1:]))
    buf[mesh.rank * n:(mesh.rank + 1) * n] = x.detach()
    dist.all_reduce(buf, group=mesh.group)
    return buf


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh, n = ctx.mesh, ctx.n
        g = g.detach().clone().contiguous()
        dist.all_reduce(g, group=mesh.group)
        return g[mesh.rank * n:(mesh.rank + 1) * n], None


def all_gather_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """[n, ...] rows of every rank -> [W*n, ...] in rank order, on every
    rank (each rank writes its rows into a zeroed buffer, which is
    all-reduced: exact, as x + 0 = x). Differentiable: the backward
    all-reduces the gradient and keeps this rank's rows."""
    if not spans_ranks(mesh):
        return x
    return _AllGatherRows.apply(x, mesh)


def gather_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """:func:`all_gather_rows` without a gradient (input rows: images,
    labels)."""
    if not spans_ranks(mesh):
        return x
    with torch.no_grad():
        return _gather(x, mesh)


def broadcast_tensors(tensors, mesh: Mesh | None, src: int = 0) -> None:
    """Overwrite each tensor, in place, with rank ``src``'s."""
    if not spans_ranks(mesh):
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src, group=mesh.group)


def broadcast_modules(modules, mesh: Mesh | None, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers into every rank's modules."""
    if not spans_ranks(mesh):
        return
    broadcast_tensors([t for m in modules for t in m.state_dict().values()],
                      mesh, src)


def all_reduce_grads(params, mesh: Mesh | None) -> None:
    """Average the gradients over the ranks in place: one all-reduce of a
    flat bucket per dtype, then a division by W. Parameters without a
    gradient are left alone (every rank has the same set)."""
    if not spans_ranks(mesh):
        return
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    with torch.no_grad():
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=mesh.group)
            flat.div_(mesh.world)
            i = 0
            for g in grads:
                g.copy_(flat[i:i + g.numel()].view_as(g))
                i += g.numel()
