"""BatchNorm-affine + LeakyReLU forward and backward: kernels C and D.

Replaces (hpfg_tpu/ops/pallas/conv_block.py):
  * ``bn_act``     -> ``_bn_act_kernel`` (K3): y = lrelu(a*g + b);
  * ``bn_act_bwd`` -> ``_bwd_reduce_kernel`` (K4) + ``_dpre_kernel`` (K5):
    per-channel S0 = sum(dz), S1 = sum(dz*xhat) with dz = dy*lrelu'(a*pre+b)
    and xhat = (pre-mean)*inv, then dpre = a*(dz - S0/N - xhat*S1/N);
  * ``bn_act_dpre`` -> ``_dpre_kernel`` (K5) alone, for the stage whose
    S0, S1 the conv2 dgrad already reduced in its epilogue (K11), or whose
    sums were all-reduced over the ranks of a data-parallel run;
  * ``bn_reduce`` -> ``_bwd_reduce_kernel`` (K4) alone: D's reduce, whose
    per-rank sums a data-parallel run all-reduces before ``bn_act_dpre``.

The kernels are CUDA C++ in ``csrc/bn_act.cu`` (``bn_act_kernel``,
``bn_reduce_kernel``, ``bn_dpre_kernel``), which says what bounds them on an
H100 (bytes) and how they are built: one streaming walk in which each
thread owns a fixed group of channels and loads four steps of rows before
it uses the first (``bn_walk`` sizes it: one CTA per turn for C and dpre, a
persistent grid for D's reduce), 16-byte accesses, and D's cross-CTA sum
finished inside its reduce kernel by the last CTA to arrive, in a fixed
order. ``bn_act`` and ``bn_act_dpre`` are one launch each.

A full ``bn_act_bwd`` is one launch of D's cooperative kernel
(``bn_coop_kernel``) where the vector path applies (:func:`bn_route`): a
grid that fills the card, the reduce, a grid barrier, the column sums
finished in parallel, a second barrier, then dpre, either from the rows
each CTA still holds in shared memory (form "hold", where dy and pre fit
the resident CTAs: three HBM passes) or streamed again in reverse ("stream");
:func:`coop_plan` picks the form from the bytes and the occupancy API.
``bn_reduce`` alone takes the same kernel's first two phases. The element
path keeps PR 6's two kernels ("walk": reduce, then dpre). Each route
counts its launches in ``<wrapper>.routes``.

Each wrapper takes its plain PyTorch version for CPU tensors only; for a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import NamedTuple

import torch

from hpfg_tpu_torch.ops._cuda import (
    counted,
    launch_counter,
    library,
    ptr,
    sm_count,
    stream,
    ticket,
)

LRELU_SLOPE = 0.01

# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def bn_act_reference(g: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """y = lrelu(a*g + b) in fp32, stored in g's dtype."""
    z = g.float() * a + b
    return torch.where(z >= 0, z, z * LRELU_SLOPE).to(g.dtype)


def _dz_xhat(dy, pre, a, b, mean, inv):
    pf = pre.float()
    z = pf * a + b
    dz = dy.float() * torch.where(z >= 0, 1.0, LRELU_SLOPE)
    return dz, (pf - mean) * inv


def bn_act_dpre_reference(dy, pre, a, b, mean, inv, sums):
    """The elementwise pass alone: dpre = a*(dz - S0/N - xhat*S1/N) from
    given sums [2, F] fp32, in dy's dtype."""
    dz, xhat = _dz_xhat(dy, pre, a, b, mean, inv)
    n = dy.numel() // dy.shape[-1]
    return (a * (dz - sums[0] / n - xhat * (sums[1] / n))).to(dy.dtype)


def bn_reduce_reference(dy, pre, a, b, mean, inv):
    """The reduction alone: sums [2, F] fp32 = [S0, S1] = [dbias, dscale]."""
    dz, xhat = _dz_xhat(dy, pre, a, b, mean, inv)
    dims = tuple(range(dy.dim() - 1))
    return torch.stack([dz.sum(dims), (dz * xhat).sum(dims)])


def bn_act_bwd_reference(dy, pre, a, b, mean, inv):
    """Train-mode BN + LeakyReLU backward. Returns (sums [2, F] fp32 =
    [dbias, dscale], dpre in dy's dtype)."""
    sums = bn_reduce_reference(dy, pre, a, b, mean, inv)
    return sums, bn_act_dpre_reference(dy, pre, a, b, mean, inv, sums)


# ---------------------------------------------------------------------------
# the kernels' walk (csrc/bn_act.cu)
# ---------------------------------------------------------------------------

CTA_THREADS = 256  # bn_act.cu NT
TURN_STEPS = 4  # bn_act.cu U


class BnWalk(NamedTuple):
    """How kernels C and D split a [P, F] activation over CTAs: a thread
    owns ``vec`` contiguous channels (one of G = F / vec groups), a CTA
    covers ``cols`` groups of ``rows_per_step`` rows a step (``steps`` of
    them), turn k is the TURN_STEPS consecutive steps from k * TURN_STEPS,
    the grid is (``ctas``, ``chunks``) with chunk y taking groups [y*cols,
    (y+1)*cols), and CTA x walks turns x, x + ctas, ... of ``turns``. D's
    reduce writes one partial row of ``part_width`` floats per CTA x."""

    vec: int
    cols: int
    rows_per_step: int
    steps: int
    turns: int
    ctas: int
    chunks: int
    part_width: int
    p: int

    def rows(self, x: int) -> list[int]:
        """The rows CTA x walks, in its order (each with every chunk)."""
        span = TURN_STEPS * self.rows_per_step
        return [row for k in range(x, self.turns, self.ctas)
                for row in range(k * span, min(k * span + span, self.p))]


def bn_walk(p: int, f: int, elem_bytes: int, aligned: bool = True,
            resident: int | None = None) -> BnWalk:
    """The walk of kernels C and D over p rows of f channels of
    ``elem_bytes`` each; the kernels take its sizes as they are. The
    vector path (16 bytes a thread) needs f % V == 0 and 16-byte aligned
    pointers, else one element a thread. C and dpre
    (``resident`` None) launch one CTA per turn. D's reduce, whose CTAs
    each write a partial row, takes a persistent grid: at most the
    ``resident`` CTAs the card holds at once, and at most about
    sqrt(p * elem_bytes / 4), which balances the bytes each CTA streams
    (2 f es p / ctas) against the partial bytes the last CTA reads back
    (8 f ctas)."""
    v = 16 // elem_bytes
    vec = v if aligned and f % v == 0 else 1
    groups = f // vec
    cols = min(groups, CTA_THREADS)
    chunks = -(-groups // cols)
    rows = CTA_THREADS // cols
    steps = -(-p // rows)
    turns = -(-steps // TURN_STEPS)
    ctas = turns
    if resident is not None:
        ctas = min(turns, resident // chunks,
                   math.isqrt(p * elem_bytes // 4))
    return BnWalk(vec, cols, rows, steps, turns, max(1, ctas), chunks,
                  -(-2 * f // 4) * 4, p)


# ---------------------------------------------------------------------------
# D's cooperative kernel (csrc/bn_act.cu bn_coop_kernel)
# ---------------------------------------------------------------------------

#: D's routes: "hold" and "stream", the cooperative kernel's two forms (one
#: launch), and "walk", PR 6's reduce and dpre kernels (two launches)
BN_ROUTES = ("hold", "stream", "walk")
#: bytes of each of dy and pre in one ring stage of the cooperative kernel
COOP_CHUNK_BYTES = 8192
#: ring stages of the stream form
COOP_STREAM_STAGES = 4
#: the most CTAs an SM the cooperative grid takes in the hold and the
#: stream form (the hold form at one: a CTA of an SM's whole shared memory
#: timed faster than two of half at 14^2-56^2, scripts/tune_bn_act.py;
#: PERF.md), and the most held stages the stream form keeps beside its
#: ring
COOP_HOLD_CTAS_PER_SM = 1
COOP_STREAM_CTAS_PER_SM = 2
COOP_MAX_HELD = 32
#: the kernel's limits (bn_act.cu COOP_MAX_STAGES, COOP_MAX_DYNAMIC)
COOP_MAX_STAGES = 32
COOP_MAX_DYNAMIC = 232448 - (2 * 8 * CTA_THREADS * 4 + COOP_MAX_STAGES * 8)


def bn_route(f: int, elem_bytes: int, aligned: bool) -> str:
    """Whether D takes its cooperative kernel ("coop") or PR 6's two
    kernels ("walk"): the bulk copies need rows of whole 16-byte groups
    (F a multiple of 16 / elem_bytes) and 16-byte aligned pointers, and a
    CTA of 256 threads at most 256 groups."""
    v = 16 // elem_bytes
    ok = aligned and f % v == 0 and f // v <= CTA_THREADS
    return "coop" if ok else "walk"


class CoopPlan(NamedTuple):
    """A launch of D's cooperative kernel: ``form`` "hold" or "stream",
    ``ctas`` (every SM, ``ctas`` / SMs CTAs each), ``chunk_rows`` rows a
    chunk (CTA i takes chunks i, i + ctas, ...: :func:`coop_chunks`),
    ``stages`` ring stages (none in the hold form), ``held`` stages that
    keep a CTA's last chunks (hold: one per chunk of the CTA with the
    most), ``smem`` dynamic bytes."""

    form: str
    ctas: int
    chunk_rows: int
    stages: int
    held: int
    smem: int


def coop_plan(p: int, f: int, elem_bytes: int, sms: int, occupancy,
              reduce_only: bool = False, form: str | None = None
              ) -> CoopPlan:
    """The cooperative kernel's plan for p rows of f channels: "hold" where
    every CTA's chunks of dy and pre fit its shared memory at k CTAs an SM
    (k = COOP_HOLD_CTAS_PER_SM, then fewer) and the occupancy API
    (``occupancy(smem)``: CTAs an SM at that dynamic shared memory) holds
    k of them; else "stream": a ring of COOP_STREAM_STAGES stages at the
    most CTAs an SM (at most COOP_STREAM_CTAS_PER_SM) the occupancy API holds
    with it, and beside the ring as many held stages (at most
    COOP_MAX_HELD) as keep that many CTAs an SM. The reduce alone
    (``reduce_only``) streams, with no held stage: it reads each row
    once. ``form`` forces "stream", or
    "hold" where it fits (else ValueError): the timings and tests of both
    forms at one shape."""
    row = f * elem_bytes
    if not reduce_only and form != "stream":
        for k in range(COOP_HOLD_CTAS_PER_SM, 0, -1):
            cr = coop_chunk_rows(p, row, sms * k)
            nck = -(-(-(-p // cr)) // (sms * k))
            smem = nck * 2 * cr * row
            if (nck <= COOP_MAX_STAGES and smem <= COOP_MAX_DYNAMIC
                    and occupancy(smem) >= k):
                return CoopPlan("hold", sms * k, cr, 0, nck, smem)
    if form == "hold":
        raise ValueError(f"the hold form does not fit {p} rows of {f}")
    ring = COOP_STREAM_STAGES
    most = 2 * max(1, COOP_CHUNK_BYTES // row) * row  # a stage at most
    k = min(COOP_STREAM_CTAS_PER_SM, occupancy(ring * most))
    if k < 1:
        raise RuntimeError(f"bn_coop_kernel: no CTA of {ring * most} "
                           f"bytes fits an SM")
    cr = coop_chunk_rows(p, row, sms * k)
    stage = 2 * cr * row
    held = 0
    while (not reduce_only and held < COOP_MAX_HELD
           and ring + held + 1 <= COOP_MAX_STAGES
           and (ring + held + 1) * stage <= COOP_MAX_DYNAMIC
           and occupancy((ring + held + 1) * stage) >= k):
        held += 1
    return CoopPlan("stream", sms * k, cr, ring, held,
                    (ring + held) * stage)


def coop_chunk_rows(p: int, row_bytes: int, ctas: int) -> int:
    """Rows a chunk of the cooperative kernel: at most COOP_CHUNK_BYTES of
    each tensor, and as many as split the p rows evenly over ``ctas``
    CTAs (each takes the same number of chunks, but the last few)."""
    most = max(1, COOP_CHUNK_BYTES // row_bytes)
    per_cta = -(-p // (ctas * most))
    return max(1, -(-p // (ctas * per_cta)))


def coop_chunks(p: int, plan: CoopPlan, cta: int) -> list[tuple[int, int]]:
    """(first row, rows) of CTA ``cta``'s chunks, in its order: the grid's
    chunks of ``plan.chunk_rows`` rows, cta, cta + ctas, ..."""
    cr = plan.chunk_rows
    return [(g * cr, min(cr, p - g * cr))
            for g in range(cta, -(-p // cr), plan.ctas)]


_WALKS: dict[tuple, BnWalk] = {}


def _walk(reduce: bool, t: torch.Tensor, ptrs: tuple[int, ...]):
    """(library, bn_walk) for C or dpre, or D's reduce, on ``t`` [..., F]
    whose call passes the pointers ``ptrs`` (the vector path needs every one
    16-byte aligned). Walks are cached by shape."""
    lib = library(t.device)
    f = t.shape[-1]
    dev = t.device.index
    aligned = not any(q & 15 for q in ptrs)
    key = (reduce, t.numel(), f, t.element_size(), dev, aligned)
    w = _WALKS.get(key)
    if w is None:
        resident = None
        if reduce:
            resident = sm_count(t.device) * lib.bn_reduce_ctas_per_sm(
                t.dtype == torch.bfloat16)
        w = _WALKS[key] = bn_walk(t.numel() // f, f, t.element_size(),
                                  aligned, resident)
    return lib, w


def _counter(device: torch.device) -> torch.Tensor:
    """The device's ticket counter of D's reduce."""
    return ticket(device, "bn_reduce")


def _check(name: str, t: torch.Tensor, like: torch.Tensor | None = None,
           dtype=None, shape=None) -> None:
    if like is not None and (t.device != like.device or t.shape != like.shape
                             or t.dtype != like.dtype):
        raise ValueError(f"{name}: expected {tuple(like.shape)} "
                         f"{like.dtype} on {like.device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and t.shape != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_vecs(ref: torch.Tensor, **vecs) -> None:
    """Each vector fp32 [F], contiguous, on ref's device."""
    shape, dev = (ref.shape[-1],), ref.device
    for name, v in vecs.items():
        if (v.dtype != torch.float32 or v.shape != shape or v.device != dev
                or not v.is_contiguous()):
            _check(name, v, dtype=torch.float32, shape=shape)
            raise ValueError(f"{name}: on {v.device}, data on {dev}")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@launch_counter
def bn_act(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = lrelu(a*g + b) over NHWC ``g`` (bf16 or fp32) with per-channel
    fp32 ``a``, ``b`` [F]; y in g's dtype."""
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bn_act: unsupported dtype {g.dtype}")
    _check("g", g)
    _check_vecs(g, a=a, b=b)
    if g.device.type == "cpu":
        return bn_act_reference(g, a, b)
    _require_cuda(g)
    y = torch.empty_like(g)
    ptrs = (ptr(g), ptr(a), ptr(b), ptr(y))
    lib, w = _walk(False, g, ptrs)
    lib.call("hpfg_bn_act", *ptrs, w.p, g.shape[-1], w.cols,
             w.rows_per_step, int(g.dtype == torch.bfloat16), int(w.vec > 1), w.ctas,
             w.chunks, stream(g))
    counted(bn_act, g)
    return y


@launch_counter
def bn_act_bwd(dy: torch.Tensor, pre: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor):
    """Backward of y = lrelu(BN(pre)) under train-mode BN. ``a``, ``b`` are
    the folded affine, ``mean``/``inv`` the batch statistics, all fp32 [F].
    Returns (sums [2, F] fp32 = [dbias, dscale], dpre in dy's dtype)."""
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bn_act_bwd: unsupported dtype {dy.dtype}")
    _check("dy", dy)
    _check("pre", pre, like=dy)
    _check_vecs(dy, a=a, b=b, mean=mean, inv=inv)
    if dy.device.type == "cpu":
        return bn_act_bwd_reference(dy, pre, a, b, mean, inv)
    _require_cuda(dy)
    route = _route(dy, pre, a, b, mean, inv)
    if route == "walk":
        sums = _reduce(dy, pre, a, b, mean, inv)
        dpre = _dpre(dy, pre, a, b, mean, inv, sums)
    else:
        dpre = torch.empty_like(dy)
        sums, route = _coop(dy, pre, a, b, mean, inv, dpre)
    counted(bn_act_bwd.routes[route], dy)
    counted(bn_act_bwd, dy)
    return sums, dpre


@launch_counter
def bn_reduce(dy: torch.Tensor, pre: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, mean: torch.Tensor,
              inv: torch.Tensor) -> torch.Tensor:
    """Kernel D's reduce alone: sums [2, F] fp32 = [S0, S1] = [dbias,
    dscale] of :func:`bn_act_bwd`, for a caller that combines them before
    ``bn_act_dpre`` (a data-parallel run all-reduces them over its ranks)."""
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bn_reduce: unsupported dtype {dy.dtype}")
    _check("dy", dy)
    _check("pre", pre, like=dy)
    _check_vecs(dy, a=a, b=b, mean=mean, inv=inv)
    if dy.device.type == "cpu":
        return bn_reduce_reference(dy, pre, a, b, mean, inv)
    _require_cuda(dy)
    route = _route(dy, pre, a, b, mean, inv)
    if route == "walk":
        sums = _reduce(dy, pre, a, b, mean, inv)
    else:
        sums, route = _coop(dy, pre, a, b, mean, inv, None)
    counted(bn_reduce.routes[route], dy)
    counted(bn_reduce, dy)
    return sums


def _route(dy, pre, a, b, mean, inv) -> str:
    """:func:`bn_route` of a call (its pointers' alignment included)."""
    aligned = not any(t.data_ptr() & 15 for t in (dy, pre, a, b, mean, inv))
    return bn_route(dy.shape[-1], dy.element_size(), aligned)


_PLANS: dict[tuple, CoopPlan] = {}


def _plan(dy, reduce_only: bool, form: str | None = None) -> CoopPlan:
    """:func:`coop_plan` of a call on CUDA ``dy`` [..., F] (cached by
    shape), from the device's SMs and the occupancy API."""
    f = dy.shape[-1]
    p = dy.numel() // f
    bf16 = dy.dtype == torch.bfloat16
    key = (p, f, bf16, dy.device.index, reduce_only, form)
    plan = _PLANS.get(key)
    if plan is None:
        lib = library(dy.device)
        plan = _PLANS[key] = coop_plan(
            p, f, dy.element_size(), sm_count(dy.device),
            lambda smem: lib.bn_coop_ctas_per_sm(bf16, smem),
            reduce_only=reduce_only, form=form)
    return plan


def _coop(dy, pre, a, b, mean, inv, dpre, form=None):
    """One launch of D's cooperative kernel: the full backward into
    ``dpre``, or the reduce alone (``dpre`` None). Returns (sums [2, F],
    the plan's form). ``form``: :func:`coop_plan`'s."""
    lib = library(dy.device)
    f = dy.shape[-1]
    p = dy.numel() // f
    bf16 = dy.dtype == torch.bfloat16
    plan = _plan(dy, dpre is None, form)
    # one buffer: the CTAs' partial rows, then the sums [2, F]
    buf = torch.empty((plan.ctas + 1) * 2 * f, dtype=torch.float32,
                      device=dy.device)
    sums = buf[plan.ctas * 2 * f:].view(2, f)
    lib.call("hpfg_bn_coop", ptr(dy), ptr(pre), ptr(a), ptr(b), ptr(mean),
             ptr(inv), ptr(buf), ptr(sums), ptr(dpre),
             ptr(ticket(dy.device, "bn_coop")), p, f, plan.chunk_rows,
             plan.stages, plan.held, int(bf16), plan.ctas, plan.smem,
             stream(dy))
    return sums, plan.form


def _reduce(dy, pre, a, b, mean, inv):
    f = dy.shape[-1]
    ptrs = (ptr(dy), ptr(pre), ptr(a), ptr(b), ptr(mean), ptr(inv))
    lib, w = _walk(True, dy, ptrs)
    # one buffer: the CTAs' partial rows, then the sums [2, F]
    buf = torch.empty(w.ctas * w.part_width + 2 * f, dtype=torch.float32,
                      device=dy.device)
    sums = buf[w.ctas * w.part_width:].view(2, f)
    lib.call("hpfg_bn_reduce", *ptrs, ptr(buf), ptr(sums),
             ptr(_counter(dy.device)), w.p, f, w.cols, w.rows_per_step,
             int(dy.dtype == torch.bfloat16), int(w.vec > 1), w.ctas,
             w.chunks, w.part_width, stream(dy))
    return sums


@launch_counter
def bn_act_dpre(dy: torch.Tensor, pre: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                sums: torch.Tensor) -> torch.Tensor:
    """Kernel D's elementwise pass alone, from sums [2, F] fp32 that another
    kernel already reduced (the conv2 dgrad's reduce epilogue,
    ``conv_block.conv3x3_dgrad_reduce``). Returns dpre in dy's dtype."""
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bn_act_dpre: unsupported dtype {dy.dtype}")
    _check("dy", dy)
    _check("pre", pre, like=dy)
    _check_vecs(dy, a=a, b=b, mean=mean, inv=inv)
    _check("sums", sums, dtype=torch.float32, shape=(2, dy.shape[-1]))
    if sums.device != dy.device:
        raise ValueError(f"sums: on {sums.device}, data on {dy.device}")
    if dy.device.type == "cpu":
        return bn_act_dpre_reference(dy, pre, a, b, mean, inv, sums)
    _require_cuda(dy)
    dpre = _dpre(dy, pre, a, b, mean, inv, sums)
    counted(bn_act_dpre, dy)
    return dpre


def _dpre(dy, pre, a, b, mean, inv, sums):
    dpre = torch.empty_like(dy)
    ptrs = (ptr(dy), ptr(pre), ptr(a), ptr(b), ptr(mean), ptr(inv),
            ptr(sums), ptr(dpre))
    lib, w = _walk(False, dy, ptrs)
    lib.call("hpfg_bn_dpre", *ptrs, w.p, dy.shape[-1], w.cols,
             w.rows_per_step, int(dy.dtype == torch.bfloat16), int(w.vec > 1), w.ctas,
             w.chunks, stream(dy))
    return dpre


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors, got {t.device}")


for _fn in (bn_act_bwd, bn_reduce):
    # each route's own launch count, beside the wrapper's total
    _fn.routes = {r: SimpleNamespace(launches=0) for r in BN_ROUTES}
