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
order. A full ``bn_act_bwd`` is two launches (reduce, dpre); ``bn_act`` and
``bn_act_dpre`` one each.

Each wrapper takes its plain PyTorch version for CPU tensors only; for a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import math
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
    sums = _reduce(dy, pre, a, b, mean, inv)
    dpre = _dpre(dy, pre, a, b, mean, inv, sums)
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
    sums = _reduce(dy, pre, a, b, mean, inv)
    counted(bn_reduce, dy)
    return sums


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
