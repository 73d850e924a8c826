"""Window multi-head attention of the SwinUNet on hand-written Hopper kernels.

Port of ``hpfg_tpu/ops/pallas/window_attention.py``. Per window and head:

    o = (softmax(q k^T * D^-1/2 + bias[h] + mask[w]) * dropout mask) v

with the softmax in fp32, q/k/v/o in the compute dtype (bf16 or fp32),
head-major channels ``h*D + d``. The forward is kernel K13
(``window_attention_fwd``, ``csrc/window_attention.cu``) and the backward
kernel K14 (``window_attention_bwd``): the softmax recomputed, then dq, dk,
dv and the relative-position bias gradient summed over windows, from
per-CTA partials added in a fixed order (``colsum``), so it is bitwise
reproducible. The mask gets no gradient, as in the JAX VJP.

The kernels take the packed ``qkv`` Dense output [Bn, L, 3C] as it is (q,
k, v at channel offsets 0, C, 2C) and the backward returns its gradient in
one [Bn, L, 3C] tensor. ``mask`` is the per-image shift mask [nW, L, L]
(window ``w`` reads ``mask[w % nW]``), or None for an unshifted block: the
same function as the JAX entry's tiled [Bn, L, L] mask, which is never
built here. Attention dropout (``HashDropout``: keep probability and a host
seed in [0, 2^23)) is the JAX package's in-kernel hash, keyed on
b_idx = (w // blk) * 1024 + h and row = (w % blk) * L + i with
blk = min(16, Bn), whatever tile the kernels use.

Both kernels run on a grid of (CTAs, heads) in which a CTA walks a run of
windows of one head and one mask class (``attention_walk``); in bf16 they
compute every product on the tensor cores, in fp32 on the CUDA cores.

Each wrapper takes its plain PyTorch version for CPU tensors only; a CUDA
tensor launches the kernel or raises. Each counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hpfg_tpu_torch.ops._cuda import (
    colsum,
    launch_counter,
    library,
    ptr,
    stream,
)
from hpfg_tpu_torch.ops.conv_block import HashDropout, hash_keep

#: windows per hash block (the TPU kernel's WINDOW_BLOCK): part of the
#: dropout hash's index formula, not a tile size of the CUDA kernels
WINDOW_BLOCK = 16
#: CTAs to aim for in a K13 or K14 launch (8 per SM of an H100)
TARGET_CTAS = 1056


class AttentionWalk(NamedTuple):
    """How K13 and K14 split Bn windows x H heads over CTAs: the grid is
    (``ctas``, H), CTA ``x`` of head h walks ``windows(x)``, and K14 writes
    one dbias partial row per CTA, so its partial buffer has ``ctas``
    rows of H * L * L. The kernels' ``Walk`` (csrc/window_attention.cu)
    computes the same windows."""

    windows_per_cta: int
    ctas: int
    n_mask: int
    bn: int

    def windows(self, x: int) -> list[int]:
        """The windows of CTA x, in the order it walks them: all share
        w % n_mask, so the CTA reads one mask[w % n_mask] for its run."""
        per = self.bn // self.n_mask
        b0 = (x // self.n_mask) * self.windows_per_cta
        return [x % self.n_mask + self.n_mask * b
                for b in range(b0, min(b0 + self.windows_per_cta, per))]


def attention_walk(bn: int, heads: int, n_mask: int) -> AttentionWalk:
    """The walk of K13 and K14 for Bn windows, H heads and a mask of n_mask
    windows per image (1 when unshifted): the shortest run of windows per
    CTA that keeps the grid within about TARGET_CTAS CTAs, each CTA taking
    windows of one mask class r = w % n_mask, consecutive in the batch."""
    per = bn // n_mask
    wpc = min(per, max(1, -(-bn * heads // TARGET_CTAS)))
    return AttentionWalk(wpc, n_mask * -(-per // wpc), n_mask, bn)


def attn_drop_mask(seed: int, bn: int, heads: int, l: int, keep: float,
                   device=None) -> torch.Tensor:
    """The pre-scaled attention-dropout masks [Bn, H, L, L] (1/keep or 0,
    fp32) the kernels regenerate (``attn_drop_mask_reference``)."""
    blk = min(WINDOW_BLOCK, bn)

    def ar(n, *view):
        return torch.arange(n, dtype=torch.int64, device=device).view(*view)

    w, h = ar(bn, -1, 1, 1, 1), ar(heads, 1, -1, 1, 1)
    i, j = ar(l, 1, 1, -1, 1), ar(l, 1, 1, 1, -1)
    rows = (w % blk) * l + i
    return hash_keep(seed, (w // blk) * 1024 + h, rows * l + j, keep)


def _tiled(mask: torch.Tensor | None, bn: int) -> torch.Tensor | None:
    """The per-image mask [nW, L, L] tiled over the Bn windows, fp32."""
    if mask is None:
        return None
    return mask.float().repeat(bn // mask.shape[0], 1, 1)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[Bn, L, H*D] -> fp32 [Bn, H, L, D]."""
    bn, l, c = t.shape
    return t.float().view(bn, l, heads, c // heads).transpose(1, 2)


def _probs(q, k, bias, mask, heads):
    """(fp32 probabilities [Bn, H, L, L], scaled q, k, scale) as K13
    computes them: s = (q * scale) k^T + bias, + mask, softmax."""
    bn, _, c = q.shape
    scale = float(np.float32((c // heads) ** -0.5))
    qh, kh = _heads(q, heads) * scale, _heads(k, heads)
    s = torch.einsum("bhld,bhmd->bhlm", qh, kh) + bias.float()[None]
    if mask is not None:
        s = s + _tiled(mask, bn)[:, None]
    return torch.softmax(s, dim=-1), qh, kh, scale


def window_attention_reference(q, k, v, bias, mask, heads: int,
                               drop: HashDropout | None = None):
    """Plain version of K13 (``window_attention_reference`` plus the
    dropout on the probabilities): q/k/v [Bn, L, C], bias [H, L, L], mask
    [nW, L, L] or None. Returns [Bn, L, C] in q's dtype."""
    bn, l, c = q.shape
    p = _probs(q, k, bias, mask, heads)[0]
    if drop is not None:
        p = p * attn_drop_mask(drop.seed, bn, heads, l, drop.keep, q.device)
    o = torch.einsum("bhlm,bhmd->bhld", p, _heads(v, heads))
    return o.transpose(1, 2).reshape(bn, l, c).to(q.dtype)


def window_attention_bwd_reference(q, k, v, bias, mask, do, heads: int,
                                   drop: HashDropout | None = None):
    """Plain version of K14, the VJP of K13 in its order of operations:
    returns (dq, dk, dv) in q's dtype and dbias [H, L, L] fp32."""
    bn, l, c = q.shape
    p, qh, kh, scale = _probs(q, k, bias, mask, heads)
    vh, doh = _heads(v, heads), _heads(do.to(q.dtype), heads)
    dp = torch.einsum("bhld,bhmd->bhlm", doh, vh)
    pm = p
    if drop is not None:
        m = attn_drop_mask(drop.seed, bn, heads, l, drop.keep, q.device)
        pm, dp = p * m, dp * m
    dv = torch.einsum("bhlm,bhld->bhmd", pm, doh)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhlm,bhmd->bhld", ds, kh) * scale
    dk = torch.einsum("bhlm,bhld->bhmd", ds, qh)

    def back(t):
        return t.transpose(1, 2).reshape(bn, l, c).to(q.dtype)

    return back(dq), back(dk), back(dv), ds.sum(0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(qkv, bias, mask, heads: int):
    """Shapes, dtypes and devices the kernels take; returns (Bn, L, C)."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv: expected [Bn, L, 3*C] with C a multiple of "
                         f"{heads} heads, got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qkv: unsupported dtype {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("qkv: must be contiguous")
    bn, l, c3 = qkv.shape
    for name, t, shape in (("bias", bias, (heads, l, l)),
                           ("mask", mask, (None, l, l))):
        if t is None:
            continue
        if (t.dtype != torch.float32 or t.dim() != 3
                or tuple(t.shape[1:]) != shape[1:]
                or (shape[0] is not None and t.shape[0] != shape[0])
                or not t.is_contiguous() or t.device != qkv.device):
            raise ValueError(f"{name}: expected contiguous fp32 "
                             f"[{shape[0] or 'nW'}, {l}, {l}] on {qkv.device},"
                             f" got {tuple(t.shape)} {t.dtype} on {t.device}")
    if mask is not None and bn % mask.shape[0]:
        raise ValueError(f"mask: {mask.shape[0]} windows per image do not "
                         f"divide Bn = {bn}")
    return bn, l, c3 // 3


def _kernel_args(qkv, mask, heads: int, drop: HashDropout | None):
    """The launch arguments K13 and K14 share after their pointers."""
    lib = library(qkv.device)
    bn, l, c3 = qkv.shape
    d = c3 // 3 // heads
    if l > lib.attn_max_l or d > lib.attn_max_d:
        raise ValueError(f"window attention kernels take L <= "
                         f"{lib.attn_max_l} and D <= {lib.attn_max_d}, got "
                         f"L = {l}, D = {d}")
    dr = ([1, drop.seed, drop.thresh, drop.scale] if drop is not None
          else [0, 0, 0, 0.0])
    return lib, [bn, l, heads, d, float(np.float32(d ** -0.5)), *dr,
                 min(WINDOW_BLOCK, bn)]


@launch_counter
def window_attention_fwd(qkv, bias, mask, heads: int,
                         drop: HashDropout | None = None):
    """K13: window attention of the packed ``qkv`` [Bn, L, 3C] with the
    relative-position ``bias`` [H, L, L] and the per-image ``mask``
    [nW, L, L] (or None), optional in-kernel attention dropout. Returns o
    [Bn, L, C] in qkv's dtype."""
    bn, l, c = _check(qkv, bias, mask, heads)
    if qkv.device.type == "cpu":
        q, k, v = qkv.split(c, dim=-1)
        return window_attention_reference(q, k, v, bias, mask, heads, drop)
    lib, args = _kernel_args(qkv, mask, heads, drop)
    n_mask = 1 if mask is None else mask.shape[0]
    walk = attention_walk(bn, heads, n_mask)
    out = torch.empty((bn, l, c), dtype=qkv.dtype, device=qkv.device)
    lib.call("hpfg_window_attention_fwd", ptr(qkv), ptr(bias), ptr(mask),
             n_mask, ptr(out), *args, walk.windows_per_cta, walk.ctas,
             int(qkv.dtype == torch.bfloat16), stream(qkv))
    window_attention_fwd.launches += 1
    return out


@launch_counter
def window_attention_bwd(qkv, bias, mask, do, heads: int,
                         drop: HashDropout | None = None):
    """K14: the gradient of K13 for the output cotangent ``do`` [Bn, L, C]
    (qkv's dtype): returns (dqkv [Bn, L, 3C] in qkv's dtype, dbias
    [H, L, L] fp32, summed over windows in a fixed order)."""
    bn, l, c = _check(qkv, bias, mask, heads)
    if (tuple(do.shape) != (bn, l, c) or do.dtype != qkv.dtype
            or not do.is_contiguous() or do.device != qkv.device):
        raise ValueError(f"do: expected contiguous [{bn}, {l}, {c}] "
                         f"{qkv.dtype}, got {tuple(do.shape)} {do.dtype}")
    if qkv.device.type == "cpu":
        q, k, v = qkv.split(c, dim=-1)
        *dqkv, dbias = window_attention_bwd_reference(q, k, v, bias, mask,
                                                      do, heads, drop)
        return torch.cat(dqkv, dim=-1), dbias
    lib, args = _kernel_args(qkv, mask, heads, drop)
    n_mask = 1 if mask is None else mask.shape[0]
    walk = attention_walk(bn, heads, n_mask)
    dqkv = torch.empty_like(qkv)
    part = torch.empty((walk.ctas, heads * l * l), dtype=torch.float32,
                       device=qkv.device)
    lib.call("hpfg_window_attention_bwd", ptr(qkv), ptr(bias), ptr(mask),
             n_mask, ptr(do), ptr(dqkv), ptr(part), *args,
             walk.windows_per_cta, walk.ctas,
             int(qkv.dtype == torch.bfloat16), stream(qkv))
    window_attention_bwd.launches += 1
    return dqkv, colsum(part).view(heads, l, l)


class WindowAttentionFn(torch.autograd.Function):
    """K13 forward, K14 backward (window_attention.py ``_window_attention``
    with its custom VJP): apply(qkv, bias, mask, heads, drop) -> o. The
    gradients are dqkv and dbias; the mask, a constant, gets none."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, heads, drop):
        ctx.heads, ctx.drop = heads, drop
        ctx.save_for_backward(qkv, bias, mask)
        return window_attention_fwd(qkv, bias, mask, heads, drop)

    @staticmethod
    def backward(ctx, do):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(
            qkv, bias, mask, do.to(qkv.dtype).contiguous(), ctx.heads,
            ctx.drop)
        return dqkv, dbias, None, None, None


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: torch.Tensor | None, heads: int,
                     drop: HashDropout | None = None) -> torch.Tensor:
    """Differentiable window attention (``window_attention``): ``qkv``
    [Bn, L, 3C] in the compute dtype, ``bias`` [H, L, L], ``mask``
    [nW, L, L] or None, ``drop`` a :class:`HashDropout` or None. Returns
    [Bn, L, C] in qkv's dtype."""
    return WindowAttentionFn.apply(
        qkv.contiguous(), bias.float().contiguous(),
        None if mask is None else mask.float().contiguous(), heads, drop)
