"""Window multi-head attention of the SwinUNet on hand-written Hopper kernels.

Port of ``hpfg_tpu/ops/pallas/window_attention.py``. Per window and head:

    o = (softmax(q k^T * D^-1/2 + bias[h] + mask[w]) * dropout mask) v

with the softmax in fp32, q/k/v/o in the compute dtype (bf16 or fp32),
head-major channels ``h*D + d``. The forward is kernel K13
(``window_attention_fwd``) and the backward kernel K14
(``window_attention_bwd``): the softmax recomputed, then dq, dk, dv and the
relative-position bias gradient summed over windows in a fixed order, so it
is bitwise reproducible. The mask gets no gradient, as in the JAX VJP.

Each has two routes on the card (``attn_route``), counted in
``<wrapper>.routes``: "wgmma" (``csrc/window_attention_sm90.cu``: TMA in and
out, wgmma, G = 64 // L windows of one head and mask class packed into one
64-row tile (``packed_walk``), K14's dbias summed inside the kernel through
group and head tickets) for bf16 at head widths 16, 32 and 64; "mma"
(``csrc/window_attention.cu``: its mma.sync kernels for the other bf16
calls, the CUDA-core kernels for fp32; a grid of (CTAs, heads) in which a
CTA walks a run of windows of one head and one mask class
(``attention_walk``), K14's dbias from per-CTA partial rows added by
``colsum``). No call falls back from one route to the other.

The kernels take the packed ``qkv`` Dense output [Bn, L, 3C] as it is (q,
k, v at channel offsets 0, C, 2C) and the backward returns its gradient in
one [Bn, L, 3C] tensor. ``mask`` is the per-image shift mask [nW, L, L]
(window ``w`` reads ``mask[w % nW]``), or None for an unshifted block: the
same function as the JAX entry's tiled [Bn, L, L] mask, which is never
built here. Attention dropout (``HashDropout``: keep probability and a host
seed in [0, 2^23)) is the JAX package's in-kernel hash, keyed on
b_idx = (w // blk) * 1024 + h and row = (w % blk) * L + i with
blk = min(16, the global window count), whatever tile, slot or CTA the
kernels use; w is the window's index in the global batch. Under data
parallelism the dropout's ``image_ids`` (``Rows.ids``) place the local
windows there: local window w of image w // nW is global window
ids[w // nW] * nW + w % nW, and its ``total`` is the global image count.
Without ids w is the local index and blk = min(16, Bn), as in one process.

Each wrapper takes its plain PyTorch version for CPU tensors only; a CUDA
tensor launches the kernel or raises. Each counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from hpfg_tpu_torch.ops._cuda import (
    colsum,
    counted,
    launch_counter,
    library,
    ptr,
    sm_count,
    stream,
    ticket,
)
from hpfg_tpu_torch.ops.conv_block import HashDropout, hash_keep

#: windows per hash block (the TPU kernel's WINDOW_BLOCK): part of the
#: dropout hash's index formula, not a tile size of the CUDA kernels
WINDOW_BLOCK = 16
#: CTAs to aim for in a K13 or K14 launch on the mma route (8 per SM of
#: an H100)
TARGET_CTAS = 1056
#: the two routes of K13 and K14 on the card
ROUTES = ("wgmma", "mma")
#: head widths the wgmma route takes: a row of 2D bytes is a TMA swizzle
#: width (32, 64 or 128 bytes); D = 48's 96 bytes is none, so it keeps mma
SM90_HEAD_WIDTHS = (16, 32, 64)
#: rows of the wgmma route's tile: G = TILE_ROWS // L windows a tile
TILE_ROWS = 64


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


def attn_route(dtype, d: int, l: int, aligned: bool) -> str:
    """The kernel a K13 or K14 call takes on the card: "wgmma"
    (csrc/window_attention_sm90.cu) where TMA and the packed tile can take
    it: bf16, head width ``d`` in SM90_HEAD_WIDTHS (16, 32 or 64), ``l`` <=
    TILE_ROWS tokens a window and 16-byte aligned bases (``aligned``; the
    row strides 3C and C are then multiples of 16 bytes too); else "mma"
    (csrc/window_attention.cu): fp32 (the CUDA-core kernels), the head
    widths 8, 12, 40 and 48 and unaligned tensors (its mma.sync
    kernels). No call falls back from one to the other."""
    ok = (dtype == torch.bfloat16 and d in SM90_HEAD_WIDTHS
          and l <= TILE_ROWS and aligned)
    return "wgmma" if ok else "mma"


class PackedWalk(NamedTuple):
    """How the wgmma route splits Bn windows x H heads: a tile packs
    ``g`` windows of one head and one mask class r (w = r + n_mask * b,
    consecutive b), class r's tiles are tiles r * tiles_per_class ..;
    the grid is (``ctas``, H) and CTA x of head h takes tiles
    [x * tiles_per_cta, (x + 1) * tiles_per_cta). K14 writes one dbias
    partial row a CTA and one group row a group of ``group`` CTAs
    (``tile_of`` and ``dbias_tickets`` in csrc/window_attention_sm90.cu)."""

    g: int
    n_mask: int
    per: int
    tiles_per_class: int
    tiles: int
    tiles_per_cta: int
    ctas: int
    group: int

    def slots(self, tau: int) -> list[int]:
        """The windows of tile ``tau`` in slot order (TMA's box reads zeros
        past the class's last window: those slots hold none)."""
        r, t = divmod(tau, self.tiles_per_class)
        b0 = t * self.g
        return [r + self.n_mask * b
                for b in range(b0, min(b0 + self.g, self.per))]

    def tiles_of(self, x: int) -> range:
        """The tiles CTA x walks, in order."""
        return range(x * self.tiles_per_cta,
                     min((x + 1) * self.tiles_per_cta, self.tiles))

    @property
    def groups(self) -> int:
        """K14's dbias groups a head: group rows the last closer sums."""
        return -(-self.ctas // self.group)


#: CTAs an SM of the wgmma route, at D <= 32 and at D = 64: K13's
#: (False) and K14's (True), as many as fit an SM at once (the kernels'
#: __launch_bounds__ and shared memory)
SM90_CTAS_PER_SM = {False: (4, 2), True: (3, 1)}


def sm90_target(backward: bool, d: int, sms: int) -> int:
    """CTAs to aim for in a wgmma-route launch on ``sms`` SMs."""
    return SM90_CTAS_PER_SM[backward][d > 32] * sms


def packed_walk(bn: int, heads: int, n_mask: int, l: int, target: int,
                group: int = 8) -> PackedWalk:
    """The wgmma route's walk for Bn windows of L tokens, H heads and a
    mask of n_mask windows per image (1 when unshifted): G = TILE_ROWS //
    L windows a tile (at most the class's Bn / n_mask, so TMA's box fits
    the tensor), and the shortest run of tiles per CTA that keeps the
    grid within about ``target`` CTAs (every CTA takes at least one)."""
    per = bn // n_mask
    g = min(TILE_ROWS // l, per)
    tpc = -(-per // g)
    tiles = n_mask * tpc
    tpx = -(-tiles // max(1, min(tiles, -(-target // heads))))
    return PackedWalk(g, n_mask, per, tpc, tiles, tpx, -(-tiles // tpx),
                      group)


def tile_bias(bias_h: torch.Tensor, mask_r: torch.Tensor | None, l: int,
              g: int) -> torch.Tensor:
    """The wgmma route's additive score term of a packed tile: [64, 64]
    fp32 with bias[h] (+ mask[r]) [L, L] down the diagonal for each of the
    g slots, -inf between slots and past them, 0 in the rows past g * L
    (never stored): ``load_bm`` in csrc/window_attention_sm90.cu."""
    block = bias_h.float() + (0 if mask_r is None else mask_r.float())
    out = torch.full((TILE_ROWS, TILE_ROWS), float("-inf"))
    out[g * l:] = 0.0
    for s in range(g):
        out[s * l:(s + 1) * l, s * l:(s + 1) * l] = block
    return out


def window_block(bn: int, image_ids: torch.Tensor | None = None,
                 total: int | None = None) -> int:
    """The hash's window block: min(WINDOW_BLOCK, the global window count)
    for Bn local windows of the images ``image_ids`` of a global batch of
    ``total`` images (without ids, Bn is the count; with ids, ``total`` is
    required)."""
    if image_ids is None:
        return min(WINDOW_BLOCK, bn)
    if total is None:
        raise ValueError("image_ids need the global image count (total)")
    return min(WINDOW_BLOCK, bn // len(image_ids) * total)


def attn_drop_mask(seed: int, bn: int, heads: int, l: int, keep: float,
                   device=None, image_ids: torch.Tensor | None = None,
                   total: int | None = None) -> torch.Tensor:
    """The pre-scaled attention-dropout masks [Bn, H, L, L] (1/keep or 0,
    fp32) the kernels regenerate (``attn_drop_mask_reference``).
    ``image_ids`` (int32 [B], Bn = B nW) and ``total`` as in
    :class:`HashDropout`: the masks of these windows in the global batch's
    masks."""
    blk = window_block(bn, image_ids, total)

    def ar(n, *view):
        return torch.arange(n, dtype=torch.int64, device=device).view(*view)

    w, h = ar(bn, -1, 1, 1, 1), ar(heads, 1, -1, 1, 1)
    if image_ids is not None:
        nw = bn // len(image_ids)
        ids = image_ids.to(device=device, dtype=torch.int64)
        w = ids[w // nw] * nw + w % nw
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
        p = p * attn_drop_mask(drop.seed, bn, heads, l, drop.keep, q.device,
                               drop.image_ids, drop.total)
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
        m = attn_drop_mask(drop.seed, bn, heads, l, drop.keep, q.device,
                           drop.image_ids, drop.total)
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


def _check_ids(drop: HashDropout | None, bn: int, device) -> None:
    """A dropout's image ids: int32 [B] with B dividing Bn, contiguous, on
    ``device``, with the global image count ``total``."""
    ids = None if drop is None else drop.image_ids
    if ids is None:
        return
    if drop.total is None:
        raise ValueError("image_ids need the global image count (total)")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not len(ids) or \
            bn % len(ids) or not ids.is_contiguous() or ids.device != device:
        raise ValueError(f"image_ids: expected contiguous int32 [B] on "
                         f"{device} with B dividing Bn = {bn}, got "
                         f"{ids.dtype} {tuple(ids.shape)} on {ids.device}")


def _kernel_args(qkv, mask, heads: int, drop: HashDropout | None):
    """The launch arguments K13 and K14 share after their pointers."""
    lib = library(qkv.device)
    bn, l, c3 = qkv.shape
    d = c3 // 3 // heads
    if l > lib.attn_max_l or d > lib.attn_max_d:
        raise ValueError(f"window attention kernels take L <= "
                         f"{lib.attn_max_l} and D <= {lib.attn_max_d}, got "
                         f"L = {l}, D = {d}")
    dr = ([0, 0, 0, 0.0] if drop is None
          else [1, drop.seed, drop.thresh, drop.scale])
    ids = None if drop is None else drop.image_ids
    nw = 1 if ids is None else bn // len(ids)
    blk = window_block(bn, ids, None if drop is None else drop.total)
    return lib, [bn, l, heads, d, float(np.float32(d ** -0.5)), *dr,
                 ptr(ids), nw, blk]


def _aligned(*ts: torch.Tensor) -> bool:
    """Every tensor's base 16-byte aligned (TMA's rule)."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _launch(route: str, backward: bool, qkv, bias, mask, *rest):
    """Launch K13 (``backward`` False, ``rest`` = heads, drop: returns o)
    or K14 (``rest`` = do, heads, drop: returns dqkv, dbias) on ``route``
    for arguments the wrapper has checked. The wrappers call it with
    ``attn_route``'s route; chip_smoke.py times each route through it."""
    heads, drop = rest[-2:]
    lib, args = _kernel_args(qkv, mask, heads, drop)
    bn, l, c3 = qkv.shape
    c = c3 // 3
    n_mask = 1 if mask is None else mask.shape[0]
    dev = qkv.device
    if route == "wgmma":
        walk = packed_walk(bn, heads, n_mask, l,
                           sm90_target(backward, c // heads, sm_count(dev)),
                           lib.attn_dbias_group)
        tail = (walk.g, walk.tiles_per_cta, walk.ctas, stream(qkv))
        if not backward:
            out = torch.empty((bn, l, c), dtype=qkv.dtype, device=dev)
            lib.call("hpfg_attn_sm90_fwd", ptr(qkv), ptr(bias), ptr(mask),
                     n_mask, ptr(out), *args, *tail)
            return out
        dqkv = torch.empty_like(qkv)
        llp = -(-l * l // 4) * 4
        f32 = dict(dtype=torch.float32, device=dev)
        part = torch.empty((heads, walk.ctas, llp), **f32)
        grp = torch.empty((heads, walk.groups, llp), **f32)
        dbias = torch.empty((heads, l, l), **f32)
        tk = ticket(dev, "attn_sm90_bwd", heads * (walk.groups + 1))
        lib.call("hpfg_attn_sm90_bwd", ptr(qkv), ptr(bias), ptr(mask),
                 n_mask, ptr(rest[0]), ptr(dqkv), ptr(part), ptr(grp),
                 ptr(dbias), ptr(tk), *args, *tail)
        return dqkv, dbias
    walk = attention_walk(bn, heads, n_mask)
    tail = (walk.windows_per_cta, walk.ctas,
            int(qkv.dtype == torch.bfloat16), stream(qkv))
    if not backward:
        out = torch.empty((bn, l, c), dtype=qkv.dtype, device=dev)
        lib.call("hpfg_window_attention_fwd", ptr(qkv), ptr(bias), ptr(mask),
                 n_mask, ptr(out), *args, *tail)
        return out
    dqkv = torch.empty_like(qkv)
    part = torch.empty((walk.ctas, heads * l * l), dtype=torch.float32,
                       device=dev)
    lib.call("hpfg_window_attention_bwd", ptr(qkv), ptr(bias), ptr(mask),
             n_mask, ptr(rest[0]), ptr(dqkv), ptr(part), *args, *tail)
    return dqkv, colsum(part).view(heads, l, l)


@launch_counter
def window_attention_fwd(qkv, bias, mask, heads: int,
                         drop: HashDropout | None = None):
    """K13: window attention of the packed ``qkv`` [Bn, L, 3C] with the
    relative-position ``bias`` [H, L, L] and the per-image ``mask``
    [nW, L, L] (or None), optional in-kernel attention dropout. Returns o
    [Bn, L, C] in qkv's dtype."""
    bn, l, c = _check(qkv, bias, mask, heads)
    _check_ids(drop, bn, qkv.device)
    if qkv.device.type == "cpu":
        q, k, v = qkv.split(c, dim=-1)
        return window_attention_reference(q, k, v, bias, mask, heads, drop)
    route = attn_route(qkv.dtype, c // heads, l, _aligned(qkv))
    out = _launch(route, False, qkv, bias, mask, heads, drop)
    counted(window_attention_fwd.routes[route], qkv)
    counted(window_attention_fwd, qkv, 4 * bn * l * l * c)
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
    _check_ids(drop, bn, qkv.device)
    if qkv.device.type == "cpu":
        q, k, v = qkv.split(c, dim=-1)
        *dqkv, dbias = window_attention_bwd_reference(q, k, v, bias, mask,
                                                      do, heads, drop)
        return torch.cat(dqkv, dim=-1), dbias
    route = attn_route(qkv.dtype, c // heads, l, _aligned(qkv, do))
    out = _launch(route, True, qkv, bias, mask, do, heads, drop)
    counted(window_attention_bwd.routes[route], qkv)
    counted(window_attention_bwd, qkv, 8 * bn * l * l * c)
    return out


for _fn in (window_attention_fwd, window_attention_bwd):
    # each route's own launch count, beside the wrapper's total
    _fn.routes = {r: SimpleNamespace(launches=0) for r in ROUTES}


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
