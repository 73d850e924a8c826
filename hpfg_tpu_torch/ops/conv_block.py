"""Fused UNet ConvBlock and plain 3x3 conv on hand-written Hopper kernels.

Port of ``hpfg_tpu/ops/pallas/conv_block.py`` in the JAX package's default
configuration (dual-input UpBlock conv1, dual backward, fold-reduce). The
block is conv3x3 -> BN -> LeakyReLU -> hash dropout -> conv3x3 -> BN ->
LeakyReLU on NHWC activations with HWIO ``[3, 3, C, F]`` weights. Its input
is one tensor, or a pair ``(skip, up)`` whose channel concat conv1 reads
without materialising it (the UpBlock). Train mode runs it as three kernel
launches, as on the TPU:

  1. conv1 + bias, with per-channel [sum, sum^2] of the fp32 result
     (``conv3x3_nhwc``, kernel A; for a pair ``conv3x3_pair_nhwc``, K8);
  2. BN1 affine + LeakyReLU + dropout fused into conv2's operand load, then
     conv2 + bias + statistics (``conv3x3_nhwc`` with a prologue);
  3. BN2 affine + LeakyReLU (``bn_act``, kernel C).

The backward (``block_backward``) follows the Pallas ``_bwd``: BN2 backward
(``bn_act_bwd``, kernel D); conv2's input gradient times the forward dropout
mask with BN1's backward reduction in its epilogue (``conv3x3_dgrad_reduce``,
K11); conv2's weight gradient (``conv3x3_wgrad_nhwc``, kernel B, which
recomputes lrelu(BN1(h))*mask from the conv1 output); BN1's elementwise
backward from those sums (``bn_act_dpre``); then conv1's input and weight
gradients (kernels A and B, or for a pair ``conv3x3_dgrad_pair``, K9, and
``conv3x3_wgrad_pair``, K10).

Every kernel wrapper takes its plain PyTorch version (``*_reference``) for
CPU tensors only; a CUDA tensor launches the kernel or raises. Each wrapper
counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from hpfg_tpu_torch.ops._cuda import (
    colsum,
    launch_counter,
    library,
    ptr,
    stream,
)
from hpfg_tpu_torch.ops.bn_act import (
    LRELU_SLOPE,
    bn_act,
    bn_act_bwd,
    bn_act_bwd_reference,
    bn_act_dpre,
)

BN_EPS = 1e-5

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
_MUR1 = 0x85EBCA6B
_MUR2 = 0xC2B2AE35

# blocks the wgrad kernel aims for (a few waves of the H100's 132 SMs)
WGRAD_TARGET_BLOCKS = 2048
# the most bytes its per-block dW partials may take
WGRAD_PART_BYTES = 2 ** 25


@dataclass(frozen=True)
class HashDropout:
    """In-kernel dropout: keep probability and a per-block seed in
    [0, 2^23). The mask is regenerated from (seed, image, row, lane)."""

    seed: int
    keep: float

    @property
    def thresh(self) -> int:
        return min(int(self.keep * 2 ** 32), 2 ** 32 - 1)

    @property
    def scale(self) -> float:
        return float(np.float32(1.0 / self.keep))


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for x < 2^32 held in int64, without int64 overflow."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_keep(seed: int, b_idx: torch.Tensor, v: torch.Tensor,
              keep: float) -> torch.Tensor:
    """The pre-scaled keep mask (1/keep or 0, fp32) of the hash the kernels
    share (``csrc/hash.cuh``; conv_block.py ``_hash_mask``): the murmur3-style
    finalizer of v plus (seed + b_idx*0x9E3779B9), in uint32. ``b_idx`` (the
    image, or an attention mask's window block and head) and ``v`` (row *
    lanes + lane) are non-negative int64 tensors that broadcast together."""
    spec = HashDropout(seed, keep)
    x = ((v & _M32) + ((int(seed) + b_idx * _GOLD) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _MUR1)
    x = x ^ (x >> 13)
    x = _mul32(x, _MUR2)
    x = x ^ (x >> 16)
    return torch.where(x < spec.thresh, spec.scale, 0.0).to(torch.float32)


def hash_mask(seed: int, batch: int, h: int, lanes: int, keep: float,
              device=None) -> torch.Tensor:
    """The pre-scaled dropout mask [batch, h, lanes] (1/keep or 0, fp32) the
    conv kernels regenerate: :func:`hash_keep` of v = row*lanes + lane with
    the image as ``b_idx`` (``lanes`` = W*C of the masked tensor)."""
    rows = torch.arange(h, dtype=torch.int64, device=device).view(1, h, 1)
    lane = torch.arange(lanes, dtype=torch.int64, device=device).view(1, 1, -1)
    img = torch.arange(batch, dtype=torch.int64, device=device).view(-1, 1, 1)
    return hash_keep(seed, img, rows * lanes + lane, keep)


def _nhwc_mask(drop: HashDropout, shape, device) -> torch.Tensor:
    b, h, w, c = shape
    return hash_mask(drop.seed, b, h, w * c, drop.keep, device).view(b, h, w, c)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _lrelu(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z, z * LRELU_SLOPE)


def _source(x, affine, drop) -> torch.Tensor:
    """The conv operand in fp32: prologue (affine + LeakyReLU + dropout) in
    fp32 on the image, then rounded to x's dtype (zero padding comes after,
    so it pads the transformed tensor)."""
    z = x.float()
    if affine is not None:
        z = _lrelu(z * affine[0] + affine[1])
        if drop is not None:
            z = z * _nhwc_mask(drop, x.shape, x.device)
    return z.to(x.dtype).float()


def conv3x3_reference(x, w, bias=None, affine=None, drop=None,
                      out_drop=None, want_stats=False):
    """Plain version of kernel A: SAME 3x3 conv on NHWC with fp32
    accumulation of operands rounded to x's dtype. Returns (y in x's dtype,
    [2, F] fp32 [sum, sum^2] of the fp32 result or None)."""
    dtype = x.dtype
    src = _source(x, affine, drop).permute(0, 3, 1, 2)
    wt = w.to(dtype).float().permute(3, 2, 0, 1)
    o = F.conv2d(src, wt, padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        o = o + bias
    if out_drop is not None:
        o = o * _nhwc_mask(out_drop, o.shape, o.device)
    stats = None
    if want_stats:
        stats = torch.stack([o.sum((0, 1, 2)), (o * o).sum((0, 1, 2))])
    return o.to(dtype).contiguous(), stats


def conv3x3_pair_reference(xa, xb, w, bias=None, want_stats=False):
    """Plain version of K8: kernel A's plain version on the materialised
    channel concat (xa || xb)."""
    return conv3x3_reference(torch.cat([xa, xb], dim=-1), w, bias,
                             want_stats=want_stats)


def conv3x3_dgrad_pair_reference(dp, wf, ca):
    """Plain version of K9: two dgrads, one per half of the flip-transposed
    weights wf [3,3,F,Ca+Cb]."""
    return (conv3x3_reference(dp, wf[..., :ca])[0],
            conv3x3_reference(dp, wf[..., ca:])[0])


def conv3x3_dgrad_reduce_reference(dp, wf, pre, a, b, mean, inv,
                                   out_drop=None):
    """Plain version of K11: the dgrad (times the dropout mask), then the BN
    backward reduction of the ROUNDED dgrad against ``pre``."""
    dd, _ = conv3x3_reference(dp, wf, out_drop=out_drop)
    return dd, bn_act_bwd_reference(dd, pre, a, b, mean, inv)[0]


def conv3x3_wgrad_reference(src, dp, affine=None, drop=None):
    """Plain version of kernel B: dW[ky, kx, c, f] =
    sum_{b,y,x} src'[b, y+ky-1, x+kx-1, c] * dp[b, y, x, f] in fp32."""
    _, h, w, c = src.shape
    s = F.pad(_source(src, affine, drop), (0, 0, 1, 1, 1, 1))
    d = dp.to(src.dtype).float()
    taps = [torch.einsum("bhwc,bhwf->cf", s[:, ky:ky + h, kx:kx + w], d)
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps).view(3, 3, c, dp.shape[-1])


def conv3x3_wgrad_pair_reference(xa, xb, dp):
    """Plain version of K10: kernel B's plain version once per half."""
    return conv3x3_wgrad_reference(xa, dp), conv3x3_wgrad_reference(xb, dp)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_act(name: str, t: torch.Tensor) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name}: expected NHWC, got shape {tuple(t.shape)}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: unsupported dtype {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous NHWC")


def _check_like(name: str, t: torch.Tensor, ref: torch.Tensor) -> None:
    """``t``: NHWC over ``ref``'s batch and pixels, dtype and device."""
    _check_act(name, t)
    if t.shape[:3] != ref.shape[:3] or t.dtype != ref.dtype or \
            t.device != ref.device:
        raise ValueError(f"{name}: expected [{', '.join(map(str, ref.shape[:3]))}"
                         f", C] {ref.dtype} on {ref.device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _check_weight(w: torch.Tensor, x: torch.Tensor, c: int) -> int:
    if (w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c) or w.dtype != x.dtype
            or not w.is_contiguous()):
        raise ValueError(f"w: expected contiguous [3, 3, {c}, F] {x.dtype}, "
                         f"got {tuple(w.shape)} {w.dtype}")
    if w.device != x.device:
        raise ValueError("w and x on different devices")
    return w.shape[3]


def _check_vec(name: str, v, n: int, device) -> None:
    if v is None:
        return
    if v.dtype != torch.float32 or tuple(v.shape) != (n,):
        raise ValueError(f"{name}: expected fp32 [{n}], got {v.dtype} "
                         f"{tuple(v.shape)}")
    if not v.is_contiguous() or v.device != device:
        raise ValueError(f"{name}: must be contiguous on {device}")


def _prologue_args(affine, drop, c, device):
    if affine is None:
        if drop is not None:
            raise ValueError("dropout needs the affine prologue")
        return [None, None, 0, 0, 0, 0.0]
    _check_vec("affine[0]", affine[0], c, device)
    _check_vec("affine[1]", affine[1], c, device)
    if drop is None:
        return [ptr(affine[0]), ptr(affine[1]), 0, 0, 0, 0.0]
    return [ptr(affine[0]), ptr(affine[1]), 1, drop.seed, drop.thresh,
            drop.scale]


def conv_tiles(b: int, h: int, w: int, tile: tuple[int, int]) -> int:
    """Output tiles of a conv launch over [b, h, w] pixels: its grid's
    spatial extent, so the rows of its per-block statistics partials."""
    return b * -(-h // tile[0]) * -(-w // tile[1])


def wgrad_split(b: int, h: int, w: int, c: int, f: int,
                tile: tuple[int, int], cm: int, bn: int) -> tuple[int, int]:
    """(tiles per block, partial rows) of a wgrad launch: the fewest tiles
    per block that keep the grid (rows x channel tiles of ``cm`` x ``bn``)
    within WGRAD_TARGET_BLOCKS and the [rows, 9*c*f] fp32 partials within
    WGRAD_PART_BYTES (at least one row)."""
    total = conv_tiles(b, h, w, tile)
    ch_tiles = -(-c // cm) * -(-f // bn)
    max_rows = max(1, WGRAD_PART_BYTES // (4 * 9 * c * f))
    per_block = max(1, -(-total * ch_tiles // WGRAD_TARGET_BLOCKS),
                    -(-total // max_rows))
    return per_block, -(-total // per_block)


def _launch_conv(x, w, y, *, x2=None, bias=None, pro=None, out_drop=None,
                 reduce=None, y2=None, want_sums=False):
    """One launch of the CUDA conv kernel (csrc/conv3x3.cu
    ``hpfg_conv3x3_nhwc``) into the preallocated output(s) ``y`` (and
    ``y2``). ``reduce`` = (pre, a, b, mean, inv) selects K11's epilogue.
    Returns the [2, F] column sums of the per-block partials when
    ``want_sums``, else None."""
    lib = library(x.device)
    b, h, wd, c1 = x.shape
    c, f = w.shape[2], w.shape[3]
    part = None
    if want_sums:
        part = torch.empty((conv_tiles(b, h, wd, lib.tile), 2 * f),
                           dtype=torch.float32, device=x.device)
    om = ([1, out_drop.seed, out_drop.thresh, out_drop.scale]
          if out_drop is not None else [0, 0, 0, 0.0])
    red = [ptr(t) for t in reduce] if reduce is not None else [None] * 5
    lib.call("hpfg_conv3x3_nhwc", ptr(x), ptr(x2), c1, ptr(w), ptr(bias),
             *(pro or [None, None, 0, 0, 0, 0.0]), *om, *red, ptr(y), ptr(y2),
             y.shape[-1], ptr(part), b, h, wd, c, f,
             int(x.dtype == torch.bfloat16), stream(x))
    return colsum(part).view(2, f) if want_sums else None


@launch_counter
def conv3x3_nhwc(x, w, bias=None, affine=None, drop=None, out_drop=None,
                 want_stats=False):
    """Kernel A: SAME 3x3 conv of NHWC ``x`` [B,H,W,C] with HWIO ``w``
    [3,3,C,F] of x's dtype (bf16 or fp32), fp32 accumulation.

    ``bias``: fp32 [F]. ``affine``: (a, b) fp32 [C] prologue
    z = lrelu(a*x + b) on in-image pixels, times ``drop``'s hash mask.
    ``out_drop``: hash mask multiplied on the output (dgrad).
    Returns (y [B,H,W,F] in x's dtype, [2, F] fp32 [sum, sum^2] of the fp32
    result when ``want_stats``, else None)."""
    _check_act("x", x)
    b, h, wd, c = x.shape
    f = _check_weight(w, x, c)
    _check_vec("bias", bias, f, x.device)
    pro = _prologue_args(affine, drop, c, x.device)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, bias, affine, drop, out_drop,
                                 want_stats)
    y = torch.empty((b, h, wd, f), dtype=x.dtype, device=x.device)
    stats = _launch_conv(x, w, y, bias=bias, pro=pro, out_drop=out_drop,
                         want_sums=want_stats)
    conv3x3_nhwc.launches += 1
    return y, stats


@launch_counter
def conv3x3_pair_nhwc(xa, xb, w, bias=None, want_stats=False):
    """K8: kernel A over the implicit channel concat of ``xa`` [B,H,W,Ca]
    and ``xb`` [B,H,W,Cb] (the UpBlock's skip and upsampled halves) with
    ``w`` [3,3,Ca+Cb,F]; the concat is never materialised. Returns (y, [2, F]
    statistics or None) as kernel A."""
    _check_act("xa", xa)
    _check_like("xb", xb, xa)
    b, h, wd, ca = xa.shape
    f = _check_weight(w, xa, ca + xb.shape[-1])
    _check_vec("bias", bias, f, xa.device)
    if xa.device.type == "cpu":
        return conv3x3_pair_reference(xa, xb, w, bias, want_stats)
    y = torch.empty((b, h, wd, f), dtype=xa.dtype, device=xa.device)
    stats = _launch_conv(xa, w, y, x2=xb, bias=bias, want_sums=want_stats)
    conv3x3_pair_nhwc.launches += 1
    return y, stats


@launch_counter
def conv3x3_dgrad_pair(dp, wf, ca: int):
    """K9: the pair conv's input gradients from ``dp`` [B,H,W,F] and the
    flip-transposed weights ``wf`` [3,3,F,Ca+Cb], in one pass: returns
    (dx_skip [B,H,W,Ca], dx_up [B,H,W,Cb]), each contiguous."""
    _check_act("dp", dp)
    b, h, wd, f = dp.shape
    c = _check_weight(wf, dp, f)
    if not 0 < ca < c:
        raise ValueError(f"split {ca} outside (0, {c})")
    if dp.device.type == "cpu":
        return conv3x3_dgrad_pair_reference(dp, wf, ca)
    dxa = torch.empty((b, h, wd, ca), dtype=dp.dtype, device=dp.device)
    dxb = torch.empty((b, h, wd, c - ca), dtype=dp.dtype, device=dp.device)
    _launch_conv(dp, wf, dxa, y2=dxb)
    conv3x3_dgrad_pair.launches += 1
    return dxa, dxb


@launch_counter
def conv3x3_dgrad_reduce(dp, wf, pre, a, b, mean, inv, out_drop=None):
    """K11: conv2's input gradient ``dd`` = conv(dp, wf) times
    ``out_drop``'s mask (kernel A in dgrad form), with the previous stage's
    train-BN backward reduction in its epilogue: per channel
    S0 = sum(dz), S1 = sum(dz * xhat) where dz = dd * lrelu'(a*pre + b) and
    xhat = (pre - mean) * inv, taken on dd as stored (rounded to its dtype).
    ``pre`` [B,H,W,C] is that stage's conv output, a/b/mean/inv fp32 [C].
    Returns (dd [B,H,W,C], sums [2, C] fp32 = [dbias, dscale]);
    ``bn_act_dpre`` finishes that stage's backward from them."""
    _check_act("dp", dp)
    bb, h, wd, f = dp.shape
    c = _check_weight(wf, dp, f)
    _check_like("pre", pre, dp)
    if pre.shape[-1] != c:
        raise ValueError(f"pre: expected {c} channels, got {pre.shape[-1]}")
    for name, v in (("a", a), ("b", b), ("mean", mean), ("inv", inv)):
        _check_vec(name, v, c, dp.device)
    if dp.device.type == "cpu":
        return conv3x3_dgrad_reduce_reference(dp, wf, pre, a, b, mean, inv,
                                              out_drop)
    dd = torch.empty((bb, h, wd, c), dtype=dp.dtype, device=dp.device)
    sums = _launch_conv(dp, wf, dd, out_drop=out_drop,
                        reduce=(pre, a, b, mean, inv), want_sums=True)
    conv3x3_dgrad_reduce.launches += 1
    return dd, sums


def _launch_wgrad(src, dp, *, src2=None, pro=None):
    """One launch of the CUDA wgrad kernel (``hpfg_conv3x3_wgrad_nhwc``),
    then the fixed-order column sum: [9 * C * F] fp32, [3,3,C1,F] then
    [3,3,C-C1,F] for a pair (C1 = src's channels)."""
    lib = library(src.device)
    b, h, wd, c1 = src.shape
    c = c1 + (0 if src2 is None else src2.shape[-1])
    f = dp.shape[3]
    bf16 = src.dtype == torch.bfloat16
    per_block, rows = wgrad_split(b, h, wd, c, f, lib.tile,
                                  *lib.wgrad_tile(c, f, bf16))
    part = torch.empty((rows, 9 * c * f), dtype=torch.float32,
                       device=src.device)
    lib.call("hpfg_conv3x3_wgrad_nhwc", ptr(src), ptr(src2), c1, ptr(dp),
             *(pro or [None, None, 0, 0, 0, 0.0]), ptr(part), b, h, wd, c, f,
             per_block, int(bf16), stream(src))
    return colsum(part)


@launch_counter
def conv3x3_wgrad_nhwc(src, dp, affine=None, drop=None):
    """Kernel B: weight gradient dW [3,3,C,F] fp32 of a SAME 3x3 conv whose
    operand was ``src`` [B,H,W,C] (identity, or recomputed through the
    ``affine``/``drop`` prologue as in kernel A) and whose output cotangent
    is ``dp`` [B,H,W,F] (same dtype). Per-block partials over spatial tiles,
    then a fixed-order column sum."""
    _check_act("src", src)
    _check_like("dp", dp, src)
    c, f = src.shape[3], dp.shape[3]
    pro = _prologue_args(affine, drop, c, src.device)
    if src.device.type == "cpu":
        return conv3x3_wgrad_reference(src, dp, affine, drop)
    dw = _launch_wgrad(src, dp, pro=pro).view(3, 3, c, f)
    conv3x3_wgrad_nhwc.launches += 1
    return dw


@launch_counter
def conv3x3_wgrad_pair(xa, xb, dp):
    """K10: the pair conv's weight gradients (identity operands) in one
    launch: returns (dW_skip [3,3,Ca,F], dW_up [3,3,Cb,F]) fp32."""
    _check_act("xa", xa)
    _check_like("xb", xb, xa)
    _check_like("dp", dp, xa)
    ca, cb, f = xa.shape[3], xb.shape[3], dp.shape[3]
    if xa.device.type == "cpu":
        return conv3x3_wgrad_pair_reference(xa, xb, dp)
    dw = _launch_wgrad(xa, dp, src2=xb)
    conv3x3_wgrad_pair.launches += 1
    return (dw[:9 * ca * f].view(3, 3, ca, f),
            dw[9 * ca * f:].view(3, 3, cb, f))


# ---------------------------------------------------------------------------
# BN glue (tiny per-channel math, as the JAX package's jnp glue)
# ---------------------------------------------------------------------------

def finalize_stats(sums: torch.Tensor, n: int):
    """[2, F] [sum, sum^2] -> (mean, biased var clamped at 0)."""
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    return mean, var


def bn_affine(scale, bias, mean, var):
    """Fold BN into a per-channel affine: a = scale/sqrt(var+eps),
    b = bias - a*mean (fp32 [F])."""
    a = scale / torch.sqrt(var + BN_EPS)
    return a.float().contiguous(), (bias - a * mean).float().contiguous()


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """HWIO [3,3,C,F] -> the dgrad weights [3,3,F,C] (spatial flip, I/O
    swap)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


# ---------------------------------------------------------------------------
# autograd assembly
# ---------------------------------------------------------------------------

def block_forward(x, w1, b1, scale1, bias1, w2, b2, scale2, bias2,
                  run_stats, train: bool, drop):
    """ConvBlock forward on kernels A and C (conv_block.py ``_forward``).

    ``x`` NHWC in the compute dtype, or a pair (skip, up) of such tensors
    whose channel concat is conv1's input (kernel K8); weights and BN
    parameters fp32. ``run_stats`` (mean1, var1, mean2, var2) normalizes in
    eval mode; ``drop`` is a :class:`HashDropout` or None. Returns (y, stats,
    residuals): stats are the batch statistics in train mode (copies of
    ``run_stats`` in eval mode) and residuals (x, w1, w2 in the compute
    dtype, conv1 output h, conv2 output g) feed :func:`block_backward`."""
    pair = isinstance(x, (tuple, list))
    x0 = x[0] if pair else x
    dtype = x0.dtype
    w1c = w1.to(dtype).contiguous()
    w2c = w2.to(dtype).contiguous()
    n = x0.numel() // x0.shape[-1]
    if pair:
        h, s1 = conv3x3_pair_nhwc(x[0], x[1], w1c, b1.float().contiguous(),
                                  want_stats=train)
    else:
        h, s1 = conv3x3_nhwc(x, w1c, b1.float().contiguous(),
                             want_stats=train)
    if train:
        mean1, var1 = finalize_stats(s1, n)
    else:
        mean1, var1 = (t.clone() for t in run_stats[:2])
    a1, c1 = bn_affine(scale1, bias1, mean1, var1)
    g, s2 = conv3x3_nhwc(h, w2c, b2.float().contiguous(), affine=(a1, c1),
                         drop=drop, want_stats=train)
    if train:
        mean2, var2 = finalize_stats(s2, n)
    else:
        mean2, var2 = (t.clone() for t in run_stats[2:])
    a2, c2 = bn_affine(scale2, bias2, mean2, var2)
    y = bn_act(g, a2, c2)
    return y, (mean1, var1, mean2, var2), (x, w1c, w2c, h, g)


def block_backward(dy, residuals, scale1, bias1, scale2, bias2, stats, drop,
                   need_dx=True):
    """Train-mode ConvBlock backward, in the order of conv_block.py ``_bwd``
    with its default folds: BN2 backward (D), conv2 dgrad times the forward
    dropout mask with BN1's backward reduce in its epilogue (K11), conv2
    wgrad recomputing lrelu(BN1(h))*mask (B), BN1's elementwise backward
    (D, dpre only), conv1 dgrad (A; K9 for a pair) and wgrad (B; K10 for a
    pair). ``need_dx``: whether conv1's input needs a gradient (a pair of
    flags for a pair input). Returns (dx, dw1, dscale1, dbias1, dw2,
    dscale2, dbias2); dx is None where no gradient is needed, and a pair
    (dx_skip, dx_up) for a pair input."""
    x, w1c, w2c, h, g = residuals
    mean1, var1, mean2, var2 = stats
    dy = dy.to(h.dtype).contiguous()

    a2, c2 = bn_affine(scale2, bias2, mean2, var2)
    inv2 = (1.0 / torch.sqrt(var2 + BN_EPS)).float().contiguous()
    s2, dg = bn_act_bwd(dy, g, a2, c2, mean2.float().contiguous(), inv2)
    a1, c1 = bn_affine(scale1, bias1, mean1, var1)
    inv1 = (1.0 / torch.sqrt(var1 + BN_EPS)).float().contiguous()
    m1 = mean1.float().contiguous()
    dd, s1 = conv3x3_dgrad_reduce(dg, flip_transpose(w2c), h, a1, c1, m1,
                                  inv1, out_drop=drop)
    dw2 = conv3x3_wgrad_nhwc(h, dg, affine=(a1, c1), drop=drop)

    dh = bn_act_dpre(dd, h, a1, c1, m1, inv1, s1)
    if isinstance(x, (tuple, list)):
        need = (need_dx, need_dx) if isinstance(need_dx, bool) else need_dx
        dx = None
        if any(need):
            dx = conv3x3_dgrad_pair(dh, flip_transpose(w1c), x[0].shape[-1])
            dx = tuple(d if nd else None for d, nd in zip(dx, need))
        dw1 = torch.cat(conv3x3_wgrad_pair(x[0], x[1], dh), dim=2)
    else:
        dx = conv3x3_nhwc(dh, flip_transpose(w1c))[0] if need_dx else None
        dw1 = conv3x3_wgrad_nhwc(x, dh)
    return dx, dw1, s1[1], s1[0], dw2, s2[1], s2[0]


class FusedConvBlock(torch.autograd.Function):
    """The fused ConvBlock (conv_block.py ``fused_conv_block``).

    apply(x, w1, b1, scale1, bias1, w2, b2, scale2, bias2, run_stats, train,
    drop, x2=None) -> (y, mean1, var1, mean2, var2); see
    :func:`block_forward`. With ``x2`` the input is the pair (x, x2): skip
    and upsampled halves of an UpBlock, each with its own gradient. No
    gradient flows through the returned statistics; the backward is train
    mode only, and the conv-bias gradients are exactly zero (the biases feed
    BN, whose batch mean absorbs them)."""

    @staticmethod
    def forward(ctx, x, w1, b1, scale1, bias1, w2, b2, scale2, bias2,
                run_stats, train, drop, x2=None):
        inp = x if x2 is None else (x, x2)
        y, stats, residuals = block_forward(inp, w1, b1, scale1, bias1, w2,
                                            b2, scale2, bias2, run_stats,
                                            train, drop)
        ctx.train, ctx.drop = train, drop
        ctx.save_for_backward(x, x2, *residuals[1:], scale1, bias1, scale2,
                              bias2, *stats)
        ctx.mark_non_differentiable(*stats)
        return (y, *stats)

    @staticmethod
    def backward(ctx, dy, *_unused):
        if not ctx.train:
            raise RuntimeError("FusedConvBlock backward: train mode only")
        x, x2, *saved = ctx.saved_tensors
        needs = ctx.needs_input_grad
        pair = x2 is not None
        residuals = ((x, x2) if pair else x, *saved[:4])
        need_dx = (needs[0], needs[12]) if pair else needs[0]
        dx, dw1, dscale1, dbias1, dw2, dscale2, dbias2 = block_backward(
            dy, residuals, *saved[4:8], saved[8:], ctx.drop, need_dx=need_dx)
        dx, dx2 = dx if pair and dx is not None else (dx, None)
        zero = torch.zeros_like(dbias1)
        grads = (dx, dw1, zero, dscale1, dbias1, dw2, zero.clone(), dscale2,
                 dbias2, None, None, None, dx2)
        return grads[:len(needs)]


class Conv3x3Plain(torch.autograd.Function):
    """SAME 3x3 conv + bias (conv_block.py ``fused_conv3x3_plain``): kernel
    A forward; backward is kernel A on the flipped weights (dx), kernel B
    (dW) and db = sum(dy)."""

    @staticmethod
    def forward(ctx, x, w, b):
        wc = w.to(x.dtype).contiguous()
        y, _ = conv3x3_nhwc(x, wc, b.float().contiguous())
        ctx.save_for_backward(x, wc)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, wc = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dx, _ = conv3x3_nhwc(dy, flip_transpose(wc))
        dw = conv3x3_wgrad_nhwc(x, dy)
        db = dy.float().sum((0, 1, 2))
        return dx, dw, db


def conv3x3_plain(x, w, b):
    """SAME 3x3 conv + bias of NHWC ``x`` (compute dtype) with fp32 HWIO
    ``w`` [3,3,C,F] and fp32 ``b`` [F]; output in x's dtype."""
    return Conv3x3Plain.apply(x.contiguous(), w, b)


def conv_block_reference(x, w1, b1, scale1, bias1, w2, b2, scale2, bias2,
                         mask=None, train=True, run_stats=None):
    """Autograd-differentiable plain block (conv_block.py
    ``conv_block_reference``): fp32 BN with biased batch variance, LeakyReLU
    0.01, a pre-scaled NHWC ``mask`` between the convs. Returns (y, (mean1,
    var1, mean2, var2))."""
    dtype = x.dtype

    def conv(t, w, b):
        o = F.conv2d(t.float().permute(0, 3, 1, 2),
                     w.to(dtype).float().permute(3, 2, 0, 1), padding=1)
        return o.permute(0, 2, 3, 1) + b

    def bn(pre, scale, bias, mean, var):
        return _lrelu((pre - mean) / torch.sqrt(var + BN_EPS) * scale + bias)

    def stats(t):
        m = t.mean((0, 1, 2))
        return m, (t * t).mean((0, 1, 2)) - m * m

    hh = conv(x, w1, b1)
    m1, v1 = stats(hh) if train else run_stats[:2]
    a = bn(hh, scale1, bias1, m1, v1)
    if mask is not None:
        a = a * mask
    g = conv(a.to(dtype), w2, b2)
    m2, v2 = stats(g) if train else run_stats[2:]
    y = bn(g, scale2, bias2, m2, v2)
    return y.to(dtype), (m1, v1, m2, v2)
