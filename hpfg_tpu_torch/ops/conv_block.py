"""Fused UNet ConvBlock and plain 3x3 conv on hand-written Hopper kernels.

Port of ``hpfg_tpu/ops/pallas/conv_block.py``. The block is
conv3x3 -> BN -> LeakyReLU -> hash dropout -> conv3x3 -> BN -> LeakyReLU on
NHWC activations with HWIO ``[3, 3, C, F]`` weights. Train mode runs it as
three kernel launches, as on the TPU:

  1. conv1 + bias, with per-channel [sum, sum^2] of the fp32 result
     (``conv3x3_nhwc``, kernel A);
  2. BN1 affine + LeakyReLU + dropout fused into conv2's operand load, then
     conv2 + bias + statistics (``conv3x3_nhwc`` with a prologue);
  3. BN2 affine + LeakyReLU (``bn_act``, kernel C).

The backward (``FusedConvBlock.backward``) follows the Pallas ``_bwd``:
BN2 backward (``bn_act_bwd``, kernel D), conv2's input gradient
(kernel A on the flipped, transposed weights, times the forward dropout
mask), conv2's weight gradient (``conv3x3_wgrad_nhwc``, kernel B, which
recomputes lrelu(BN1(h))*mask from the conv1 output), BN1 backward, then
conv1's input and weight gradients.

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
from hpfg_tpu_torch.ops.bn_act import LRELU_SLOPE, bn_act, bn_act_bwd

BN_EPS = 1e-5

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
_MUR1 = 0x85EBCA6B
_MUR2 = 0xC2B2AE35

# channels per block in the wgrad kernel (csrc/conv3x3.cu CC)
WGRAD_CC = 16
# blocks the wgrad kernel aims for (a few waves of the H100's 132 SMs)
WGRAD_TARGET_BLOCKS = 2048


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


def hash_mask(seed: int, batch: int, h: int, lanes: int, keep: float,
              device=None) -> torch.Tensor:
    """The pre-scaled dropout mask [batch, h, lanes] (1/keep or 0, fp32) the
    kernels regenerate: murmur3-style finalizer of
    v = row*lanes + lane plus (seed + image*0x9E3779B9), in uint32
    (conv_block.py ``_hash_mask``; ``lanes`` = W*C of the masked tensor)."""
    spec = HashDropout(seed, keep)
    rows = torch.arange(h, dtype=torch.int64, device=device).view(1, h, 1)
    lane = torch.arange(lanes, dtype=torch.int64, device=device).view(1, 1, -1)
    img = torch.arange(batch, dtype=torch.int64, device=device).view(-1, 1, 1)
    v = (rows * lanes + lane) & _M32
    x = (v + ((int(seed) + img * _GOLD) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _MUR1)
    x = x ^ (x >> 13)
    x = _mul32(x, _MUR2)
    x = x ^ (x >> 16)
    return torch.where(x < spec.thresh, spec.scale, 0.0).to(torch.float32)


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


def conv3x3_wgrad_reference(src, dp, affine=None, drop=None):
    """Plain version of kernel B: dW[ky, kx, c, f] =
    sum_{b,y,x} src'[b, y+ky-1, x+kx-1, c] * dp[b, y, x, f] in fp32."""
    _, h, w, c = src.shape
    s = F.pad(_source(src, affine, drop), (0, 0, 1, 1, 1, 1))
    d = dp.to(src.dtype).float()
    taps = [torch.einsum("bhwc,bhwf->cf", s[:, ky:ky + h, kx:kx + w], d)
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps).view(3, 3, c, dp.shape[-1])


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
    if (w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c) or w.dtype != x.dtype
            or not w.is_contiguous()):
        raise ValueError(f"w: expected contiguous [3, 3, {c}, F] {x.dtype}, "
                         f"got {tuple(w.shape)} {w.dtype}")
    f = w.shape[3]
    if w.device != x.device:
        raise ValueError("w and x on different devices")
    _check_vec("bias", bias, f, x.device)
    pro = _prologue_args(affine, drop, c, x.device)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, bias, affine, drop, out_drop,
                                 want_stats)
    lib = library(x.device)
    y = torch.empty((b, h, wd, f), dtype=x.dtype, device=x.device)
    tiles = -(-h // lib.tile_h) * -(-wd // lib.tile_w)
    part = (torch.empty((b * tiles, 2 * f), dtype=torch.float32,
                        device=x.device) if want_stats else None)
    om = ([1, out_drop.seed, out_drop.thresh, out_drop.scale]
          if out_drop is not None else [0, 0, 0, 0.0])
    lib.call("hpfg_conv3x3_nhwc", ptr(x), ptr(w), ptr(bias), *pro, *om,
             ptr(y), ptr(part), b, h, wd, c, f,
             int(x.dtype == torch.bfloat16), stream(x))
    conv3x3_nhwc.launches += 1
    stats = colsum(part).view(2, f) if want_stats else None
    return y, stats


@launch_counter
def conv3x3_wgrad_nhwc(src, dp, affine=None, drop=None):
    """Kernel B: weight gradient dW [3,3,C,F] fp32 of a SAME 3x3 conv whose
    operand was ``src`` [B,H,W,C] (identity, or recomputed through the
    ``affine``/``drop`` prologue as in kernel A) and whose output cotangent
    is ``dp`` [B,H,W,F] (same dtype). Per-block partials over spatial tiles,
    then a fixed-order column sum."""
    _check_act("src", src)
    _check_act("dp", dp)
    b, h, wd, c = src.shape
    if dp.shape[:3] != src.shape[:3] or dp.dtype != src.dtype or \
            dp.device != src.device:
        raise ValueError(f"dp: expected [B,H,W,F] {src.dtype} matching src, "
                         f"got {tuple(dp.shape)} {dp.dtype}")
    f = dp.shape[3]
    pro = _prologue_args(affine, drop, c, src.device)
    if src.device.type == "cpu":
        return conv3x3_wgrad_reference(src, dp, affine, drop)
    lib = library(src.device)
    total = b * -(-h // lib.tile_h) * -(-wd // lib.tile_w)
    bn = 16 if f <= 16 else 32
    ch_tiles = -(-c // WGRAD_CC) * -(-f // bn)
    per_block = max(1, -(-total * ch_tiles // WGRAD_TARGET_BLOCKS))
    rows = -(-total // per_block)
    part = torch.empty((rows, 9 * c * f), dtype=torch.float32,
                       device=src.device)
    lib.call("hpfg_conv3x3_wgrad_nhwc", ptr(src), ptr(dp), *pro,
             ptr(part), b, h, wd, c, f, per_block,
             int(src.dtype == torch.bfloat16), stream(src))
    conv3x3_wgrad_nhwc.launches += 1
    return colsum(part).view(3, 3, c, f)


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

    ``x`` NHWC in the compute dtype; weights and BN parameters fp32.
    ``run_stats`` (mean1, var1, mean2, var2) normalizes in eval mode;
    ``drop`` is a :class:`HashDropout` or None. Returns (y, stats, residuals):
    stats are the batch statistics in train mode (copies of ``run_stats`` in
    eval mode) and residuals (x, w1, w2 in the compute dtype, conv1 output h,
    conv2 output g) feed :func:`block_backward`."""
    dtype = x.dtype
    w1c = w1.to(dtype).contiguous()
    w2c = w2.to(dtype).contiguous()
    n = x.numel() // x.shape[-1]
    h, s1 = conv3x3_nhwc(x, w1c, b1.float().contiguous(), want_stats=train)
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
                   need_dx: bool = True):
    """Train-mode ConvBlock backward on kernels A, B and D, in the order of
    conv_block.py ``_bwd``: BN2 backward, conv2 dgrad (times the forward
    dropout mask) and wgrad (recomputing lrelu(BN1(h))*mask), BN1 backward,
    conv1 dgrad (only if ``need_dx``) and wgrad. Returns (dx or None, dw1,
    dscale1, dbias1, dw2, dscale2, dbias2)."""
    x, w1c, w2c, h, g = residuals
    mean1, var1, mean2, var2 = stats
    dy = dy.to(h.dtype).contiguous()

    a2, c2 = bn_affine(scale2, bias2, mean2, var2)
    inv2 = (1.0 / torch.sqrt(var2 + BN_EPS)).float().contiguous()
    s2, dg = bn_act_bwd(dy, g, a2, c2, mean2.float().contiguous(), inv2)
    a1, c1 = bn_affine(scale1, bias1, mean1, var1)
    inv1 = (1.0 / torch.sqrt(var1 + BN_EPS)).float().contiguous()
    dd, _ = conv3x3_nhwc(dg, flip_transpose(w2c), out_drop=drop)
    dw2 = conv3x3_wgrad_nhwc(h, dg, affine=(a1, c1), drop=drop)

    s1, dh = bn_act_bwd(dd, h, a1, c1, mean1.float().contiguous(), inv1)
    dx = conv3x3_nhwc(dh, flip_transpose(w1c))[0] if need_dx else None
    dw1 = conv3x3_wgrad_nhwc(x, dh)
    return dx, dw1, s1[1], s1[0], dw2, s2[1], s2[0]


class FusedConvBlock(torch.autograd.Function):
    """The fused ConvBlock (conv_block.py ``fused_conv_block``).

    apply(x, w1, b1, scale1, bias1, w2, b2, scale2, bias2, run_stats, train,
    drop) -> (y, mean1, var1, mean2, var2); see :func:`block_forward`. No
    gradient flows through the returned statistics; the backward is train
    mode only, and the conv-bias gradients are exactly zero (the biases feed
    BN, whose batch mean absorbs them)."""

    @staticmethod
    def forward(ctx, x, w1, b1, scale1, bias1, w2, b2, scale2, bias2,
                run_stats, train, drop):
        y, stats, residuals = block_forward(x, w1, b1, scale1, bias1, w2, b2,
                                            scale2, bias2, run_stats, train,
                                            drop)
        ctx.train, ctx.drop = train, drop
        ctx.save_for_backward(*residuals, scale1, bias1, scale2, bias2,
                              *stats)
        ctx.mark_non_differentiable(*stats)
        return (y, *stats)

    @staticmethod
    def backward(ctx, dy, *_unused):
        if not ctx.train:
            raise RuntimeError("FusedConvBlock backward: train mode only")
        saved = ctx.saved_tensors
        dx, dw1, dscale1, dbias1, dw2, dscale2, dbias2 = block_backward(
            dy, saved[:5], *saved[5:9], saved[9:], ctx.drop,
            need_dx=ctx.needs_input_grad[0])
        zero = torch.zeros_like(dbias1)
        return (dx, dw1, zero, dscale1, dbias1, dw2, zero.clone(), dscale2,
                dbias2, None, None, None)


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
