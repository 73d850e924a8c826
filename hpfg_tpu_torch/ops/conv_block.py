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
counts its launches in ``<wrapper>.launches`` and reports its operations
to an active ``utils.profiling.count_flops`` (``_cuda.counted``). A, B and
K8 to K11 have two routes on the card, counted in ``<wrapper>.routes``: a
bf16 call whose channels TMA can take runs csrc/conv3x3_sm90.cu's wgmma
kernels (``conv_route``, with the forms "dgrad_pair" for K9 and
"dgrad_reduce" for K11, and ``pair_route`` for K8 and K10), every other
call the mma.sync kernels of csrc/conv3x3.cu: fp32, channels (or K9's
split) not multiples of 8, unaligned bases, A with an output mask, and
B's prologue form below WGRAD_PROLOGUE_MIN_C channels (a static rule
from the card's timings; K9 and K11 on wgmma measured faster than on
mma.sync at every main-path shape, so they need none). No call falls
back from one route to the other. On wgmma, A, K8 and K11 take their
sums (BN statistics, or K11's [sum dz, sum dz * xhat]) in the kernel's
last CTA, so no column-sum launch follows; K9's two outputs leave one
kernel. A has a third route, "stem": a bf16 stem forward (C = 1 or 3 into
F = 16 or 32, rows of whole 16-byte units: ``stem_ok``) takes K12's own
kernel (csrc/stem_sm90.cu: the taps packed into the MMA's K, the halo and
the output by TMA, the statistics summed in the kernel), one launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

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
from hpfg_tpu_torch.ops.bn_act import (
    LRELU_SLOPE,
    bn_act,
    bn_act_bwd,
    bn_act_bwd_reference,
    bn_act_dpre,
    bn_reduce,
)
from hpfg_tpu_torch.parallel.distributed import all_reduce_sum, spans_ranks

BN_EPS = 1e-5

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
_MUR1 = 0x85EBCA6B
_MUR2 = 0xC2B2AE35

# blocks the wgrad kernel aims for (a few waves of the H100's 132 SMs)
WGRAD_TARGET_BLOCKS = 2048
# the most bytes its per-block dW partials may take
WGRAD_PART_BYTES = 2 ** 25
# A, B, K8 and K10 on wgmma (csrc/conv3x3_sm90.cu): the CTAs per SM each
# grid aims at (the conv: two of two warpgroups; the wgrad: one of three,
# with four TMA stages of up to 40 KB), the channels of one TMA channel
# group, the wgrad's groups per CTA, and the most bytes the conv's
# resident weights may take
PAIR_CONV_CTAS_PER_SM = 2
PAIR_WGRAD_CTAS_PER_SM = 1
PAIR_GROUP = 16
PAIR_WGRAD_GROUPS = 4
PAIR_RESIDENT_BYTES = 48 * 1024
# A on wgmma: the tall 16 x 16 tile serves images at most CONV_TALL_MAX_W
# wide (at F >= 32); the N tile is halved while the grid's CTAs would
# number fewer than CONV_MIN_FILL of the SMs. B on wgmma: its fp32 dW
# partials take at most WGRAD_SM90_PART_RATIO times its operands' bytes
# (a cap of 1/4 measured 2.2-5.4x slower at 14^2 to 56^2, where fewer
# CTAs fill the card: PERF.md); its prologue form takes the mma
# route below WGRAD_PROLOGUE_MIN_C input channels (the 224^2 stage's 16:
# measured faster there on the mma.sync kernel, two CTAs an SM)
CONV_TALL_MAX_W = 16
CONV_MIN_FILL = 0.9
WGRAD_SM90_PART_RATIO = 4.0
WGRAD_PROLOGUE_MIN_C = 32
#: K9 on wgmma: the 64-wide TMA store boxes of an N tile of 64 or more
#: must not straddle the split, so a split whose halves are not both
#: multiples of PAIR_STORE_BOX caps the N tile at 32 (stored from the
#: registers, which may straddle at any multiple of 8)
PAIR_STORE_BOX = 64
#: the routes of A, B and K8 to K11: "wgmma" (csrc/conv3x3_sm90.cu) and
#: "mma" (the mma.sync kernels of csrc/conv3x3.cu); A has a third, "stem"
#: (K12, csrc/stem_sm90.cu)
ROUTES = ("wgmma", "mma")
#: K12 on its own kernel: the stems' input and output channels, and the
#: CTAs an SM of its persistent grid (two timed faster than one,
#: scripts/tune_conv_kernels.py; PERF.md)
STEM_CHANNELS = (1, 3)
STEM_FEATURES = (16, 32)
STEM_CTAS_PER_SM = 2
#: the forms of a call that :func:`conv_route` tells apart: A's and B's,
#: then K9's and K11's
CONV_FORMS = ("conv", "prologue", "out_drop", "wgrad", "wgrad_prologue",
              "dgrad_pair", "dgrad_reduce")


@dataclass(frozen=True)
class HashDropout:
    """In-kernel dropout: keep probability and a per-block seed in
    [0, 2^23). The mask is regenerated from (seed, image, row, lane).
    ``image_ids``: int32 [B] on the data's device, each local image's index
    in the global batch (data parallelism: ``parallel.mesh.Rows``), which
    the hash takes as the image; None takes the local index, arange(B).
    ``total``: the global batch's image count, which sets the attention
    kernels' window block; they require it with ``image_ids`` (the conv
    kernels do not read it)."""

    seed: int
    keep: float
    image_ids: torch.Tensor | None = None
    total: int | None = None

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
              device=None, image_ids: torch.Tensor | None = None
              ) -> torch.Tensor:
    """The pre-scaled dropout mask [batch, h, lanes] (1/keep or 0, fp32) the
    conv kernels regenerate: :func:`hash_keep` of v = row*lanes + lane with
    the image as ``b_idx`` (``lanes`` = W*C of the masked tensor): image i's
    index in the global batch, ``image_ids[i]``, or i without ids."""
    rows = torch.arange(h, dtype=torch.int64, device=device).view(1, h, 1)
    lane = torch.arange(lanes, dtype=torch.int64, device=device).view(1, 1, -1)
    if image_ids is None:
        img = torch.arange(batch, dtype=torch.int64, device=device)
    else:
        img = image_ids.to(device=device, dtype=torch.int64)
    return hash_keep(seed, img.view(-1, 1, 1), rows * lanes + lane, keep)


def _nhwc_mask(drop: HashDropout, shape, device) -> torch.Tensor:
    b, h, w, c = shape
    return hash_mask(drop.seed, b, h, w * c, drop.keep, device,
                     drop.image_ids).view(b, h, w, c)


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


def _check_ids(drop, batch: int, device) -> None:
    """A dropout's image ids: int32 [batch], contiguous, on ``device``."""
    ids = None if drop is None else drop.image_ids
    if ids is None:
        return
    if ids.dtype != torch.int32 or tuple(ids.shape) != (batch,) or \
            not ids.is_contiguous() or ids.device != device:
        raise ValueError(f"image_ids: expected contiguous int32 [{batch}] on "
                         f"{device}, got {ids.dtype} {tuple(ids.shape)} on "
                         f"{ids.device}")


#: the prologue arguments of a launch without one
_NO_PROLOGUE = [None, None, 0, 0, 0, 0.0, None]
#: the output-mask arguments of a launch without one
_NO_MASK = [0, 0, 0, 0.0, None]


def _prologue_args(affine, drop, c, batch, device):
    if affine is None:
        if drop is not None:
            raise ValueError("dropout needs the affine prologue")
        return _NO_PROLOGUE
    _check_vec("affine[0]", affine[0], c, device)
    _check_vec("affine[1]", affine[1], c, device)
    if drop is None:
        return [ptr(affine[0]), ptr(affine[1]), 0, 0, 0, 0.0, None]
    _check_ids(drop, batch, device)
    return [ptr(affine[0]), ptr(affine[1]), 1, drop.seed, drop.thresh,
            drop.scale, ptr(drop.image_ids)]


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


def pair_route(ca: int, cb: int, f: int, dtype, aligned: bool) -> str:
    """The kernel a pair call (K8, K10) takes on the card. "wgmma" where
    TMA can take its tensors: bf16 (wgmma has no fp32 product at fp32
    precision), Ca, Cb and F multiples of 8 (a tensor map's strides are
    multiples of 16 bytes) and every base 16-byte aligned (``aligned``).
    Anything else, the GPU tests' 12 + 20 split, odd splits at small
    stages and fp32, takes "mma": PR 4's kernels, which stage any split
    element by element. No call falls back from one to the other."""
    ok = (dtype == torch.bfloat16 and aligned and ca % 8 == 0
          and cb % 8 == 0 and f % 8 == 0)
    return "wgmma" if ok else "mma"


def stem_ok(c: int, f: int, dtype, aligned: bool, width: int) -> bool:
    """Whether a plain conv forward (form "conv") is a stem that K12's
    kernel takes: bf16, C = 1 or 3 into F = 16 or 32, 16-byte aligned
    bases, and image rows of whole 16-byte units (W * C * 2 bytes: the
    stride of the TMA map over x viewed as [B, H, W * C]). An odd eval
    width fails the last and keeps the mma route."""
    return (dtype == torch.bfloat16 and aligned and c in STEM_CHANNELS
            and f in STEM_FEATURES and width * c * 2 % 16 == 0)


def conv_route(c: int, f: int, dtype, aligned: bool, form: str,
               split: int | None = None, width: int | None = None) -> str:
    """The kernel an A, B, K9 or K11 call takes on the card: "wgmma"
    (csrc/conv3x3_sm90.cu) where TMA can take its tensors, as for
    :func:`pair_route`: bf16, C and F multiples of 8 and 16-byte aligned
    bases (``aligned``). ``c``, ``f``: the conv's input and output
    channels (a dgrad's input is the cotangent). ``form``: "conv" (A on
    an identity operand: a conv1 or plain conv forward, a dgrad on the
    flip-transposed weights), "prologue" (A through BN + LeakyReLU +
    dropout), "out_drop" (A with an output mask, which only K11's wgmma
    epilogue applies), "wgrad" (B, identity operand), "wgrad_prologue",
    "dgrad_pair" (K9: F = Ca + Cb split at ``split`` = Ca, which must be
    a multiple of 8 too: the GPU tests' 12 + 20 is not) or
    "dgrad_reduce" (K11: the dgrad with its output mask and BN1's
    backward reduce). A "conv" call whose image is ``width`` wide takes
    "stem" (K12's kernel, csrc/stem_sm90.cu) where :func:`stem_ok` holds.
    The other C = 1 and C = 3 stems, the F = 4, 2 and 9 heads (and their
    dgrads), fp32, "out_drop" and, by a static rule from the card's
    timings, "wgrad_prologue" below WGRAD_PROLOGUE_MIN_C channels take
    "mma": conv3x3.cu's (K9 and K11 on wgmma measured faster than on mma
    at every main-path shape, 224^2 included). No call falls back from
    one to the other."""
    if form not in CONV_FORMS:
        raise ValueError(f"form {form!r} not in {CONV_FORMS}")
    if (form == "dgrad_pair") != (split is not None):
        raise ValueError("a split goes with the dgrad_pair form alone")
    if form == "conv" and width is not None and stem_ok(c, f, dtype,
                                                        aligned, width):
        return "stem"
    ok = (dtype == torch.bfloat16 and aligned and c % 8 == 0
          and f % 8 == 0 and form != "out_drop"
          and not (form == "wgrad_prologue" and c < WGRAD_PROLOGUE_MIN_C)
          and not (form == "dgrad_pair" and split % 8))
    return "wgmma" if ok else "mma"


def _n_tile(f: int, most: int) -> int:
    """The wgmma N tile for F output channels: F rounded up to 16, 32, 64
    or 128, at most ``most`` (more channels take more N tiles)."""
    return next(n for n in (16, 32, 64, 128) if n >= min(f, most))


def pair_tile_origin(t: int, h: int, w: int,
                     tile: tuple[int, int]) -> tuple[int, int, int]:
    """(image, first row, first column) of pixel tile ``t`` in the wgmma
    kernels' walk over [*, h, w]: images, then tile rows, then tile
    columns (``tile_of`` in csrc/conv3x3_sm90.cu); CTA i of a grid walks
    tiles [i * tiles_per_cta, (i + 1) * tiles_per_cta)."""
    tiles_x = -(-w // tile[1])
    per_img = tiles_x * -(-h // tile[0])
    b, tt = divmod(t, per_img)
    return b, tt // tiles_x * tile[0], tt % tiles_x * tile[1]


def pair_group(g: int, ca: int) -> tuple[int, int]:
    """Channel group ``g`` of a pair in the wgmma kernels (PAIR_GROUP
    channels each, xa's groups first, then xb's): (source 0 for xa or 1
    for xb, its first channel there) (``group_src`` in
    csrc/conv3x3_sm90.cu). A source's last group may reach past its
    channels: TMA reads zeros there."""
    na = -(-ca // PAIR_GROUP)
    return (0, PAIR_GROUP * g) if g < na else (1, PAIR_GROUP * (g - na))


class ConvGrid(NamedTuple):
    """A wgmma conv launch (A, K8): N tile, tiles a CTA walks, CTAs over
    the tiles (the rows of its statistics partials), N tiles, resident
    weights, the tall 16 x 16 tile (else 8 x 32)."""
    n_tile: int
    tiles_per_cta: int
    ctas: int
    n_tiles: int
    resident: bool
    tall: bool = False


def pair_conv_grid(b: int, h: int, w: int, ca: int, cb: int, f: int,
                   tile: tuple[int, int], sms: int) -> ConvGrid:
    """K8's wgmma grid: CTAs of ``tile`` pixel tiles (8 x 32), about
    PAIR_CONV_CTAS_PER_SM an SM over the N tiles, each walking a run of
    consecutive tiles; the weights of every 16-channel chunk stay resident
    when they fit PAIR_RESIDENT_BYTES."""
    total = conv_tiles(b, h, w, tile)
    bn = _n_tile(f, 128)
    n_tiles = -(-f // bn)
    per = max(1, -(-total * n_tiles // (sms * PAIR_CONV_CTAS_PER_SM)))
    chunks = -(-ca // PAIR_GROUP) + -(-cb // PAIR_GROUP)
    resident = chunks * 9 * PAIR_GROUP * bn * 2 <= PAIR_RESIDENT_BYTES
    return ConvGrid(bn, per, -(-total // per), n_tiles, resident)


def conv_grid(b: int, h: int, w: int, c: int, f: int,
              tiles: dict, sms: int, most: int = 128) -> ConvGrid:
    """A's and K11's wgmma grid for one source of ``c`` channels (K9's
    with ``most``): the tall tile (``tiles[True]``, 16 x 16) where the
    image is at most CONV_TALL_MAX_W wide and F >= 32 (a 14 x 14 image
    fills 77% of one, 38% of two 8 x 32), else the wide one
    (``tiles[False]``); the N tile F rounded up to 16, 32, 64 or 128, at
    most ``most``, halved (down to 32 tall, 16 wide) while the CTAs over
    the tiles and N tiles would number fewer than CONV_MIN_FILL of
    ``sms`` (14^2 at batch 32: 32 tiles); the run of tiles a CTA walks and
    the resident weights as :func:`pair_conv_grid`'s."""
    tall = w <= CONV_TALL_MAX_W and f >= 32
    total = conv_tiles(b, h, w, tiles[tall])
    bn = _n_tile(f, most)
    while bn > (32 if tall else 16) and total * -(-f // bn) < \
            CONV_MIN_FILL * sms:
        bn //= 2
    n_tiles = -(-f // bn)
    per = max(1, -(-total * n_tiles // (sms * PAIR_CONV_CTAS_PER_SM)))
    resident = (-(-c // PAIR_GROUP) * 9 * PAIR_GROUP * bn * 2
                <= PAIR_RESIDENT_BYTES)
    return ConvGrid(bn, per, -(-total // per), n_tiles, resident, tall)


def dgrad_pair_grid(b: int, h: int, w: int, f: int, ca: int, cb: int,
                    tiles: dict, sms: int) -> ConvGrid:
    """K9's wgmma grid: :func:`conv_grid`'s for the dgrad from ``f`` to Ca +
    Cb channels, its N tile at most 32 unless both halves are multiples of
    PAIR_STORE_BOX (an N tile of 64 or more stores 64-wide TMA boxes,
    which must each lie in one half: at 32 + 32 two N tiles of 32, one a
    half, stored from the registers)."""
    most = (128 if ca % PAIR_STORE_BOX == 0 and cb % PAIR_STORE_BOX == 0
            else 32)
    return conv_grid(b, h, w, f, ca + cb, tiles, sms, most)


class WgradGrid(NamedTuple):
    """A wgmma wgrad launch (B, K10): N tile, tiles a CTA walks, CTAs over
    the tiles (the rows of its dW partials), channel blocks of
    PAIR_WGRAD_GROUPS 16-channel groups, N tiles."""
    n_tile: int
    tiles_per_cta: int
    ctas: int
    channel_blocks: int
    n_tiles: int


def pair_wgrad_grid(b: int, h: int, w: int, ca: int, cb: int, f: int,
                    tile: tuple[int, int], sms: int) -> WgradGrid:
    """K10's wgmma grid: 16-channel groups of xa then xb, four a channel
    block; N tiles of up to 64; CTAs of ``tile`` pixel tiles (8 x 16),
    about PAIR_WGRAD_CTAS_PER_SM an SM over the blocks, each walking a run
    of consecutive tiles into its own partial row."""
    total = conv_tiles(b, h, w, tile)
    bn = _n_tile(f, 64)
    n_tiles = -(-f // bn)
    groups = -(-ca // PAIR_GROUP) + -(-cb // PAIR_GROUP)
    blocks = -(-groups // PAIR_WGRAD_GROUPS)
    per = max(1, -(-total * blocks * n_tiles
                   // (sms * PAIR_WGRAD_CTAS_PER_SM)))
    return WgradGrid(bn, per, -(-total // per), blocks, n_tiles)


def wgrad_grid(b: int, h: int, w: int, c: int, f: int,
               tile: tuple[int, int], sms: int) -> WgradGrid:
    """B's wgmma grid for one source of ``c`` channels: as
    :func:`pair_wgrad_grid`'s, each CTA's run of tiles lengthened until
    the [ctas, 9*C*F] fp32 partials take at most WGRAD_SM90_PART_RATIO
    times the bytes of x and dp (at least one row, which is dW itself)."""
    g = pair_wgrad_grid(b, h, w, c, 0, f, tile, sms)
    total = conv_tiles(b, h, w, tile)
    rows = max(1, int(WGRAD_SM90_PART_RATIO * 2 * b * h * w * (c + f))
               // (4 * 9 * c * f))
    per = max(g.tiles_per_cta, -(-total // rows))
    return g._replace(tiles_per_cta=per, ctas=-(-total // per))


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _mask_args(out_drop) -> list:
    """The output-mask arguments of a launch: ``out_drop``'s, or none."""
    if out_drop is None:
        return _NO_MASK
    return [1, out_drop.seed, out_drop.thresh, out_drop.scale,
            ptr(out_drop.image_ids)]


def _reduce_args(reduce) -> list:
    """K11's reduce arguments (pre, a, b, mean, inv) of a launch, or
    none."""
    return [ptr(t) for t in reduce] if reduce is not None else [None] * 5


def _sm90_conv(xa, xb, w, bias, y, pro, want_stats, g: ConvGrid, *,
               y2=None, out_drop=None, reduce=None):
    """One launch of the wgmma conv (``hpfg_conv_sm90``) on grid ``g`` into
    ``y``: K8 over xa || xb, or A over xa alone (``xb`` None) through its
    prologue ``pro`` (``_prologue_args``); with ``y2`` the output's
    channels from y's count on go there (K9's split); ``reduce`` = (pre,
    a, b, mean, inv): K11's epilogue, ``out_drop``'s mask then BN1's
    backward sums in place of the statistics. Its last CTA sums the
    statistics (or those sums). Returns them as [2, F] when
    ``want_stats``, else None."""
    lib = library(xa.device)
    b, h, wd, ca = xa.shape
    cb = 0 if xb is None else xb.shape[3]
    f = w.shape[3]
    part = stats = counter = None
    if want_stats:
        part = torch.empty((g.ctas, 2 * f), dtype=torch.float32,
                           device=xa.device)
        stats = torch.empty(2 * f, dtype=torch.float32, device=xa.device)
        counter = ticket(xa.device, "conv_sm90")
    lib.call("hpfg_conv_sm90", ptr(xa), ptr(xb), ptr(w), ptr(bias), ptr(y),
             ptr(y2), ptr(part), ptr(stats), ptr(counter), *pro,
             *_mask_args(out_drop), *_reduce_args(reduce), b, h, wd, ca, cb,
             f, y.shape[3], g.n_tile, int(g.tall), g.tiles_per_cta, g.ctas,
             int(g.resident), stream(xa))
    return stats.view(2, f) if want_stats else None


def _sm90_wgrad(xa, xb, dp, pro, g: WgradGrid):
    """One launch of the wgmma wgrad (``hpfg_wgrad_sm90``) on grid ``g``
    (K10 over xa and xb; B over xa alone, ``xb`` None, through ``pro``),
    then the fixed-order column sum of its partial rows (none for one
    row): [9 * C * F] fp32, [3,3,Ca,F] then [3,3,Cb,F]."""
    lib = library(xa.device)
    b, h, wd, ca = xa.shape
    cb = 0 if xb is None else xb.shape[3]
    f = dp.shape[3]
    part = torch.empty((g.ctas, 9 * (ca + cb) * f), dtype=torch.float32,
                       device=xa.device)
    lib.call("hpfg_wgrad_sm90", ptr(xa), ptr(xb), ptr(dp), ptr(part), *pro,
             b, h, wd, ca, cb, f, g.n_tile, g.tiles_per_cta, g.ctas,
             g.channel_blocks, stream(xa))
    return part[0] if g.ctas == 1 else colsum(part)


def _launch_pair_conv(xa, xb, w, bias, y, want_stats):
    """K8 on wgmma at :func:`pair_conv_grid`'s grid (``_sm90_conv``)."""
    lib = library(xa.device)
    b, h, wd, ca = xa.shape
    g = pair_conv_grid(b, h, wd, ca, xb.shape[3], w.shape[3],
                       lib.pair_conv_tile, sm_count(xa.device))
    return _sm90_conv(xa, xb, w, bias, y, _NO_PROLOGUE, want_stats, g)


def _launch_pair_wgrad(xa, xb, dp):
    """K10 on wgmma at :func:`pair_wgrad_grid`'s grid (``_sm90_wgrad``)."""
    lib = library(xa.device)
    b, h, wd, ca = xa.shape
    g = pair_wgrad_grid(b, h, wd, ca, xb.shape[3], dp.shape[3],
                        lib.pair_wgrad_tile, sm_count(xa.device))
    return _sm90_wgrad(xa, xb, dp, _NO_PROLOGUE, g)


def _launch_conv_sm90(x, w, y, *, bias=None, pro=None, want_sums=False):
    """A on wgmma at :func:`conv_grid`'s grid into ``y``, with the
    arguments of :func:`_launch_conv` (one source, no output mask, no
    reduce): returns the [2, F] statistics when ``want_sums``, else
    None."""
    lib = library(x.device)
    b, h, wd, c = x.shape
    g = conv_grid(b, h, wd, c, w.shape[3], lib.conv_sm90_tiles,
                  sm_count(x.device))
    return _sm90_conv(x, None, w, bias, y, pro or _NO_PROLOGUE, want_sums, g)


def _launch_wgrad_sm90(src, dp, *, pro=None):
    """B on wgmma at :func:`wgrad_grid`'s grid, with the arguments of
    :func:`_launch_wgrad` (one source): [9 * C * F] fp32."""
    lib = library(src.device)
    b, h, wd, c = src.shape
    g = wgrad_grid(b, h, wd, c, dp.shape[3], lib.pair_wgrad_tile,
                   sm_count(src.device))
    return _sm90_wgrad(src, None, dp, pro or _NO_PROLOGUE, g)


def _launch_dgrad_pair_sm90(dp, wf, dxa, dxb):
    """K9 on wgmma at :func:`dgrad_pair_grid`'s grid into ``dxa`` and
    ``dxb`` (``_sm90_conv`` with a split output)."""
    lib = library(dp.device)
    b, h, wd, f = dp.shape
    g = dgrad_pair_grid(b, h, wd, f, dxa.shape[3], dxb.shape[3],
                        lib.conv_sm90_tiles, sm_count(dp.device))
    _sm90_conv(dp, None, wf, None, dxa, _NO_PROLOGUE, False, g, y2=dxb)


def _launch_dgrad_reduce_sm90(dp, wf, dd, reduce, out_drop=None):
    """K11 on wgmma at :func:`conv_grid`'s grid into ``dd`` (``_sm90_conv``
    with the mask and reduce epilogue): returns the [2, C] sums."""
    lib = library(dp.device)
    b, h, wd, f = dp.shape
    g = conv_grid(b, h, wd, f, dd.shape[3], lib.conv_sm90_tiles,
                  sm_count(dp.device))
    return _sm90_conv(dp, None, wf, None, dd, _NO_PROLOGUE, True, g,
                      out_drop=out_drop, reduce=reduce)


def stem_grid(b: int, h: int, w: int, tile: tuple[int, int],
              sms: int) -> int:
    """K12's persistent grid: STEM_CTAS_PER_SM CTAs an SM, at most one a
    tile of ``tile`` pixels (the rows of its statistics partials)."""
    return min(conv_tiles(b, h, w, tile), sms * STEM_CTAS_PER_SM)


def _launch_stem(x, w, y, *, bias=None, want_sums=False):
    """K12's kernel (csrc/stem_sm90.cu ``hpfg_stem_sm90``) into ``y``:
    returns the [2, F] statistics when ``want_sums`` (summed by its last
    CTA), else None."""
    lib = library(x.device)
    b, h, wd, c = x.shape
    f = w.shape[3]
    ctas = stem_grid(b, h, wd, lib.stem_tiles[f], sm_count(x.device))
    buf = counter = None
    if want_sums:  # the CTAs' partial rows, then the statistics
        buf = torch.empty((ctas + 1) * 2 * f, dtype=torch.float32,
                          device=x.device)
        counter = ticket(x.device, "stem")
    stats = None if buf is None else buf[ctas * 2 * f:]
    lib.call("hpfg_stem_sm90", ptr(x), ptr(w), ptr(bias), ptr(y), ptr(buf),
             ptr(stats), ptr(counter), b, h, wd, c, f, ctas, stream(x))
    return None if stats is None else stats.view(2, f)


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
    lib.call("hpfg_conv3x3_nhwc", ptr(x), ptr(x2), c1, ptr(w), ptr(bias),
             *(pro or _NO_PROLOGUE), *_mask_args(out_drop),
             *_reduce_args(reduce), ptr(y), ptr(y2), y.shape[-1], ptr(part),
             b, h, wd, c, f, int(x.dtype == torch.bfloat16), stream(x))
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
    result when ``want_stats``, else None). On the card the call takes
    :func:`conv_route`'s kernel and counts it in ``routes[route]``."""
    _check_act("x", x)
    b, h, wd, c = x.shape
    f = _check_weight(w, x, c)
    _check_vec("bias", bias, f, x.device)
    pro = _prologue_args(affine, drop, c, b, x.device)
    _check_ids(out_drop, b, x.device)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, bias, affine, drop, out_drop,
                                 want_stats)
    y = torch.empty((b, h, wd, f), dtype=x.dtype, device=x.device)
    form = ("out_drop" if out_drop is not None else
            "prologue" if affine is not None else "conv")
    route = conv_route(c, f, x.dtype, _aligned(x, w, *(affine or ())),
                       form, width=wd)
    if route == "stem":
        stats = _launch_stem(x, w, y, bias=bias, want_sums=want_stats)
    elif route == "wgmma":
        stats = _launch_conv_sm90(x, w, y, bias=bias, pro=pro,
                                  want_sums=want_stats)
    else:
        stats = _launch_conv(x, w, y, bias=bias, pro=pro, out_drop=out_drop,
                             want_sums=want_stats)
    counted(conv3x3_nhwc.routes[route], x)
    counted(conv3x3_nhwc, x, 18 * b * h * wd * c * f)
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
    route = pair_route(ca, xb.shape[-1], f, xa.dtype, _aligned(xa, xb, w))
    if route == "wgmma":
        stats = _launch_pair_conv(xa, xb, w, bias, y, want_stats)
    else:
        stats = _launch_conv(xa, w, y, x2=xb, bias=bias, want_sums=want_stats)
    counted(conv3x3_pair_nhwc.routes[route], xa)
    counted(conv3x3_pair_nhwc, xa, 18 * b * h * wd * w.shape[2] * f)
    return y, stats


@launch_counter
def conv3x3_dgrad_pair(dp, wf, ca: int):
    """K9: the pair conv's input gradients from ``dp`` [B,H,W,F] and the
    flip-transposed weights ``wf`` [3,3,F,Ca+Cb], in one pass: returns
    (dx_skip [B,H,W,Ca], dx_up [B,H,W,Cb]), each contiguous. On the card
    the call takes :func:`conv_route`'s kernel (form "dgrad_pair") and
    counts it in ``routes[route]``."""
    _check_act("dp", dp)
    b, h, wd, f = dp.shape
    c = _check_weight(wf, dp, f)
    if not 0 < ca < c:
        raise ValueError(f"split {ca} outside (0, {c})")
    if dp.device.type == "cpu":
        return conv3x3_dgrad_pair_reference(dp, wf, ca)
    dxa = torch.empty((b, h, wd, ca), dtype=dp.dtype, device=dp.device)
    dxb = torch.empty((b, h, wd, c - ca), dtype=dp.dtype, device=dp.device)
    route = conv_route(f, c, dp.dtype, _aligned(dp, wf), "dgrad_pair", ca)
    if route == "wgmma":
        _launch_dgrad_pair_sm90(dp, wf, dxa, dxb)
    else:
        _launch_conv(dp, wf, dxa, y2=dxb)
    counted(conv3x3_dgrad_pair.routes[route], dp)
    counted(conv3x3_dgrad_pair, dp, 18 * b * h * wd * c * f)
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
    ``bn_act_dpre`` finishes that stage's backward from them. On the card
    the call takes :func:`conv_route`'s kernel (form "dgrad_reduce") and
    counts it in ``routes[route]``."""
    _check_act("dp", dp)
    bb, h, wd, f = dp.shape
    c = _check_weight(wf, dp, f)
    _check_like("pre", pre, dp)
    if pre.shape[-1] != c:
        raise ValueError(f"pre: expected {c} channels, got {pre.shape[-1]}")
    for name, v in (("a", a), ("b", b), ("mean", mean), ("inv", inv)):
        _check_vec(name, v, c, dp.device)
    _check_ids(out_drop, bb, dp.device)
    if dp.device.type == "cpu":
        return conv3x3_dgrad_reduce_reference(dp, wf, pre, a, b, mean, inv,
                                              out_drop)
    dd = torch.empty((bb, h, wd, c), dtype=dp.dtype, device=dp.device)
    red = (pre, a, b, mean, inv)
    route = conv_route(f, c, dp.dtype, _aligned(dp, wf, *red),
                       "dgrad_reduce")
    if route == "wgmma":
        sums = _launch_dgrad_reduce_sm90(dp, wf, dd, red, out_drop)
    else:
        sums = _launch_conv(dp, wf, dd, out_drop=out_drop, reduce=red,
                            want_sums=True)
    counted(conv3x3_dgrad_reduce.routes[route], dp)
    counted(conv3x3_dgrad_reduce, dp, 18 * bb * h * wd * c * f)
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
             *(pro or _NO_PROLOGUE), ptr(part), b, h, wd, c, f,
             per_block, int(bf16), stream(src))
    return colsum(part)


@launch_counter
def conv3x3_wgrad_nhwc(src, dp, affine=None, drop=None):
    """Kernel B: weight gradient dW [3,3,C,F] fp32 of a SAME 3x3 conv whose
    operand was ``src`` [B,H,W,C] (identity, or recomputed through the
    ``affine``/``drop`` prologue as in kernel A) and whose output cotangent
    is ``dp`` [B,H,W,F] (same dtype). Per-block partials over spatial tiles,
    then a fixed-order column sum. On the card the call takes
    :func:`conv_route`'s kernel and counts it in ``routes[route]``."""
    _check_act("src", src)
    _check_like("dp", dp, src)
    b, h, w, c = src.shape
    f = dp.shape[3]
    pro = _prologue_args(affine, drop, c, b, src.device)
    if src.device.type == "cpu":
        return conv3x3_wgrad_reference(src, dp, affine, drop)
    form = "wgrad_prologue" if affine is not None else "wgrad"
    route = conv_route(c, f, src.dtype, _aligned(src, dp, *(affine or ())),
                       form)
    launch = _launch_wgrad_sm90 if route == "wgmma" else _launch_wgrad
    dw = launch(src, dp, pro=pro).view(3, 3, c, f)
    counted(conv3x3_wgrad_nhwc.routes[route], src)
    counted(conv3x3_wgrad_nhwc, src, 18 * b * h * w * c * f)
    return dw


@launch_counter
def conv3x3_wgrad_pair(xa, xb, dp):
    """K10: the pair conv's weight gradients (identity operands) in one
    launch: returns (dW_skip [3,3,Ca,F], dW_up [3,3,Cb,F]) fp32. On the
    card the call takes :func:`pair_route`'s kernel and counts it in
    ``routes[route]``."""
    _check_act("xa", xa)
    _check_like("xb", xb, xa)
    _check_like("dp", dp, xa)
    b, h, w, ca = xa.shape
    cb, f = xb.shape[3], dp.shape[3]
    if xa.device.type == "cpu":
        return conv3x3_wgrad_pair_reference(xa, xb, dp)
    route = pair_route(ca, cb, f, xa.dtype, _aligned(xa, xb, dp))
    if route == "wgmma":
        dw = _launch_pair_wgrad(xa, xb, dp)
    else:
        dw = _launch_wgrad(xa, dp, src2=xb)
    counted(conv3x3_wgrad_pair.routes[route], xa)
    counted(conv3x3_wgrad_pair, xa, 18 * b * h * w * (ca + cb) * f)
    return (dw[:9 * ca * f].view(3, 3, ca, f),
            dw[9 * ca * f:].view(3, 3, cb, f))


for _fn in (conv3x3_nhwc, conv3x3_wgrad_nhwc, conv3x3_pair_nhwc,
            conv3x3_wgrad_pair, conv3x3_dgrad_pair, conv3x3_dgrad_reduce):
    # each route's own launch count, beside the wrapper's total
    _fn.routes = {r: SimpleNamespace(launches=0) for r in ROUTES}
conv3x3_nhwc.routes["stem"] = SimpleNamespace(launches=0)


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
                  run_stats, train: bool, drop, mesh=None):
    """ConvBlock forward on kernels A and C (conv_block.py ``_forward``).

    ``x`` NHWC in the compute dtype, or a pair (skip, up) of such tensors
    whose channel concat is conv1's input (kernel K8); weights and BN
    parameters fp32. ``run_stats`` (mean1, var1, mean2, var2) normalizes in
    eval mode; ``drop`` is a :class:`HashDropout` or None. Under a
    data-parallel ``mesh`` (``parallel.mesh.Mesh``) of W > 1 ranks, each
    conv's [sum, sum^2] is all-reduced before it becomes statistics of the
    global batch (W times this rank's pixels). Returns (y, stats,
    residuals): stats are the batch statistics in train mode (copies of
    ``run_stats`` in eval mode) and residuals (x, w1, w2 in the compute
    dtype, conv1 output h, conv2 output g) feed :func:`block_backward`."""
    pair = isinstance(x, (tuple, list))
    x0 = x[0] if pair else x
    dtype = x0.dtype
    w1c = w1.to(dtype).contiguous()
    w2c = w2.to(dtype).contiguous()
    n = x0.numel() // x0.shape[-1] * (1 if mesh is None else mesh.world)
    if pair:
        h, s1 = conv3x3_pair_nhwc(x[0], x[1], w1c, b1.float().contiguous(),
                                  want_stats=train)
    else:
        h, s1 = conv3x3_nhwc(x, w1c, b1.float().contiguous(),
                             want_stats=train)
    if train:
        mean1, var1 = finalize_stats(all_reduce_sum(s1, mesh), n)
    else:
        mean1, var1 = (t.clone() for t in run_stats[:2])
    a1, c1 = bn_affine(scale1, bias1, mean1, var1)
    g, s2 = conv3x3_nhwc(h, w2c, b2.float().contiguous(), affine=(a1, c1),
                         drop=drop, want_stats=train)
    if train:
        mean2, var2 = finalize_stats(all_reduce_sum(s2, mesh), n)
    else:
        mean2, var2 = (t.clone() for t in run_stats[2:])
    a2, c2 = bn_affine(scale2, bias2, mean2, var2)
    y = bn_act(g, a2, c2)
    return y, (mean1, var1, mean2, var2), (x, w1c, w2c, h, g)


def _global_sums(s: torch.Tensor, mesh) -> torch.Tensor:
    """BN-backward sums for ``bn_act_dpre`` under a data-parallel mesh: the
    all-reduced [S0, S1] over W, as dpre divides by this rank's pixel
    count and the global count is W times it."""
    return all_reduce_sum(s, mesh) / mesh.world


def block_backward(dy, residuals, scale1, bias1, scale2, bias2, stats, drop,
                   need_dx=True, need_dw=True, mesh=None):
    """Train-mode ConvBlock backward, in the order of conv_block.py ``_bwd``
    with its default folds: BN2 backward (D), conv2 dgrad times the forward
    dropout mask with BN1's backward reduce in its epilogue (K11), conv2
    wgrad recomputing lrelu(BN1(h))*mask (B), BN1's elementwise backward
    (D, dpre only), conv1 dgrad (A; K9 for a pair) and wgrad (B; K10 for a
    pair). ``need_dx``: whether conv1's input needs a gradient (a pair of
    flags for a pair input); ``need_dw``: whether the weights do (False
    launches no B and no K10, as XLA drops an unused ``_wgrad``). Returns
    (dx, dw1, dscale1, dbias1, dw2, dscale2, dbias2); dx is None where no
    gradient is needed, and a pair (dx_skip, dx_up) for a pair input; dw1
    and dw2 are None without ``need_dw``.

    Under a data-parallel ``mesh`` of W > 1 ranks, BN2's backward runs as
    D's reduce, an all-reduce of its sums and dpre, and K11's sums are
    all-reduced before BN1's dpre: the elementwise passes see the global
    batch's sums. The returned dscale / dbias stay this rank's own
    partials; the step's gradient all-reduce sums them over the ranks."""
    x, w1c, w2c, h, g = residuals
    mean1, var1, mean2, var2 = stats
    dy = dy.to(h.dtype).contiguous()
    multi = spans_ranks(mesh)

    a2, c2 = bn_affine(scale2, bias2, mean2, var2)
    inv2 = (1.0 / torch.sqrt(var2 + BN_EPS)).float().contiguous()
    m2 = mean2.float().contiguous()
    if multi:
        s2 = bn_reduce(dy, g, a2, c2, m2, inv2)
        dg = bn_act_dpre(dy, g, a2, c2, m2, inv2, _global_sums(s2, mesh))
    else:
        s2, dg = bn_act_bwd(dy, g, a2, c2, m2, inv2)
    a1, c1 = bn_affine(scale1, bias1, mean1, var1)
    inv1 = (1.0 / torch.sqrt(var1 + BN_EPS)).float().contiguous()
    m1 = mean1.float().contiguous()
    dd, s1 = conv3x3_dgrad_reduce(dg, flip_transpose(w2c), h, a1, c1, m1,
                                  inv1, out_drop=drop)
    dw1 = dw2 = None
    if need_dw:
        dw2 = conv3x3_wgrad_nhwc(h, dg, affine=(a1, c1), drop=drop)

    dh = bn_act_dpre(dd, h, a1, c1, m1, inv1,
                     _global_sums(s1, mesh) if multi else s1)
    if isinstance(x, (tuple, list)):
        need = (need_dx, need_dx) if isinstance(need_dx, bool) else need_dx
        dx = None
        if any(need):
            dx = conv3x3_dgrad_pair(dh, flip_transpose(w1c), x[0].shape[-1])
            dx = tuple(d if nd else None for d, nd in zip(dx, need))
        if need_dw:
            dw1 = torch.cat(conv3x3_wgrad_pair(x[0], x[1], dh), dim=2)
    else:
        dx = conv3x3_nhwc(dh, flip_transpose(w1c))[0] if need_dx else None
        if need_dw:
            dw1 = conv3x3_wgrad_nhwc(x, dh)
    return dx, dw1, s1[1], s1[0], dw2, s2[1], s2[0]


class FusedConvBlock(torch.autograd.Function):
    """The fused ConvBlock (conv_block.py ``fused_conv_block``).

    apply(x, w1, b1, scale1, bias1, w2, b2, scale2, bias2, run_stats, train,
    drop, x2=None, mesh=None) -> (y, mean1, var1, mean2, var2); see
    :func:`block_forward`. With ``x2`` the input is the pair (x, x2): skip
    and upsampled halves of an UpBlock, each with its own gradient;
    ``mesh``: the data-parallel mesh whose global batch the BN statistics
    span (None: this process's batch). No
    gradient flows through the returned statistics; the backward is train
    mode only, and the conv-bias gradients are exactly zero (the biases feed
    BN, whose batch mean absorbs them). Where neither conv weight needs a
    gradient (frozen weights: VAT's inner gradient), the backward launches
    no weight-gradient kernel, and every input that needs no gradient gets
    None."""

    @staticmethod
    def forward(ctx, x, w1, b1, scale1, bias1, w2, b2, scale2, bias2,
                run_stats, train, drop, x2=None, mesh=None):
        inp = x if x2 is None else (x, x2)
        y, stats, residuals = block_forward(inp, w1, b1, scale1, bias1, w2,
                                            b2, scale2, bias2, run_stats,
                                            train, drop, mesh)
        ctx.train, ctx.drop, ctx.mesh = train, drop, mesh
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
            dy, residuals, *saved[4:8], saved[8:], ctx.drop, need_dx=need_dx,
            need_dw=needs[1] or needs[5], mesh=ctx.mesh)
        dx, dx2 = dx if pair and dx is not None else (dx, None)
        zero = torch.zeros_like(dbias1)
        grads = (dx, dw1, zero, dscale1, dbias1, dw2, zero.clone(), dscale2,
                 dbias2, None, None, None, dx2, None)
        return tuple(g if need else None
                     for g, need in zip(grads, needs))


class Conv3x3Plain(torch.autograd.Function):
    """SAME 3x3 conv + bias (conv_block.py ``fused_conv3x3_plain``): kernel
    A forward; backward is kernel A on the flipped weights (dx), kernel B
    (dW) and db = sum(dy), each only where its input needs a gradient."""

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
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = dw = db = None
        if need_x:
            dx, _ = conv3x3_nhwc(dy, flip_transpose(wc))
        if need_w:
            dw = conv3x3_wgrad_nhwc(x, dy)
        if need_b:
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
