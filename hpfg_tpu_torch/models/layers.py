"""UNet building blocks (port of ``hpfg_tpu/models/layers.py``), NHWC.

Module and parameter names follow the flax modules exactly (``conv1``,
``bn1``, ``kernel``, ``scale``, ``mean``, ...), so a flax parameter path
``encoder/in_conv/conv1/kernel`` is the state-dict key
``encoder.in_conv.conv1.kernel`` here (``utils/jax_weights.py``). Conv
kernels are HWIO ``[kh, kw, C, F]``; parameters and BN statistics are fp32;
activations run in the module's compute dtype.

Every convolution of the UNet runs through the hand-written kernels
(``ops/conv_block.py``): ConvBlocks through ``FusedConvBlock`` (the UpBlock's
with its (skip, up) pair), the 1x1 and logits convs through
``conv3x3_plain``. The projection necks of UNet_Plus are plain torch
matmuls on at most [B, 4, 4, C]. The UNet's BatchNorm statistics come out
of the conv kernel's epilogue; ``BatchNorm`` holds its state, and its
running averages fold the biased batch variance with momentum 0.9, as flax
does (``nn.BatchNorm2d`` would fold the unbiased one).

Every train-mode forward takes ``fold`` (default True): False normalizes
with the batch statistics as usual but leaves the running statistics
alone, as the JAX package's ``apply(..., mutable=["batch_stats"])`` whose
updated statistics are thrown away (UAMT's Monte-Carlo passes, SS-Net's
VAT passes and heads). ``fold`` is threaded down the modules the way
``generator`` is.

So is ``rows`` (default None): under data parallelism over W > 1 ranks
(``parallel.mesh.Rows``) it says where the forward's local rows sit in the
global batch. The BatchNorm statistics are then the global batch's (their
sums all-reduced), the hash dropout hashes each image's global index, and
``dropout`` / ``DropPath`` draw for the global batch and keep this rank's
rows, so every image sees what it sees in one process.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from hpfg_tpu_torch.ops.conv_block import (
    BN_EPS,
    FusedConvBlock,
    HashDropout,
    conv3x3_plain,
)
from hpfg_tpu_torch.parallel.distributed import all_reduce_sum

BN_MOMENTUM = 0.9


def _uniform(shape, bound: float, generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class Conv(nn.Module):
    """Conv parameters: ``kernel`` [k, k, C, F] and ``bias`` [F] (none when
    ``use_bias`` is False). ``init="torch"``: torch's default init
    U(+-1/sqrt(fan_in)) for both (the JAX package's TORCH_KERNEL_INIT /
    torch_bias_init); ``init="lecun"``: flax's default, :func:`lecun_normal`
    kernel and zero bias. fan_in is k*k*C; a depthwise conv is
    ``Conv(1, F, k)``, kernel [k, k, 1, F] with fan_in k*k, as flax lays out
    ``feature_group_count=F``."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3,
                 generator: torch.Generator | None = None,
                 use_bias: bool = True, init: str = "torch"):
        super().__init__()
        shape, fan_in = (k, k, in_ch, out_ch), k * k * in_ch
        self.kernel = nn.Parameter(_init_kernel(shape, fan_in, init,
                                                generator))
        self.bias = (nn.Parameter(_init_bias(out_ch, fan_in, init, generator))
                     if use_bias else None)


def lecun_normal(shape, fan_in: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's default kernel init ``lecun_normal``: variance_scaling(1,
    fan_in, truncated_normal), a standard normal truncated to [-2, 2] times
    sqrt(1/fan_in) / 0.8796 (the truncated normal's std), so that the draw's
    std is sqrt(1/fan_in). :func:`trunc_normal` does not rescale."""
    return trunc_normal(shape, math.sqrt(1.0 / fan_in) / _TRUNC_STD,
                        generator)


def _init_kernel(shape, fan_in: int, init: str, generator) -> torch.Tensor:
    if init == "lecun":
        return lecun_normal(shape, fan_in, generator)
    if init != "torch":
        raise ValueError(f"unknown init {init!r}")
    return _uniform(shape, 1.0 / math.sqrt(fan_in), generator)


def _init_bias(n: int, fan_in: int, init: str, generator) -> torch.Tensor:
    if init == "lecun":
        return torch.zeros(n)
    return _uniform((n,), 1.0 / math.sqrt(fan_in), generator)


def conv_nhwc(x: torch.Tensor, conv: Conv, stride: int = 1,
              padding: tuple[int, int, int, int] = (0, 0, 0, 0),
              groups: int = 1, dilation: int = 1) -> torch.Tensor:
    """``F.conv2d`` of NHWC ``x`` with the HWIO ``conv.kernel`` in x's dtype:
    x is read as channels-last NCHW and the result is NHWC. ``padding`` is
    (top, bottom, left, right); symmetric padding goes to the conv, an
    asymmetric one to ``F.pad`` first."""
    w = conv.kernel.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    top, bottom, left, right = padding
    if top == bottom and left == right:
        pad = (top, left)
    else:
        xc, pad = F.pad(xc, (left, right, top, bottom)), (0, 0)
    y = F.conv2d(xc, w, b, stride=stride, padding=pad, dilation=dilation,
                 groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``'SAME'`` padding of one axis: ceil(n / s) outputs, the
    total padding split with the extra element at the end."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, conv: Conv, stride: int = 1,
              groups: int = 1, dilation: int = 1) -> torch.Tensor:
    """:func:`conv_nhwc` with flax's default ``'SAME'`` padding (a dilated
    kernel spans dilation*(k-1)+1)."""
    k = dilation * (conv.kernel.shape[0] - 1) + 1
    pad = (same_padding(x.shape[1], k, stride)
           + same_padding(x.shape[2], k, stride))
    return conv_nhwc(x, conv, stride, pad, groups, dilation)


class BatchNorm(nn.Module):
    """BN state: ``scale``/``bias`` parameters and ``mean``/``var`` running
    statistics (flax ``params/bnX`` and ``batch_stats/bnX``). The UNet's
    statistics come from its conv kernels; ``forward`` is flax's BatchNorm
    (epsilon 1e-5) in fp32 for a plain tensor (the SegFormer head's)."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def forward(self, x: torch.Tensor, train: bool, fold: bool = True,
                rows=None) -> torch.Tensor:
        """fp32 BN over every axis but the last. In train mode it normalizes
        with the batch mean and biased variance (flax's fast variance
        E[x^2] - E[x]^2, clamped at 0) and folds those unless ``fold`` is
        False; in eval mode it uses the running statistics. With ``rows``
        the batch is the global one: [sum, sum^2] all-reduced over the
        ranks, divided by the global count."""
        x = x.float()
        if train:
            dims = tuple(range(x.dim() - 1))
            if rows is None:
                mean = x.mean(dims)
                sq = (x * x).mean(dims)
            else:
                n = x.numel() // x.shape[-1] * rows.mesh.world
                mean, sq = all_reduce_sum(
                    torch.stack([x.sum(dims), (x * x).sum(dims)]),
                    rows.mesh) / n
            var = torch.clamp(sq - mean * mean, min=0.0)
            if fold:
                self.fold(mean, var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.scale) \
            + self.bias

    @torch.no_grad()
    def fold(self, batch_mean: torch.Tensor, batch_var: torch.Tensor) -> None:
        """Running update, in place: new = 0.9*old + 0.1*batch (biased)."""
        self.mean.mul_(BN_MOMENTUM).add_(batch_mean, alpha=1 - BN_MOMENTUM)
        self.var.mul_(BN_MOMENTUM).add_(batch_var, alpha=1 - BN_MOMENTUM)


class ConvBlock(nn.Module):
    """conv3x3-BN-LeakyReLU-dropout-conv3x3-BN-LeakyReLU (flax ConvBlock),
    one ``FusedConvBlock``. Dropout is the in-kernel hash dropout; its seed
    is drawn from ``generator`` once per train-mode forward."""

    def __init__(self, in_ch: int, features: int, dropout_p: float,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dropout_p = float(dropout_p)
        self.dtype = dtype
        self.conv1 = Conv(in_ch, features, 3, generator)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3, generator)
        self.bn2 = BatchNorm(features)

    def forward(self, x, train: bool,
                generator: torch.Generator | None = None,
                fold: bool = True, rows=None) -> torch.Tensor:
        """``x``: NHWC, or a pair (skip, up) whose channel concat is conv1's
        input (the UpBlock); the concat is never materialised. ``fold``:
        whether a train-mode forward folds its batch statistics into
        ``bn1`` / ``bn2``; ``rows``: the global batch of a data-parallel
        forward (its image ids go to the dropout, its mesh to the block)."""
        drop = None
        if train and self.dropout_p > 0.0:
            seed = int(torch.randint(0, 1 << 23, (), generator=generator))
            drop = HashDropout(seed, 1.0 - self.dropout_p)
            if rows is not None:
                drop = dataclasses.replace(drop, image_ids=rows.ids)
        run_stats = None
        if not train:
            run_stats = (self.bn1.mean, self.bn1.var, self.bn2.mean,
                         self.bn2.var)
        x, x2 = x if isinstance(x, tuple) else (x, None)
        if x2 is not None:
            x2 = x2.to(self.dtype).contiguous()
        y, m1, v1, m2, v2 = FusedConvBlock.apply(
            x.to(self.dtype).contiguous(), self.conv1.kernel,
            self.conv1.bias, self.bn1.scale, self.bn1.bias,
            self.conv2.kernel, self.conv2.bias, self.bn2.scale,
            self.bn2.bias, run_stats, train, drop, x2,
            None if rows is None else rows.mesh)
        if train and fold:
            self.bn1.fold(m1, v1)
            self.bn2.fold(m2, v2)
        return y


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool on NHWC (floor for odd sizes). On exact ties
    torch routes the gradient to one element where the JAX pairwise max
    splits it; ties have measure zero for continuous activations."""
    return _nhwc(F.max_pool2d(_nchw(x), 2, 2))


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: tuple[int, int],
                                  deterministic: bool = False
                                  ) -> torch.Tensor:
    """Bilinear resize with align_corners=True on NHWC. ``deterministic``:
    the backward is two fp32 matmuls with the resize's weight matrices
    instead of torch's, whose CUDA kernel scatters with atomic adds (its
    result then varies in the last bits from run to run)."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    if deterministic:
        return _ResizeDeterministic.apply(x, tuple(out_hw))
    return _nhwc(F.interpolate(_nchw(x), size=tuple(out_hw), mode="bilinear",
                               align_corners=True))


def resize_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_out, n_in] fp32 weights of the 1-D align-corners linear resize,
    computed on ``device`` as torch's kernels compute them: source
    coordinate o*(n_in-1)/(n_out-1) in fp32, its floor and the next index
    (clamped) weighted 1 - frac and frac."""
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    src = torch.arange(n_out, dtype=torch.float32, device=device) * scale
    i0 = src.long()
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    frac = (src - i0.float())[:, None]
    cols = torch.arange(n_in, device=device)[None, :]
    return ((cols == i0[:, None]) * (1.0 - frac)
            + (cols == i1[:, None]) * frac)


class _ResizeDeterministic(torch.autograd.Function):
    """torch's align-corners bilinear resize forward; the backward
    dx = A_h^T dy A_w from :func:`resize_matrix`, in fp32."""

    @staticmethod
    def forward(ctx, x, out_hw):
        ctx.in_hw = tuple(x.shape[1:3])
        return _nhwc(F.interpolate(_nchw(x), size=out_hw, mode="bilinear",
                                   align_corners=True))

    @staticmethod
    def backward(ctx, dy):
        b, ho, wo, c = dy.shape
        hi, wi = ctx.in_hw
        ah = resize_matrix(hi, ho, dy.device)
        aw = resize_matrix(wi, wo, dy.device)
        g = torch.matmul(ah.t(), dy.float().reshape(b, ho, wo * c))
        g = torch.matmul(aw.t(), g.reshape(b * hi, wo, c))
        return g.reshape(b, hi, wi, c).to(dy.dtype), None


class DownBlock(nn.Module):
    """2x2 max-pool then ConvBlock (flax DownBlock)."""

    def __init__(self, in_ch: int, features: int, dropout_p: float,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = ConvBlock(in_ch, features, dropout_p, dtype, generator)

    def forward(self, x, train: bool, generator=None, fold: bool = True,
                rows=None):
        return self.conv(max_pool_2x2(x), train, generator, fold, rows)


class UpBlock(nn.Module):
    """1x1 conv, bilinear x2 upsample (align_corners), then the ConvBlock
    over (skip, up) (flax UpBlock). The pair goes to the ConvBlock as two
    tensors: its conv1 reads their channel concat in place (K8) and its
    backward returns a gradient for each (K9, K10). The 1x1 conv runs as a
    3x3 conv whose only nonzero tap is the centre, so SAME semantics are
    exact and its weight gradient is the centre tap's.
    ``deterministic_resize``: the upsample's backward is
    :func:`resize_bilinear_align_corners`' deterministic one (SS-Net, whose
    loss differentiates through the decoder)."""

    def __init__(self, in_ch: int, skip_ch: int, skip_features: int,
                 features: int, dropout_p: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 deterministic_resize: bool = False):
        super().__init__()
        self.dtype = dtype
        self.deterministic_resize = deterministic_resize
        self.conv1x1 = Conv(in_ch, skip_features, 1, generator)
        self.conv = ConvBlock(skip_ch + skip_features, features, dropout_p,
                              dtype, generator)

    def forward(self, x, skip, train: bool, generator=None,
                fold: bool = True, rows=None):
        w3 = F.pad(self.conv1x1.kernel, (0, 0, 0, 0, 1, 1, 1, 1))
        x = conv3x3_plain(x.to(self.dtype), w3, self.conv1x1.bias)
        x = resize_bilinear_align_corners(x, tuple(skip.shape[1:3]),
                                          self.deterministic_resize)
        return self.conv((skip, x), train, generator, fold, rows)


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """torch-style adaptive average pooling on NHWC (windows
    [floor(i*in/out), ceil((i+1)*in/out)), as the JAX package's separable
    averaging matmuls), in x's dtype. One kernel on the NCHW view; the JAX
    form's pooling matrices would be copied from the host at every call,
    and each such copy waits for the device to drain."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x), tuple(out_hw)))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, C], accumulated in fp32, returned in x's dtype."""
    return x.float().mean((1, 2)).to(x.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` [in, out] and ``bias`` [out] (none when
    ``use_bias`` is False). Init: torch's default U(+-1/sqrt(in)) for both,
    with ``std`` the truncated normal of :func:`trunc_normal` for the
    kernel and a zero bias (the SwinUNet's ``_DENSE_INIT``), or with
    ``init="lecun"`` flax's default (:func:`lecun_normal`, zero bias)."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: torch.Generator | None = None,
                 use_bias: bool = True, std: float | None = None,
                 init: str = "torch"):
        super().__init__()
        if std is None:
            kernel = _init_kernel((in_dim, out_dim), in_dim, init, generator)
        else:
            kernel, init = trunc_normal((in_dim, out_dim), std, generator), \
                "lecun"  # zero bias
        self.kernel = nn.Parameter(kernel)
        self.bias = (nn.Parameter(_init_bias(out_dim, in_dim, init, generator))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., in] -> [..., out] in x's dtype (torch.matmul)."""
        y = torch.matmul(x, self.kernel.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


#: the std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def trunc_normal(shape, std: float,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``truncated_normal(stddev=std, lower=-2, upper=2)``
    (``trunc_normal_init``): a standard normal truncated to [-2, 2], drawn
    by inverting its CDF, times ``std``. The values lie in [-2 std, 2 std]
    and their std is 0.8796 std: JAX does not rescale by the truncation's
    std, and ``torch.nn.init.trunc_normal_`` truncates at +-2 absolute, not
    at +-2 std."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = torch.erfinv(lo + (hi - lo) * u) * math.sqrt(2.0)
    return (z.clamp(-2.0, 2.0) * std).float()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, bias: torch.Tensor | None = None
              ) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v over the last two axes, as the flax
    modules compute it (einsums with ``preferred_element_type=float32``):
    the logits, ``bias`` and the softmax in fp32, the probabilities cast to
    q's dtype, P.V summed in fp32 and cast to q's dtype. Plain matmuls,
    never ``F.scaled_dot_product_attention``."""
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        attn = attn + bias
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    return torch.matmul(attn.float(), v.float()).to(q.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-6, dtype=float32)``: ``scale`` and
    ``bias`` [C]; statistics and result in fp32 whatever x's dtype, with
    flax's fast variance E[x^2] - E[x]^2 clamped at 0."""

    def __init__(self, ch: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


def device_uniform(shape, generator: torch.Generator | None,
                   device) -> torch.Tensor:
    """U[0, 1) draws made on ``device`` from a seed that ``generator``
    draws on the host: the draw needs no host-to-device copy (a copy from
    pageable memory would drain the card's queue)."""
    seed = int(torch.randint(0, 1 << 62, (), generator=generator))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device)


def _draw(shape, generator, device, rows) -> torch.Tensor:
    """:func:`device_uniform` of ``shape``, or with ``rows`` this rank's
    rows of the draw for the global batch (the same seed on every rank)."""
    if rows is None:
        return device_uniform(shape, generator, device)
    return rows.take(device_uniform((rows.total,) + tuple(shape[1:]),
                                    generator, device))


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | None = None,
            rows=None) -> torch.Tensor:
    """flax ``nn.Dropout(rate)``: in train mode each element is kept with
    probability 1 - rate and scaled by 1/(1 - rate), else zeroed. With
    ``rows`` the draw is the global batch's, at this rank's rows."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = _draw(x.shape, generator, x.device, rows)
    return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


class DropPath(nn.Module):
    """Stochastic depth per sample (flax ``DropPath``): in train mode each
    sample's branch is kept with probability 1 - rate and scaled by
    1/(1 - rate), else zeroed; one Bernoulli draw per sample."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, train: bool,
                generator: torch.Generator | None = None,
                rows=None) -> torch.Tensor:
        if self.rate == 0.0 or not train:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        u = _draw(shape, generator, x.device, rows)
        return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


class ProjectionNeck(nn.Module):
    """DenseCL projection neck (flax ProjectionNeck). Returns (global
    [B, out_dim], dense [B, s*s, out_dim]): GAP -> Dense-ReLU-Dense, and
    adaptive-avg-pool to (s, s) -> 1x1 conv-ReLU-1x1 conv, spatial-major.
    Plain torch (matmuls on at most [B, 4, 4, C]), as the JAX package
    leaves the neck to XLA; the 1x1 convs are ``Conv`` parameters
    [1, 1, in, out] applied as matmuls."""

    def __init__(self, in_ch: int, hid_dim: int = 2048, out_dim: int = 128,
                 s: int = 4, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.s, self.out_dim, self.dtype = s, out_dim, dtype
        self.mlp1 = Dense(in_ch, hid_dim, generator)
        self.mlp2 = Dense(hid_dim, out_dim, generator)
        self.conv1 = Conv(in_ch, hid_dim, 1, generator)
        self.conv2 = Conv(hid_dim, out_dim, 1, generator)

    def forward(self, x: torch.Tensor):
        x = x.to(self.dtype)
        g = self.mlp2(torch.relu(self.mlp1(global_avg_pool(x))))
        d = adaptive_avg_pool(x, (self.s, self.s)) if self.s else x
        d = self._conv1x1(torch.relu(self._conv1x1(d, self.conv1)),
                          self.conv2)
        return g, d.reshape(d.shape[0], -1, self.out_dim)

    @staticmethod
    def _conv1x1(x: torch.Tensor, conv: Conv) -> torch.Tensor:
        return (torch.matmul(x, conv.kernel[0, 0].to(x.dtype))
                + conv.bias.to(x.dtype))
