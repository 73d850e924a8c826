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
"""

from __future__ import annotations

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

BN_MOMENTUM = 0.9


def _uniform(shape, bound: float, generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class Conv(nn.Module):
    """Conv parameters: ``kernel`` [k, k, C, F] and ``bias`` [F] (none when
    ``use_bias`` is False), with torch's default init U(+-1/sqrt(fan_in))
    for both (the JAX package's TORCH_KERNEL_INIT / torch_bias_init)."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3,
                 generator: torch.Generator | None = None,
                 use_bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(k * k * in_ch)
        self.kernel = nn.Parameter(_uniform((k, k, in_ch, out_ch), bound,
                                            generator))
        self.bias = (nn.Parameter(_uniform((out_ch,), bound, generator))
                     if use_bias else None)


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

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """fp32 BN over every axis but the last. In train mode it normalizes
        with the batch mean and biased variance (flax's fast variance
        E[x^2] - E[x]^2, clamped at 0) and folds those; in eval mode it
        uses the running statistics."""
        x = x.float()
        if train:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
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
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``x``: NHWC, or a pair (skip, up) whose channel concat is conv1's
        input (the UpBlock); the concat is never materialised."""
        drop = None
        if train and self.dropout_p > 0.0:
            seed = int(torch.randint(0, 1 << 23, (), generator=generator))
            drop = HashDropout(seed, 1.0 - self.dropout_p)
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
            self.bn2.bias, run_stats, train, drop, x2)
        if train:
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
                                  out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True on NHWC."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    return _nhwc(F.interpolate(_nchw(x), size=tuple(out_hw), mode="bilinear",
                               align_corners=True))


class DownBlock(nn.Module):
    """2x2 max-pool then ConvBlock (flax DownBlock)."""

    def __init__(self, in_ch: int, features: int, dropout_p: float,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = ConvBlock(in_ch, features, dropout_p, dtype, generator)

    def forward(self, x, train: bool, generator=None):
        return self.conv(max_pool_2x2(x), train, generator)


class UpBlock(nn.Module):
    """1x1 conv, bilinear x2 upsample (align_corners), then the ConvBlock
    over (skip, up) (flax UpBlock). The pair goes to the ConvBlock as two
    tensors: its conv1 reads their channel concat in place (K8) and its
    backward returns a gradient for each (K9, K10). The 1x1 conv runs as a
    3x3 conv whose only nonzero tap is the centre, so SAME semantics are
    exact and its weight gradient is the centre tap's."""

    def __init__(self, in_ch: int, skip_ch: int, skip_features: int,
                 features: int, dropout_p: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv1x1 = Conv(in_ch, skip_features, 1, generator)
        self.conv = ConvBlock(skip_ch + skip_features, features, dropout_p,
                              dtype, generator)

    def forward(self, x, skip, train: bool, generator=None):
        w3 = F.pad(self.conv1x1.kernel, (0, 0, 0, 0, 1, 1, 1, 1))
        x = conv3x3_plain(x.to(self.dtype), w3, self.conv1x1.bias)
        x = resize_bilinear_align_corners(x, tuple(skip.shape[1:3]))
        return self.conv((skip, x), train, generator)


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
    or with ``std`` the truncated normal of :func:`trunc_normal` for the
    kernel and a zero bias (the SwinUNet's ``_DENSE_INIT``)."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: torch.Generator | None = None,
                 use_bias: bool = True, std: float | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        if std is None:
            kernel = _uniform((in_dim, out_dim), bound, generator)
        else:
            kernel = trunc_normal((in_dim, out_dim), std, generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(
                _uniform((out_dim,), bound, generator) if std is None
                else torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., in] -> [..., out] in x's dtype (torch.matmul)."""
        y = torch.matmul(x, self.kernel.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


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


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``nn.Dropout(rate)``: in train mode each element is kept with
    probability 1 - rate and scaled by 1/(1 - rate), else zeroed."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = device_uniform(x.shape, generator, x.device)
    return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


class DropPath(nn.Module):
    """Stochastic depth per sample (flax ``DropPath``): in train mode each
    sample's branch is kept with probability 1 - rate and scaled by
    1/(1 - rate), else zeroed; one Bernoulli draw per sample."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, train: bool,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.rate == 0.0 or not train:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        u = device_uniform(shape, generator, x.device)
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
