"""ResUNet and ResUNet++ (port of ``hpfg_tpu/models/resunet.py``), NHWC.

ResUNet: filters 64/128/256/512; an input block (conv-BN-ReLU-conv plus a
conv skip), three pre-activation residual blocks at stride 2
(BN-ReLU-conv3x3/2, BN-ReLU-conv3x3, plus a 3x3/2 conv skip), and a decoder
of x2 align-corners upsamples concatenated before their skips, residual
blocks at stride 1, and a 1x1 head.

ResUNet++: a stem block and three squeeze-excitation residual blocks
(16/32/64/128), an ASPP bridge (256; dilations 6, 12, 18), decoder blocks
whose attention gate (BN-ReLU-conv of the skip, 2x2 max-pooled, plus
BN-ReLU-conv of the input, BN-ReLU-1x1 conv to one channel) scales the
input before the x2 upsample and the concat with the skip, then an ASPP
and a 1x1 head.

Every conv and Dense keeps flax's default init, as the JAX modules do:
``lecun_normal`` kernels (a truncated normal rescaled to std
sqrt(1/fan_in)) and zero biases (``init="lecun"``). The squeeze-excitation
Dense layers are ``Dense_0`` / ``Dense_1``, flax's automatic names. No
Pallas kernel serves these models in the JAX package: the convs are cuDNN
(``conv_nhwc``).
"""

from __future__ import annotations

import torch
from torch import nn

from hpfg_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    conv_nhwc,
    conv_same,
    global_avg_pool,
    max_pool_2x2,
    resize_bilinear_align_corners,
)


#: ResUNet's filters
FILTERS = (64, 128, 256, 512)


def _conv(in_ch: int, out_ch: int, k: int, generator) -> Conv:
    return Conv(in_ch, out_ch, k, generator, init="lecun")


def _bn_relu(bn: BatchNorm, x, train: bool, dtype) -> torch.Tensor:
    return torch.relu(bn(x, train)).to(dtype)


def _conv_strided(x, conv: Conv, stride: int) -> torch.Tensor:
    """A 3x3 conv padded 1 on each side (flax ``padding=1``)."""
    return conv_nhwc(x, conv, stride, (1, 1, 1, 1))


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear_align_corners(x, (2 * x.shape[1], 2 * x.shape[2]))


class ResidualConv(nn.Module):
    """BN-ReLU-conv3x3(stride)-BN-ReLU-conv3x3 plus a 3x3(stride) conv
    skip."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.bn1 = BatchNorm(in_ch)
        self.conv1 = _conv(in_ch, features, 3, generator)
        self.bn2 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3, generator)
        self.skip = _conv(in_ch, features, 3, generator)

    def forward(self, x, train: bool) -> torch.Tensor:
        y = _bn_relu(self.bn1, x, train, self.dtype)
        y = _conv_strided(y, self.conv1, self.stride)
        y = conv_same(_bn_relu(self.bn2, y, train, self.dtype), self.conv2)
        return y + _conv_strided(x, self.skip, self.stride)


class ResUNet(nn.Module):
    """NHWC image -> fp32 logits (flax ``ResUNet``)."""

    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        f = FILTERS
        self.input_conv1 = _conv(in_channels, f[0], 3, generator)
        self.input_bn = BatchNorm(f[0])
        self.input_conv2 = _conv(f[0], f[0], 3, generator)
        self.input_skip = _conv(in_channels, f[0], 3, generator)
        self.residual_conv_1 = ResidualConv(f[0], f[1], 2, dtype, generator)
        self.residual_conv_2 = ResidualConv(f[1], f[2], 2, dtype, generator)
        self.bridge = ResidualConv(f[2], f[3], 2, dtype, generator)
        self.up_residual_conv1 = ResidualConv(f[3] + f[2], f[2], 1, dtype,
                                              generator)
        self.up_residual_conv2 = ResidualConv(f[2] + f[1], f[1], 1, dtype,
                                              generator)
        self.up_residual_conv3 = ResidualConv(f[1] + f[0], f[0], 1, dtype,
                                              generator)
        self.output_layer = _conv(f[0], num_classes, 1, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.to(self.dtype)
        y = conv_same(x, self.input_conv1)
        y = conv_same(_bn_relu(self.input_bn, y, train, self.dtype),
                      self.input_conv2)
        x1 = y + conv_same(x, self.input_skip)
        x2 = self.residual_conv_1(x1, train)
        x3 = self.residual_conv_2(x2, train)
        y = self.bridge(x3, train)
        for skip, block in ((x3, self.up_residual_conv1),
                            (x2, self.up_residual_conv2),
                            (x1, self.up_residual_conv3)):
            y = block(torch.cat([_up2(y), skip], dim=-1), train)
        return conv_nhwc(y, self.output_layer).float()

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self(x, train=False)


class SqueezeExcitation(nn.Module):
    """x * sigmoid(Dense_1(relu(Dense_0(mean_hw(x))))), bias-free, ratio 8;
    the sigmoid in fp32."""

    def __init__(self, features: int, ratio: int = 8,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Dense_0 = Dense(features, features // ratio, generator,
                             use_bias=False, init="lecun")
        self.Dense_1 = Dense(features // ratio, features, generator,
                             use_bias=False, init="lecun")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.Dense_1(torch.relu(self.Dense_0(global_avg_pool(x))))
        return x * torch.sigmoid(s.float()).to(x.dtype)[:, None, None, :]


class StemBlock(nn.Module):
    """conv3x3(stride)-BN-ReLU-conv3x3 plus a 1x1(stride) conv-BN skip,
    then squeeze-excitation."""

    def __init__(self, in_ch: int, features: int, stride: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.c1_conv1 = _conv(in_ch, features, 3, generator)
        self.c1_bn = BatchNorm(features)
        self.c1_conv2 = _conv(features, features, 3, generator)
        self.c2_conv = _conv(in_ch, features, 1, generator)
        self.c2_bn = BatchNorm(features)
        self.attn = SqueezeExcitation(features, generator=generator)

    def forward(self, x, train: bool) -> torch.Tensor:
        y = _conv_strided(x, self.c1_conv1, self.stride)
        y = conv_same(_bn_relu(self.c1_bn, y, train, self.dtype),
                      self.c1_conv2)
        s = self.c2_bn(conv_same(x, self.c2_conv, self.stride), train)
        return self.attn(y + s.to(self.dtype))


class ResNetBlockSE(nn.Module):
    """BN-ReLU-conv3x3(stride)-BN-ReLU-conv3x3 plus a 1x1(stride) conv-BN
    skip, then squeeze-excitation."""

    def __init__(self, in_ch: int, features: int, stride: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.bn1 = BatchNorm(in_ch)
        self.conv1 = _conv(in_ch, features, 3, generator)
        self.bn2 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3, generator)
        self.skip = _conv(in_ch, features, 1, generator)
        self.skip_bn = BatchNorm(features)
        self.attn = SqueezeExcitation(features, generator=generator)

    def forward(self, x, train: bool) -> torch.Tensor:
        y = _bn_relu(self.bn1, x, train, self.dtype)
        y = _conv_strided(y, self.conv1, self.stride)
        y = conv_same(_bn_relu(self.bn2, y, train, self.dtype), self.conv2)
        s = self.skip_bn(conv_same(x, self.skip, self.stride), train)
        return self.attn(y + s.to(self.dtype))


class ASPP(nn.Module):
    """Three 3x3 convs dilated 6, 12 and 18 ('SAME'), each with BN, summed,
    then a 1x1 conv."""

    rates = (6, 12, 18)

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        for i in range(3):
            setattr(self, f"c{i + 1}", _conv(in_ch, features, 3, generator))
            setattr(self, f"bn{i + 1}", BatchNorm(features))
        self.out = _conv(features, features, 1, generator)

    def forward(self, x, train: bool) -> torch.Tensor:
        y = 0
        for i, rate in enumerate(self.rates, start=1):
            z = conv_same(x, getattr(self, f"c{i}"), dilation=rate)
            y = y + getattr(self, f"bn{i}")(z, train).to(self.dtype)
        return conv_nhwc(y, self.out)


class AttentionBlock(nn.Module):
    """The gate: g (the finer skip) BN-ReLU-conv3x3 and 2x2 max-pooled,
    plus x BN-ReLU-conv3x3; BN-ReLU-1x1 conv to one channel; times x."""

    def __init__(self, g_ch: int, x_ch: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.g_bn = BatchNorm(g_ch)
        self.g_conv = _conv(g_ch, features, 3, generator)
        self.x_bn = BatchNorm(x_ch)
        self.x_conv = _conv(x_ch, features, 3, generator)
        self.gc_bn = BatchNorm(features)
        self.gc_conv = _conv(features, 1, 1, generator)

    def forward(self, g, x, train: bool) -> torch.Tensor:
        dt = self.dtype
        gp = max_pool_2x2(conv_same(_bn_relu(self.g_bn, g, train, dt),
                                    self.g_conv))
        xc = conv_same(_bn_relu(self.x_bn, x, train, dt), self.x_conv)
        gate = _bn_relu(self.gc_bn, gp + xc, train, dt)
        return conv_nhwc(gate, self.gc_conv) * x


class ResUNetPlusPlus(nn.Module):
    """NHWC image -> fp32 logits (flax ``ResUNetPlusPlus``): channels
    16/32/64/128, the ASPP bridge at 256, decoder blocks ``d1..d3``
    (``_attn`` the gate, ``_res`` the SE residual block), ``aspp_out`` and
    the 1x1 ``output``."""

    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        g = generator
        self.c1 = StemBlock(in_channels, 16, 1, dtype, g)
        self.c2 = ResNetBlockSE(16, 32, 2, dtype, g)
        self.c3 = ResNetBlockSE(32, 64, 2, dtype, g)
        self.c4 = ResNetBlockSE(64, 128, 2, dtype, g)
        self.b1 = ASPP(128, 256, dtype, g)
        for name, skip, z, feat in (("d1", 64, 256, 128), ("d2", 32, 128, 64),
                                    ("d3", 16, 64, 32)):
            setattr(self, f"{name}_attn", AttentionBlock(skip, z, z, dtype, g))
            setattr(self, f"{name}_res", ResNetBlockSE(z + skip, feat, 1,
                                                       dtype, g))
        self.aspp_out = ASPP(32, 16, dtype, g)
        self.output = _conv(16, num_classes, 1, g)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        c1 = self.c1(x.to(self.dtype), train)
        c2 = self.c2(c1, train)
        c3 = self.c3(c2, train)
        y = self.b1(self.c4(c3, train), train)
        for name, skip in (("d1", c3), ("d2", c2), ("d3", c1)):
            a = _up2(getattr(self, f"{name}_attn")(skip, y, train))
            y = getattr(self, f"{name}_res")(torch.cat([a, skip], dim=-1),
                                             train)
        y = self.aspp_out(y, train)
        return conv_nhwc(y, self.output).float()

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self(x, train=False)
