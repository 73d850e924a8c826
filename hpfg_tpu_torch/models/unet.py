"""UNet, UNet_Plus, UNet_LIDC and UNet_Large (port of
``hpfg_tpu/models/unet.py``: ``UNet``, ``UNetPlus``, ``UNetLIDC``,
``DoubleConvLarge``, ``UNetLarge``).

Five levels, channels (16, 32, 64, 128, 256), encoder dropout
(0.05, 0.1, 0.2, 0.3, 0.5), bilinear align-corners decoder upsampling and a
3x3 logits head. NHWC in, fp32 NHWC logits out. ``UNetPlus`` adds the two
DenseCL projection necks, on the bottleneck (hid 2048) and on the logits
(hid 1024); its forward returns (logits, (g_high, d_high), (g_head,
d_head)) and ``.val`` the logits only. ``UNetLIDC`` is the UNet under the
registry's ``unet_lidc`` name (the LIDC and ISIC configs give it
``in_channels: 3`` and ``num_classes: 2``).

``UNetLarge`` is another network: bias-free conv-BN-ReLU double convs of
width ``base_c`` (32, or 64 as the LIDC variant) to 8 ``base_c``, a decoder
of align-corners x2 upsamples concatenated after their skips, and a 1x1
head. Its convs are cuDNN (``conv_nhwc``), not the ConvBlock kernels: the
JAX model never reaches the fused ConvBlock either.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hpfg_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvBlock,
    DownBlock,
    ProjectionNeck,
    UpBlock,
    conv_nhwc,
    conv_same,
    max_pool_2x2,
    resize_bilinear_align_corners,
)
from hpfg_tpu_torch.ops.conv_block import conv3x3_plain


class UNetEncoder(nn.Module):
    def __init__(self, in_channels: int, feature_chns: Sequence[int],
                 dropout: Sequence[float], dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(feature_chns) != 5:
            raise ValueError(f"feature_chns needs 5 entries, got "
                             f"{tuple(feature_chns)}")
        ft, dp = list(feature_chns), list(dropout)
        self.in_conv = ConvBlock(in_channels, ft[0], dp[0], dtype, generator)
        self.down1 = DownBlock(ft[0], ft[1], dp[1], dtype, generator)
        self.down2 = DownBlock(ft[1], ft[2], dp[2], dtype, generator)
        self.down3 = DownBlock(ft[2], ft[3], dp[3], dtype, generator)
        self.down4 = DownBlock(ft[3], ft[4], dp[4], dtype, generator)

    def forward(self, x, train: bool, generator=None,
                fold: bool = True, rows=None) -> list[torch.Tensor]:
        x0 = self.in_conv(x, train, generator, fold, rows)
        x1 = self.down1(x0, train, generator, fold, rows)
        x2 = self.down2(x1, train, generator, fold, rows)
        x3 = self.down3(x2, train, generator, fold, rows)
        x4 = self.down4(x3, train, generator, fold, rows)
        return [x0, x1, x2, x3, x4]


class UNetDecoder(nn.Module):
    def __init__(self, num_classes: int, feature_chns: Sequence[int],
                 dtype: torch.dtype, generator: torch.Generator | None = None):
        super().__init__()
        ft = list(feature_chns)
        self.up1 = UpBlock(ft[4], ft[3], ft[3], ft[3], 0.0, dtype, generator)
        self.up2 = UpBlock(ft[3], ft[2], ft[2], ft[2], 0.0, dtype, generator)
        self.up3 = UpBlock(ft[2], ft[1], ft[1], ft[1], 0.0, dtype, generator)
        self.up4 = UpBlock(ft[1], ft[0], ft[0], ft[0], 0.0, dtype, generator)
        self.out_conv = Conv(ft[0], num_classes, 3, generator)

    def forward(self, feature: list[torch.Tensor], train: bool,
                generator=None, fold: bool = True,
                rows=None) -> torch.Tensor:
        x0, x1, x2, x3, x4 = feature
        x = self.up1(x4, x3, train, generator, fold, rows)
        x = self.up2(x, x2, train, generator, fold, rows)
        x = self.up3(x, x1, train, generator, fold, rows)
        x = self.up4(x, x0, train, generator, fold, rows)
        # logits in fp32 for numerically stable losses
        return conv3x3_plain(x, self.out_conv.kernel,
                             self.out_conv.bias).float()


class UNet(nn.Module):
    """Plain UNet: NHWC image [B, H, W, in_channels] -> fp32 logits
    [B, H, W, num_classes]. ``train`` selects batch statistics (folded into
    the running ones unless ``fold`` is False) plus dropout; ``generator``
    draws the dropout seeds; ``rows`` (``parallel.mesh.Rows``) places a
    data-parallel forward's rows in the global batch."""

    def __init__(self, in_channels: int = 1, num_classes: int = 4,
                 feature_chns: Sequence[int] = (16, 32, 64, 128, 256),
                 dropout: Sequence[float] = (0.05, 0.1, 0.2, 0.3, 0.5),
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.encoder = UNetEncoder(in_channels, feature_chns, dropout, dtype,
                                   generator)
        self.decoder = UNetDecoder(num_classes, feature_chns, dtype,
                                   generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                fold: bool = True, rows=None) -> torch.Tensor:
        x = x.to(self.dtype)
        return self.decoder(self.encoder(x, train, generator, fold, rows),
                            train, generator, fold, rows)

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self(x, train=False)


class UNetPlus(nn.Module):
    """UNet + the DenseCL projection necks (flax ``UNetPlus``; module names
    ``dense_projection_high`` and ``dense_projection_head`` as in flax).
    ``forward(x, train)`` returns (logits, (g_high, d_high), (g_head,
    d_head)); ``val(x)`` the eval-mode logits alone."""

    def __init__(self, in_channels: int = 1, num_classes: int = 4,
                 feature_chns: Sequence[int] = (16, 32, 64, 128, 256),
                 dropout: Sequence[float] = (0.05, 0.1, 0.2, 0.3, 0.5),
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.encoder = UNetEncoder(in_channels, feature_chns, dropout, dtype,
                                   generator)
        self.decoder = UNetDecoder(num_classes, feature_chns, dtype,
                                   generator)
        self.dense_projection_high = ProjectionNeck(
            feature_chns[-1], hid_dim=2048, out_dim=128, s=4, dtype=dtype,
            generator=generator)
        self.dense_projection_head = ProjectionNeck(
            num_classes, hid_dim=1024, out_dim=128, s=4, dtype=dtype,
            generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                fold: bool = True, rows=None):
        feature = self.encoder(x.to(self.dtype), train, generator, fold, rows)
        logits = self.decoder(feature, train, generator, fold, rows)
        high = self.dense_projection_high(feature[-1])
        head = self.dense_projection_head(logits.to(self.dtype))
        return logits, high, head

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x.to(self.dtype), False), False)


class UNetLIDC(UNet):
    """The UNet for the binary LIDC / ISIC masks: the same topology, the
    same defaults and the same parameter names (flax ``UNetLIDC``
    subclasses ``UNet`` alike); the configs set ``in_channels`` to 3."""


class DoubleConvLarge(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN-ReLU with bias-free convs and a middle
    width ``mid`` (``out`` by default) (flax ``DoubleConvLarge``; its
    dropout rate is 0 wherever it is built)."""

    def __init__(self, in_ch: int, out: int, mid: int | None = None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        mid = out if mid is None else mid
        self.dtype = dtype
        self.conv1 = Conv(in_ch, mid, 3, generator, use_bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv2 = Conv(mid, out, 3, generator, use_bias=False)
        self.bn2 = BatchNorm(out)

    def forward(self, x, train: bool, rows=None) -> torch.Tensor:
        x = torch.relu(self.bn1(conv_same(x, self.conv1), train, rows=rows))
        x = conv_same(x.to(self.dtype), self.conv2)
        return torch.relu(self.bn2(x, train, rows=rows)).to(self.dtype)


class UNetLarge(nn.Module):
    """UNet_Large (flax ``UNetLarge``): NHWC image -> fp32 logits. Down path
    ``in_conv`` and ``down1..4`` (widths c, 2c, 4c, 8c, 8c after 2x2 max
    pools); up path ``up1..4``: x2 align-corners upsample, zero padding to
    the skip's size where they differ (odd sizes), concat [skip, x], a
    DoubleConvLarge to (4c, 2c, c, c) with a middle width of half the
    concat; ``out_conv`` a 1x1 conv with bias."""

    def __init__(self, in_channels: int = 1, num_classes: int = 4,
                 base_c: int = 32, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        c = base_c
        self.in_conv = DoubleConvLarge(in_channels, c, dtype=dtype,
                                       generator=generator)
        widths = (c, 2 * c, 4 * c, 8 * c, 8 * c)
        for i in range(1, 5):
            setattr(self, f"down{i}", DoubleConvLarge(
                widths[i - 1], widths[i], dtype=dtype, generator=generator))
        for i, out in enumerate((4 * c, 2 * c, c, c), start=1):
            cat = 2 * widths[4 - i]  # the skip and the upsampled input
            setattr(self, f"up{i}", DoubleConvLarge(cat, out, cat // 2,
                                                    dtype, generator))
        self.out_conv = Conv(c, num_classes, 1, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                rows=None) -> torch.Tensor:
        y = self.in_conv(x.to(self.dtype), train, rows)
        feats = [y]
        for i in range(1, 5):
            y = getattr(self, f"down{i}")(max_pool_2x2(y), train, rows)
            feats.append(y)
        for i, skip in enumerate(feats[3::-1], start=1):
            y = resize_bilinear_align_corners(y, (2 * y.shape[1],
                                                  2 * y.shape[2]))
            dy, dx = skip.shape[1] - y.shape[1], skip.shape[2] - y.shape[2]
            if dy or dx:
                y = F.pad(y, (0, 0, dx // 2, dx - dx // 2, dy // 2,
                              dy - dy // 2))
            y = torch.cat([skip, y], dim=-1)
            y = getattr(self, f"up{i}")(y, train, rows)
        return conv_nhwc(y, self.out_conv).float()

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self(x, train=False)
