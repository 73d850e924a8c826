"""UNet and UNet_Plus (port of ``hpfg_tpu/models/unet.py``: ``UNet``,
``UNetPlus``).

Five levels, channels (16, 32, 64, 128, 256), encoder dropout
(0.05, 0.1, 0.2, 0.3, 0.5), bilinear align-corners decoder upsampling and a
3x3 logits head. NHWC in, fp32 NHWC logits out. ``UNetPlus`` adds the two
DenseCL projection necks, on the bottleneck (hid 2048) and on the logits
(hid 1024); its forward returns (logits, (g_high, d_high), (g_head,
d_head)) and ``.val`` the logits only.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from hpfg_tpu_torch.models.layers import (
    Conv,
    ConvBlock,
    DownBlock,
    ProjectionNeck,
    UpBlock,
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
                fold: bool = True) -> list[torch.Tensor]:
        x0 = self.in_conv(x, train, generator, fold)
        x1 = self.down1(x0, train, generator, fold)
        x2 = self.down2(x1, train, generator, fold)
        x3 = self.down3(x2, train, generator, fold)
        x4 = self.down4(x3, train, generator, fold)
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
                generator=None, fold: bool = True) -> torch.Tensor:
        x0, x1, x2, x3, x4 = feature
        x = self.up1(x4, x3, train, generator, fold)
        x = self.up2(x, x2, train, generator, fold)
        x = self.up3(x, x1, train, generator, fold)
        x = self.up4(x, x0, train, generator, fold)
        # logits in fp32 for numerically stable losses
        return conv3x3_plain(x, self.out_conv.kernel,
                             self.out_conv.bias).float()


class UNet(nn.Module):
    """Plain UNet: NHWC image [B, H, W, in_channels] -> fp32 logits
    [B, H, W, num_classes]. ``train`` selects batch statistics (folded into
    the running ones unless ``fold`` is False) plus dropout; ``generator``
    draws the dropout seeds."""

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
                fold: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        return self.decoder(self.encoder(x, train, generator, fold), train,
                            generator, fold)

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
                fold: bool = True):
        feature = self.encoder(x.to(self.dtype), train, generator, fold)
        logits = self.decoder(feature, train, generator, fold)
        high = self.dense_projection_high(feature[-1])
        head = self.dense_projection_head(logits.to(self.dtype))
        return logits, high, head

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x.to(self.dtype), False), False)
