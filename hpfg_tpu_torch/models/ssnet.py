"""SS-Net (port of ``hpfg_tpu/models/ssnet.py``), NHWC.

The UNet encoder and a decoder that also returns its last 16-channel
feature map, plus MLP heads over [N, F] rows: ``projection_head`` and
``prediction_head`` (16 -> 32 -> 32) and per class c the selectors
``contrastive_class_selector_{c}`` and ``contrastive_class_selector_memory
{c}`` (32 -> 32 -> 1, LeakyReLU 0.2). Every head is built here, eagerly
(flax creates parameters lazily, hence the JAX package's ``init_all``).

Every conv runs on the hand-written kernels, as in the UNet: the blocks
through ``FusedConvBlock`` and the 3x3 logits head ``out_conv`` (a plain
``nn.Conv`` in flax) through ``conv3x3_plain``. The decoder's upsamples
take the deterministic backward (``resize_bilinear_align_corners``): the
SS-Net loss differentiates the model with respect to its input (VAT), so a
backward runs inside the loss, whose value must not vary from run to run.
The heads are plain torch (Dense matmuls and an fp32 BatchNorm over rows),
as the JAX package leaves them to XLA; their module names are flax's
(``Dense_0``, ``BatchNorm_0``, ``Dense_1``), so ``utils/jax_weights.py``
maps a flax tree by flattening it.

``rows`` (``parallel.mesh.Rows``, default None) goes down the UNet as in
``models/unet.py``; a head given ``rows`` normalizes its train-mode rows
with the statistics of every rank's rows (their sums all-reduced).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hpfg_tpu_torch.models.layers import BatchNorm, Conv, Dense, UpBlock
from hpfg_tpu_torch.models.unet import UNetEncoder
from hpfg_tpu_torch.ops.conv_block import conv3x3_plain


class SSNetDecoder(nn.Module):
    """The UNet decoder; returns (fp32 logits, the last UpBlock's
    output)."""

    def __init__(self, num_classes: int, feature_chns: Sequence[int],
                 dtype: torch.dtype, generator: torch.Generator | None = None):
        super().__init__()
        ft = list(feature_chns)
        for i, (cin, cs) in enumerate(((ft[4], ft[3]), (ft[3], ft[2]),
                                       (ft[2], ft[1]), (ft[1], ft[0]))):
            self.add_module(f"up{i + 1}", UpBlock(
                cin, cs, cs, cs, 0.0, dtype, generator,
                deterministic_resize=True))
        self.out_conv = Conv(ft[0], num_classes, 3, generator)

    def forward(self, feature, train: bool, generator=None,
                fold: bool = True, rows=None):
        x0, x1, x2, x3, x4 = feature
        x = self.up1(x4, x3, train, generator, fold, rows)
        x = self.up2(x, x2, train, generator, fold, rows)
        x = self.up3(x, x1, train, generator, fold, rows)
        x_last = self.up4(x, x0, train, generator, fold, rows)
        logits = conv3x3_plain(x_last, self.out_conv.kernel,
                               self.out_conv.bias).float()
        return logits, x_last


class MLPHead(nn.Module):
    """Dense -> fp32 BatchNorm over the rows -> ReLU (LeakyReLU with
    ``negative_slope``) -> Dense; the Dense layers in the compute dtype."""

    def __init__(self, in_dim: int, hidden: int, out: int,
                 negative_slope: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.negative_slope, self.dtype = negative_slope, dtype
        self.Dense_0 = Dense(in_dim, hidden, generator)
        self.BatchNorm_0 = BatchNorm(hidden)
        self.Dense_1 = Dense(hidden, out, generator)

    def forward(self, x: torch.Tensor, train: bool,
                fold: bool = True, rows=None) -> torch.Tensor:
        x = self.BatchNorm_0(self.Dense_0(x.to(self.dtype)), train, fold,
                             rows)
        if self.negative_slope:
            x = F.leaky_relu(x, self.negative_slope)
        else:
            x = torch.relu(x)
        return self.Dense_1(x.to(self.dtype))


class SSNet(nn.Module):
    """``forward(x, train)`` -> (fp32 logits [B, H, W, C], last feature map
    [B, H, W, feature_chns[0]] in the compute dtype); ``val(x)`` the
    eval-mode logits; ``project``, ``predict``, ``select(c)`` and
    ``select_memory(c)`` the heads over [N, F] rows. ``fold`` as in the
    UNet (module doc of ``models/layers.py``)."""

    def __init__(self, in_channels: int = 1, num_classes: int = 4,
                 feature_chns: Sequence[int] = (16, 32, 64, 128, 256),
                 dropout: Sequence[float] = (0.05, 0.1, 0.2, 0.3, 0.5),
                 feat_dim: int = 32, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.num_classes = dtype, num_classes
        self.encoder = UNetEncoder(in_channels, feature_chns, dropout, dtype,
                                   generator)
        self.decoder = SSNetDecoder(num_classes, feature_chns, dtype,
                                    generator)
        self.projection_head = MLPHead(feature_chns[0], feat_dim, feat_dim,
                                       dtype=dtype, generator=generator)
        self.prediction_head = MLPHead(feat_dim, feat_dim, feat_dim,
                                       dtype=dtype, generator=generator)
        for c in range(num_classes):
            self.add_module(f"contrastive_class_selector_{c}", MLPHead(
                feat_dim, feat_dim, 1, 0.2, dtype, generator))
        for c in range(num_classes):
            self.add_module(f"contrastive_class_selector_memory{c}", MLPHead(
                feat_dim, feat_dim, 1, 0.2, dtype, generator))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, fold: bool = True,
                rows=None):
        feature = self.encoder(x.to(self.dtype), train, generator, fold,
                               rows)
        return self.decoder(feature, train, generator, fold, rows)

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self(x, train=False)[0]

    def project(self, features, train: bool = False, fold: bool = True,
                rows=None):
        return self.projection_head(features, train, fold, rows)

    def predict(self, features, train: bool = False, fold: bool = True,
                rows=None):
        return self.prediction_head(features, train, fold, rows)

    def select(self, c: int, features, train: bool = False,
               fold: bool = True, rows=None):
        return getattr(self, f"contrastive_class_selector_{c}")(
            features, train, fold, rows)

    def select_memory(self, c: int, features, train: bool = False,
                      fold: bool = True, rows=None):
        return getattr(self, f"contrastive_class_selector_memory{c}")(
            features, train, fold, rows)
