"""UniFormer-S encoder with the SegFormer head and DenseCL necks (port of
``hpfg_tpu/models/uniformer.py``), NHWC.

uniformer_small: depths 3/4/8/3, dims 64/128/320/512, head dim 64 (heads
1/2/5/8), mlp ratio 4. Each stage opens with a patch-embed conv (4x4/4,
then 2x2/2) and LayerNorm (eps 1e-5) and ends with a BatchNorm. Stages 1-2
are conv blocks (CBlock: a 3x3 depthwise positional residual, BN -> 1x1 ->
5x5 depthwise -> 1x1, BN -> a 1x1 conv MLP), stages 3-4 global
self-attention blocks (SABlock: the positional conv, LayerNorm (eps 1e-6)
-> multi-head attention, LayerNorm -> MLP). Drop path rates rise linearly
from 0 to ``drop_path_rate`` = 0.1 over the 18 blocks, on in training as in
the JAX package; the head's dropout is ``drop_rate`` (0.1).

Init as flax's: the Dense layers trunc-normal(0.02) (``trunc_normal``'s
convention: truncated at +-2 std, not rescaled) with zero bias; every conv
torch's default U(+-1/sqrt(fan_in)), a depthwise one with fan-in k*k.

No Pallas kernel serves this model in the JAX package: the convs are cuDNN
(``conv_nhwc``), the Dense layers and the attention ``torch.matmul``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hpfg_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    DropPath,
    LayerNorm,
    ProjectionNeck,
    attention,
    conv_nhwc,
    conv_same,
)
from hpfg_tpu_torch.models.segformer import HEAD_DIM, SegFormerHead

#: the Dense layers' truncated-normal std
DENSE_STD = 0.02
#: uniformer_small's attention head width and MLP ratio
ATTN_HEAD_DIM, MLP_RATIO = 64, 4.0


class CBlock(nn.Module):
    """x += pos(x); x += drop_path(conv2(attn5x5(conv1(BN(x)))));
    x += drop_path(fc2(gelu(fc1(BN(x))))), the MLP 1x1 convs."""

    def __init__(self, dim: int, mlp_ratio: float, drop_path: float,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        hidden = int(dim * mlp_ratio)
        self.pos_embed = Conv(1, dim, 3, generator)
        self.norm1 = BatchNorm(dim)
        self.conv1 = Conv(dim, dim, 1, generator)
        self.attn = Conv(1, dim, 5, generator)
        self.conv2 = Conv(dim, dim, 1, generator)
        self.dp1 = DropPath(drop_path)
        self.norm2 = BatchNorm(dim)
        self.mlp_fc1 = Conv(dim, hidden, 1, generator)
        self.mlp_fc2 = Conv(hidden, dim, 1, generator)
        self.dp2 = DropPath(drop_path)

    def forward(self, x, train: bool, generator=None):
        x = x + conv_same(x, self.pos_embed, groups=self.dim)
        y = conv_nhwc(self.norm1(x, train).to(self.dtype), self.conv1)
        y = conv_same(y, self.attn, groups=self.dim)
        x = x + self.dp1(conv_nhwc(y, self.conv2), train, generator)
        y = conv_nhwc(self.norm2(x, train).to(self.dtype), self.mlp_fc1)
        y = conv_nhwc(F.gelu(y), self.mlp_fc2)
        return x + self.dp2(y, train, generator)


class SABlock(nn.Module):
    """x += pos(x); on the tokens t += drop_path(proj(MHSA(LN(t))));
    t += drop_path(fc2(gelu(fc1(LN(t)))))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 drop_path: float, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, num_heads, dtype
        hidden = int(dim * mlp_ratio)
        self.pos_embed = Conv(1, dim, 3, generator)
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.qkv = Dense(dim, 3 * dim, generator, std=DENSE_STD)
        self.proj = Dense(dim, dim, generator, std=DENSE_STD)
        self.dp1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = Dense(dim, hidden, generator, std=DENSE_STD)
        self.mlp_fc2 = Dense(hidden, dim, generator, std=DENSE_STD)
        self.dp2 = DropPath(drop_path)

    def forward(self, x, train: bool, generator=None):
        x = x + conv_same(x, self.pos_embed, groups=self.dim)
        b, h, w, c = x.shape
        hd = self.dim // self.heads
        t = x.reshape(b, h * w, c)
        qkv = self.qkv(self.norm1(t).to(self.dtype)).reshape(
            b, h * w, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        o = attention(qkv[0], qkv[1], qkv[2], hd ** -0.5)
        o = self.proj(o.transpose(1, 2).reshape(b, h * w, self.dim))
        t = t + self.dp1(o, train, generator)
        y = self.mlp_fc1(self.norm2(t).to(self.dtype))
        y = self.mlp_fc2(F.gelu(y))
        t = t + self.dp2(y, train, generator)
        return t.reshape(b, h, w, c)


class UniFormer(nn.Module):
    """The four-stage encoder: NHWC stage features in the compute dtype.
    (flax's dropout after the first patch embed has rate 0 wherever the
    encoder is built; the port has none.)"""

    def __init__(self, in_channels: int = 3,
                 depth: Sequence[int] = (3, 4, 8, 3),
                 embed_dim: Sequence[int] = (64, 128, 320, 512),
                 drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.depth, self.embed_dims = list(depth), list(embed_dim)
        self.dtype = dtype
        dpr = np.linspace(0, drop_path_rate, sum(depth))
        cur, c = 0, in_channels
        for s in range(4):
            p = 4 if s == 0 else 2
            setattr(self, f"patch_embed{s + 1}", Conv(c, embed_dim[s], p,
                                                      generator))
            setattr(self, f"patch_norm{s + 1}", LayerNorm(embed_dim[s],
                                                          eps=1e-5))
            for i in range(depth[s]):
                rate = float(dpr[cur + i])
                block = (CBlock(embed_dim[s], MLP_RATIO, rate, dtype,
                                generator) if s < 2 else
                         SABlock(embed_dim[s], embed_dim[s] // ATTN_HEAD_DIM,
                                 MLP_RATIO, rate, dtype, generator))
                setattr(self, f"block{s + 1}_{i}", block)
            setattr(self, f"norm{s + 1}", BatchNorm(embed_dim[s]))
            cur += depth[s]
            c = embed_dim[s]

    def forward(self, x, train: bool, generator=None) -> list[torch.Tensor]:
        x = x.to(self.dtype)
        feats = []
        for s in range(4):
            p = 4 if s == 0 else 2
            x = conv_same(x, getattr(self, f"patch_embed{s + 1}"), p)
            x = getattr(self, f"patch_norm{s + 1}")(x).to(self.dtype)
            for i in range(self.depth[s]):
                x = getattr(self, f"block{s + 1}_{i}")(x, train, generator)
            x = getattr(self, f"norm{s + 1}")(x, train).to(self.dtype)
            feats.append(x)
        return feats


class UniformerPlus(nn.Module):
    """Uniformer_Plus (flax ``UniformerPlus``): the UniFormer-S encoder, the
    SegFormer head and the DenseCL necks (``dense_projection_high`` on the
    last stage, hid 2048; ``dense_projection_head`` on the logits, hid
    1024). ``forward`` returns (logits, (g_high, d_high), (g_head,
    d_head)); ``val`` the logits."""

    def __init__(self, img_size: int = 224, in_channels: int = 3,
                 num_classes: int = 4, drop_path_rate: float = 0.1,
                 drop_rate: float = 0.1, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.encoder = UniFormer(in_channels=in_channels,
                                 drop_path_rate=drop_path_rate, dtype=dtype,
                                 generator=generator)
        self.decoder = SegFormerHead(self.encoder.embed_dims, num_classes,
                                     (img_size, img_size), HEAD_DIM,
                                     drop_rate, dtype, generator)
        self.dense_projection_high = ProjectionNeck(
            self.encoder.embed_dims[-1], hid_dim=2048, out_dim=128, s=4,
            dtype=dtype, generator=generator)
        self.dense_projection_head = ProjectionNeck(
            num_classes, hid_dim=1024, out_dim=128, s=4, dtype=dtype,
            generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        feats = self.encoder(x, train, generator)
        logits = self.decoder(feats, train, generator)
        high = self.dense_projection_high(feats[-1])
        head = self.dense_projection_head(logits.to(self.dtype))
        return logits, high, head

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x, False), False)
