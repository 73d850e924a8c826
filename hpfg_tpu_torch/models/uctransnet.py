"""UCTransNet, a UNet with a channel-wise cross-scale transformer (port of
``hpfg_tpu/models/uctransnet.py``), NHWC.

A conv-BN-ReLU UNet encoder (widths 64/128/256/512/512). Its four skips go
through the ChannelTransformer: per-scale patch-embed convs (16, 8, 4, 2)
to one token grid, a zero-initialized positional embedding, dropout 0.1
(``drop_rate``), four BlockViT layers of channel-wise multi-head cross
attention (each scale's channels attend over the 960 channels of all
scales; ``psi``, an instance norm of each (sample, head)'s score matrix,
before the softmax; the heads' contexts averaged) and per-scale FFNs, a
LayerNorm per scale, and the reconstruction: nearest upsample by the patch
size, a 1x1 conv-BN-ReLU, and the skip added. The decoder gates each skip
with CCA (a sigmoid channel gate from the pooled skip and the nearest-x2
upsampled input), concatenates [skip, up] and applies two conv-BN-ReLUs.
The head is a 1x1 conv and a sigmoid, as in the JAX package.

Every conv and Dense keeps flax's default init (``init="lecun"``); the
positional embeddings start at zero. No Pallas kernel serves this model in
the JAX package: the convs are cuDNN (``conv_nhwc``), the Dense layers and
the attention ``torch.matmul``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hpfg_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    LayerNorm,
    conv_nhwc,
    conv_same,
    dropout,
    global_avg_pool,
    max_pool_2x2,
)

#: the published geometry: the first stage's width, the four skips' patch
#: sizes, the channel transformer's layers and heads, and its key / value
#: width (the sum of the four skips' channels, 64 + 128 + 256 + 512)
BASE, PATCH_SIZES, LAYERS, HEADS, KV_SIZE = 64, (16, 8, 4, 2), 4, 4, 960


def _dense(in_dim: int, out_dim: int, generator, use_bias: bool = True):
    return Dense(in_dim, out_dim, generator, use_bias=use_bias, init="lecun")


def _nearest(x: torch.Tensor, p: int) -> torch.Tensor:
    """``jnp.repeat`` by ``p`` along H and W: the nearest upsample."""
    return x.repeat_interleave(p, dim=1).repeat_interleave(p, dim=2)


class ConvBatchNorm(nn.Module):
    """3x3 conv ('SAME') - BN - ReLU."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv(in_ch, features, 3, generator, init="lecun")
        self.norm = BatchNorm(features)

    def forward(self, x, train: bool, rows=None) -> torch.Tensor:
        return torch.relu(self.norm(conv_same(x, self.conv), train,
                                    rows=rows)).to(self.dtype)


class NConvs(nn.Module):
    """``n`` ConvBatchNorms, ``conv0`` .. ``conv{n-1}``."""

    def __init__(self, in_ch: int, features: int, n: int = 2,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n = n
        for i in range(n):
            setattr(self, f"conv{i}", ConvBatchNorm(
                in_ch if i == 0 else features, features, dtype, generator))

    def forward(self, x, train: bool, rows=None) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"conv{i}")(x, train, rows)
        return x


class ChannelAttentionOrg(nn.Module):
    """Channel-wise multi-head cross attention: for scale i and head h, the
    scores q_ih^T k_h [C_i, 960] / sqrt(960) over the tokens, ``psi`` (zero
    mean, unit variance over each score matrix, eps 1e-5), the softmax over
    the 960 channels, the context P v_h^T, the mean over the heads, and
    ``out{i}``. All bias-free; scores and softmax in fp32, the context
    summed in fp32."""

    def __init__(self, channel_num: Sequence[int],
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.channel_num, self.dtype = list(channel_num), dtype
        total = sum(channel_num)
        for h in range(HEADS):
            setattr(self, f"key_{h}", _dense(total, KV_SIZE, generator,
                                             False))
            setattr(self, f"value_{h}", _dense(total, KV_SIZE, generator,
                                               False))
        for i, c in enumerate(channel_num):
            for h in range(HEADS):
                setattr(self, f"query{i}_{h}", _dense(c, c, generator, False))
            setattr(self, f"out{i}", _dense(c, c, generator, False))

    def _heads(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([getattr(self, f"{name}{h}")(x)
                            for h in range(HEADS)], dim=1)

    def forward(self, embs, emb_all) -> list[torch.Tensor]:
        k = self._heads("key_", emb_all).float()  # [B, H, N, 960]
        v = self._heads("value_", emb_all).float()
        outs = []
        for i, emb in enumerate(embs):
            q = self._heads(f"query{i}_", emb)  # [B, H, N, C_i]
            scores = torch.matmul(q.float().transpose(-1, -2), k) \
                / KV_SIZE ** 0.5
            var, mean = torch.var_mean(scores, dim=(2, 3), keepdim=True,
                                       correction=0)
            scores = (scores - mean) * torch.rsqrt(var + 1e-5)
            probs = torch.softmax(scores, dim=-1).to(self.dtype)
            ctx = torch.matmul(probs.float(), v.transpose(-1, -2))
            ctx = ctx.mean(1).transpose(1, 2).to(self.dtype)  # [B, N, C_i]
            outs.append(getattr(self, f"out{i}")(ctx))
        return outs


class BlockViT(nn.Module):
    """Each scale: LN (``attn_norm{i}``); the concat LN (``attn_norm_all``);
    the channel attention, added; then LN (``ffn_norm{i}``), fc1 (x4) -
    GELU - fc2, added."""

    def __init__(self, channel_num: Sequence[int],
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.channel_num, self.dtype = list(channel_num), dtype
        for i, c in enumerate(channel_num):
            setattr(self, f"attn_norm{i}", LayerNorm(c))
        self.attn_norm_all = LayerNorm(sum(channel_num))
        self.channel_attn = ChannelAttentionOrg(channel_num, dtype,
                                                generator)
        for i, c in enumerate(channel_num):
            setattr(self, f"ffn_norm{i}", LayerNorm(c))
            setattr(self, f"ffn{i}_fc1", _dense(c, 4 * c, generator))
            setattr(self, f"ffn{i}_fc2", _dense(4 * c, c, generator))

    def forward(self, embs) -> list[torch.Tensor]:
        dt = self.dtype
        normed = [getattr(self, f"attn_norm{i}")(e).to(dt)
                  for i, e in enumerate(embs)]
        emb_all = self.attn_norm_all(torch.cat(normed, dim=-1)).to(dt)
        embs = [e + a for e, a in zip(embs,
                                      self.channel_attn(normed, emb_all))]
        outs = []
        for i, e in enumerate(embs):
            y = getattr(self, f"ffn_norm{i}")(e).to(dt)
            y = getattr(self, f"ffn{i}_fc2")(F.gelu(
                getattr(self, f"ffn{i}_fc1")(y)))
            outs.append(e + y)
        return outs


class ChannelTransformer(nn.Module):
    """The skips [x1..x4] -> the skips plus their reconstruction. The token
    grid is ``img_size`` / 16 on a side, which sizes ``pos_embed{i}``."""

    def __init__(self, img_size: int, channel_num: Sequence[int],
                 drop_rate: float = 0.1, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.channel_num, self.drop_rate = list(channel_num), drop_rate
        self.dtype = dtype
        grid = img_size // PATCH_SIZES[0]
        for i, (c, p) in enumerate(zip(channel_num, PATCH_SIZES)):
            setattr(self, f"patch_embed{i}", Conv(c, c, p, generator,
                                                  init="lecun"))
            setattr(self, f"pos_embed{i}", nn.Parameter(
                torch.zeros(1, grid * grid, c)))
        for layer in range(LAYERS):
            setattr(self, f"block{layer}", BlockViT(channel_num, dtype,
                                                    generator))
        for i, c in enumerate(channel_num):
            setattr(self, f"encoder_norm{i}", LayerNorm(c))
            setattr(self, f"reconstruct{i}", Conv(c, c, 1, generator,
                                                  init="lecun"))
            setattr(self, f"reconstruct_bn{i}", BatchNorm(c))

    def forward(self, feats, train: bool, generator=None, rows=None):
        embs, grids = [], []
        for i, (f, p) in enumerate(zip(feats, PATCH_SIZES)):
            e = conv_same(f, getattr(self, f"patch_embed{i}"), p)
            g = e.shape[1]
            grids.append(g)
            e = e.reshape(e.shape[0], g * g, -1) \
                + getattr(self, f"pos_embed{i}").to(e.dtype)
            embs.append(dropout(e, self.drop_rate, train, generator, rows))
        for layer in range(LAYERS):
            embs = getattr(self, f"block{layer}")(embs)
        outs = []
        for i, (e, p, g) in enumerate(zip(embs, PATCH_SIZES, grids)):
            e = getattr(self, f"encoder_norm{i}")(e).to(self.dtype)
            img = _nearest(e.reshape(e.shape[0], g, g, -1), p)
            img = conv_nhwc(img, getattr(self, f"reconstruct{i}"))
            img = torch.relu(getattr(self, f"reconstruct_bn{i}")(
                img, train, rows=rows))
            outs.append(feats[i] + img.to(self.dtype))
        return outs


class CCA(nn.Module):
    """x * sigmoid((mlp_x(mean_hw x) + mlp_g(mean_hw g)) / 2), then ReLU."""

    def __init__(self, x_ch: int, g_ch: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mlp_x = _dense(x_ch, features, generator)
        self.mlp_g = _dense(g_ch, features, generator)

    def forward(self, g, x) -> torch.Tensor:
        att = (self.mlp_x(global_avg_pool(x))
               + self.mlp_g(global_avg_pool(g))) / 2.0
        scale = torch.sigmoid(att.float()).to(x.dtype)
        return torch.relu(x * scale[:, None, None, :])


class UpBlockAttention(nn.Module):
    """Nearest x2 upsample, the CCA-gated skip, concat [skip, up], two
    ConvBatchNorms."""

    def __init__(self, in_ch: int, skip_ch: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.coatt = CCA(skip_ch, in_ch, skip_ch, generator)
        self.nconvs = NConvs(skip_ch + in_ch, features, 2, dtype, generator)

    def forward(self, x, skip, train: bool, rows=None) -> torch.Tensor:
        up = _nearest(x, 2)
        skip = self.coatt(up, skip)
        return self.nconvs(torch.cat([skip, up], dim=-1), train, rows)


class UCTransNet(nn.Module):
    """NHWC image -> fp32 sigmoid probabilities [B, H, W, num_classes]
    (flax ``UCTransNet``); H = W = ``img_size``, a multiple of 16."""

    def __init__(self, img_size: int = 224, in_channels: int = 3,
                 num_classes: int = 1, drop_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        c = BASE
        self.inc = ConvBatchNorm(in_channels, c, dtype, generator)
        for i, (cin, cout) in enumerate(((c, 2 * c), (2 * c, 4 * c),
                                         (4 * c, 8 * c), (8 * c, 8 * c)),
                                        start=1):
            setattr(self, f"down{i}", NConvs(cin, cout, 2, dtype, generator))
        self.mtc = ChannelTransformer(img_size, (c, 2 * c, 4 * c, 8 * c),
                                      drop_rate=drop_rate, dtype=dtype,
                                      generator=generator)
        self.up4 = UpBlockAttention(8 * c, 8 * c, 4 * c, dtype, generator)
        self.up3 = UpBlockAttention(4 * c, 4 * c, 2 * c, dtype, generator)
        self.up2 = UpBlockAttention(2 * c, 2 * c, c, dtype, generator)
        self.up1 = UpBlockAttention(c, c, c, dtype, generator)
        self.outc = Conv(c, num_classes, 1, generator, init="lecun")

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                rows=None) -> torch.Tensor:
        feats = [self.inc(x.to(self.dtype), train, rows)]
        for i in range(1, 5):
            feats.append(getattr(self, f"down{i}")(max_pool_2x2(feats[-1]),
                                                   train, rows))
        x1, x2, x3, x4 = self.mtc(feats[:4], train, generator, rows)
        y = self.up4(feats[4], x4, train, rows)
        y = self.up3(y, x3, train, rows)
        y = self.up2(y, x2, train, rows)
        y = self.up1(y, x1, train, rows)
        return torch.sigmoid(conv_nhwc(y, self.outc).float())

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self(x, train=False)
