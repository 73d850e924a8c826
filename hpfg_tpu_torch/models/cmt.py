"""CMT, a conv-transformer hybrid encoder with the SegFormer head (port of
``hpfg_tpu/models/cmt.py``), NHWC.

The encoder: a stem of three conv-GELU-BNs (7x7/2 padded 3, then two 3x3
padded 1), and four stages of a 2x2/2 patch-embed conv and LayerNorm (eps
1e-5) followed by CMT blocks. A block is a local perception unit (a 3x3
depthwise conv residual), LayerNorm (eps 1e-6) -> spatial-reduction
attention with a learned relative-position bias, and LayerNorm -> an
inverted-residual MLP (1x1 conv-GELU-BN, a 3x3 depthwise residual, GELU-BN,
1x1 conv-BN). The attention's keys and values come from a depthwise
sr x sr / sr conv and BN (sr 8, 4, 2, 1). The GELU is exact.

``relative_pos_{s}`` [heads, N, N / sr^2], drawn N(0, 1), is one parameter
of the encoder per stage, shared by all of that stage's blocks, as flax's
``self.param`` in ``CMT`` makes it: HPFG's EMA of ``model1.encoder`` into
``model2.encoder`` carries it, and the weight map names it
``encoder.relative_pos_{s}``. Its N follows the image size.

``cmt`` is CMT_S (the xs encoder: dims 52/104/208/416, depths 3/3/12/3,
mlp ratio 3.77) with the SegFormer head; ``cmt_plus`` CMT_Plus (the tiny
encoder: dims 46/92/184/368, depths 2/2/10/2, mlp ratio 3.6) with the head
and the two DenseCL necks. The flax CMT's drop path rate is 0 wherever it
is built, so the port has none; the head's dropout is ``drop_rate`` (0.1).
Every init is torch's default but the relative-position tables; a
depthwise kernel is [k, k, 1, C] with fan-in k*k.

No Pallas kernel serves this model in the JAX package: the convs are cuDNN
(``conv_nhwc``), the Dense layers and the attention ``torch.matmul``.
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
    ProjectionNeck,
    attention,
    conv_nhwc,
    conv_same,
)
from hpfg_tpu_torch.models.segformer import HEAD_DIM, SegFormerHead

CMT_TINY = dict(embed_dims=(46, 92, 184, 368), stem_channel=16,
                depths=(2, 2, 10, 2), mlp_ratios=(3.6,) * 4)
CMT_XS = dict(embed_dims=(52, 104, 208, 416), stem_channel=16,
              depths=(3, 3, 12, 3), mlp_ratios=(3.77,) * 4)
#: every CMT's heads and key / value reduction per stage
HEADS, SR_RATIOS = (1, 2, 4, 8), (8, 4, 2, 1)


class CMTMlp(nn.Module):
    """1x1 conv-GELU-BN, 3x3 depthwise residual, GELU-BN, 1x1 conv-BN."""

    def __init__(self, dim: int, hidden: int, out: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden, self.dtype = hidden, dtype
        self.conv1 = Conv(dim, hidden, 1, generator)
        self.bn1 = BatchNorm(hidden)
        self.proj = Conv(1, hidden, 3, generator)
        self.proj_bn = BatchNorm(hidden)
        self.conv2 = Conv(hidden, out, 1, generator)
        self.bn2 = BatchNorm(out)

    def forward(self, x, train: bool, rows=None):
        dt = self.dtype
        x = self.bn1(F.gelu(conv_nhwc(x, self.conv1)), train,
                     rows=rows).to(dt)
        y = conv_same(x, self.proj, groups=self.hidden)
        x = self.proj_bn(F.gelu(y + x), train, rows=rows).to(dt)
        return self.bn2(conv_nhwc(x, self.conv2), train, rows=rows).to(dt)


class CMTAttention(nn.Module):
    """Spatial-reduction attention with the relative-position bias:
    softmax(q k^T / sqrt(d) + rel_pos) v, keys and values from the
    depthwise sr x sr / sr conv and BN."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dim, self.heads, self.sr_ratio = dim, num_heads, sr_ratio
        self.q = Dense(dim, dim, generator)
        if sr_ratio > 1:
            self.sr_conv = Conv(1, dim, sr_ratio, generator)
            self.sr_bn = BatchNorm(dim)
        self.k = Dense(dim, dim, generator)
        self.v = Dense(dim, dim, generator)
        self.proj = Dense(dim, dim, generator)
        self.dtype = dtype

    def forward(self, x, rel_pos: torch.Tensor, train: bool, rows=None):
        b, h, w, c = x.shape
        heads, hd = self.heads, self.dim // self.heads
        q = self.q(x).reshape(b, h * w, heads, hd).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = conv_same(x, self.sr_conv, self.sr_ratio, groups=c)
            kv_in = self.sr_bn(kv_in, train, rows=rows).to(self.dtype)
        m = kv_in.shape[1] * kv_in.shape[2]
        kv_in = kv_in.reshape(b, m, c)
        k = self.k(kv_in).reshape(b, m, heads, hd).transpose(1, 2)
        v = self.v(kv_in).reshape(b, m, heads, hd).transpose(1, 2)
        out = attention(q, k, v, hd ** -0.5, rel_pos)
        return self.proj(out.transpose(1, 2).reshape(b, h, w, self.dim))


class CMTBlock(nn.Module):
    """x += lpu(x); x += attn(LN(x)); x += mlp(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 sr_ratio: int, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.lpu = Conv(1, dim, 3, generator)
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = CMTAttention(dim, num_heads, sr_ratio, dtype, generator)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = CMTMlp(dim, int(dim * mlp_ratio), dim, dtype, generator)

    def forward(self, x, rel_pos, train: bool, rows=None):
        x = x + conv_same(x, self.lpu, groups=self.dim)
        x = x + self.attn(self.norm1(x).to(self.dtype), rel_pos, train, rows)
        return x + self.mlp(self.norm2(x).to(self.dtype), train, rows)


def _stage_sizes(img_size: int) -> list[int]:
    """The side of each stage's feature map: the stem's 7x7/2 (pad 3) and
    each patch embed's 2x2/2 'SAME' take n to ceil(n / 2)."""
    n = -(-img_size // 2)
    sizes = []
    for _ in range(4):
        n = -(-n // 2)
        sizes.append(n)
    return sizes


class CMT(nn.Module):
    """The four-stage CMT encoder: NHWC stage features in the compute
    dtype."""

    def __init__(self, img_size: int = 224, in_channels: int = 3,
                 embed_dims: Sequence[int] = CMT_TINY["embed_dims"],
                 stem_channel: int = 16,
                 mlp_ratios: Sequence[float] = CMT_TINY["mlp_ratios"],
                 depths: Sequence[int] = CMT_TINY["depths"],
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.embed_dims, self.depths = list(embed_dims), list(depths)
        self.dtype = dtype
        c = in_channels
        for i, k in enumerate((7, 3, 3)):
            setattr(self, f"stem_conv{i + 1}", Conv(c, stem_channel, k,
                                                    generator))
            setattr(self, f"stem_norm{i + 1}", BatchNorm(stem_channel))
            c = stem_channel
        for s, n in enumerate(_stage_sizes(img_size)):
            setattr(self, f"patch_embed_{s}", Conv(c, embed_dims[s], 2,
                                                   generator))
            setattr(self, f"patch_norm_{s}", LayerNorm(embed_dims[s],
                                                       eps=1e-5))
            m = n * n // SR_RATIOS[s] ** 2
            setattr(self, f"relative_pos_{s}", nn.Parameter(torch.randn(
                (HEADS[s], n * n, m), generator=generator)))
            for i in range(depths[s]):
                setattr(self, f"block{s}_{i}", CMTBlock(
                    embed_dims[s], HEADS[s], mlp_ratios[s], SR_RATIOS[s],
                    dtype, generator))
            c = embed_dims[s]

    def forward(self, x, train: bool, rows=None) -> list[torch.Tensor]:
        x = x.to(self.dtype)
        for i in range(3):
            s, p = (2, 3) if i == 0 else (1, 1)
            x = conv_nhwc(x, getattr(self, f"stem_conv{i + 1}"), s,
                          (p, p, p, p))
            x = getattr(self, f"stem_norm{i + 1}")(F.gelu(x), train,
                                                   rows=rows).to(self.dtype)
        feats = []
        for s in range(4):
            x = conv_same(x, getattr(self, f"patch_embed_{s}"), 2)
            x = getattr(self, f"patch_norm_{s}")(x).to(self.dtype)
            rel_pos = getattr(self, f"relative_pos_{s}")
            for i in range(self.depths[s]):
                x = getattr(self, f"block{s}_{i}")(x, rel_pos, train, rows)
            feats.append(x)
        return feats


class CMTSeg(nn.Module):
    """CMT_S: the xs encoder and the SegFormer head (flax ``CMTSeg``):
    NHWC image -> fp32 logits at ``image_size``."""

    encoder_kwargs = CMT_XS

    def __init__(self, image_size: Sequence[int] = (224, 224),
                 in_channels: int = 3, num_classes: int = 4,
                 drop_rate: float = 0.1, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.encoder = CMT(img_size=image_size[0], in_channels=in_channels,
                           dtype=dtype, generator=generator,
                           **self.encoder_kwargs)
        self.decoder = SegFormerHead(self.encoder.embed_dims, num_classes,
                                     image_size, HEAD_DIM, drop_rate, dtype,
                                     generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, rows=None):
        return self.decoder(self.encoder(x, train, rows), train, generator,
                            rows)

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x, False), False)


class CMTPlus(CMTSeg):
    """CMT_Plus: the tiny encoder, the head and the DenseCL necks (flax
    ``CMTPlus``): ``dense_projection_high`` on the last stage (hid 2048),
    ``dense_projection_head`` on the logits (hid 1024). ``forward`` returns
    (logits, (g_high, d_high), (g_head, d_head)); ``val`` the logits."""

    encoder_kwargs = CMT_TINY

    def __init__(self, image_size: Sequence[int] = (224, 224),
                 in_channels: int = 3, num_classes: int = 4,
                 drop_rate: float = 0.1, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__(image_size, in_channels, num_classes, drop_rate,
                         dtype, generator)
        self.dense_projection_high = ProjectionNeck(
            self.encoder.embed_dims[-1], hid_dim=2048, out_dim=128, s=4,
            dtype=dtype, generator=generator)
        self.dense_projection_head = ProjectionNeck(
            num_classes, hid_dim=1024, out_dim=128, s=4, dtype=dtype,
            generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, rows=None):
        feats = self.encoder(x, train, rows)
        logits = self.decoder(feats, train, generator, rows)
        high = self.dense_projection_high(feats[-1])
        head = self.dense_projection_head(logits.to(self.dtype))
        return logits, high, head


def build_cmt(name: str, img_size: int, in_channels: int, num_classes: int,
              dtype: torch.dtype = torch.float32,
              generator: torch.Generator | None = None, **hooks):
    """``cmt`` (CMT_S) or ``cmt_plus`` (CMT_Plus) at ``img_size``².
    ``hooks`` (``drop_rate``: the head's dropout) override the rate, for
    tests."""
    cls = CMTPlus if name.endswith("plus") else CMTSeg
    return cls(image_size=(img_size, img_size), in_channels=in_channels,
               num_classes=num_classes, dtype=dtype, generator=generator,
               **hooks)
