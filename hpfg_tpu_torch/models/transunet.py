"""TransUNet (port of ``hpfg_tpu/models/transunet.py``), NHWC.

A CNN encoder (a 7x7/2 stem and three stride-2 ResNet bottlenecks), a ViT
over the 1/16 grid (8 post-norm blocks, 4 heads, mlp 512, the patch a grid
cell, the class token dropped at the end), a 3x3 conv to 512 channels, and
a decoder of four x2 align-corners upsamples, each with its skip concat and
two conv-BN-ReLUs, then a 1x1 head. ``transunet`` and ``transunet_lidc``
are the same model sized by the image.

The flax module's quirks are kept: the attention logits are multiplied by
sqrt(head_dim), not divided (x16 at dim 1024, 4 heads: the softmax is
nearly one-hot, so the logits come out of the product in fp32, as flax's
``preferred_element_type=float32`` gives them); the positional
``embedding`` [tokens + 1, dim] is drawn U[0, 1) and the ``cls_token``
N(0, 1); the stem pads 3 and the bottleneck's 3x3/2 pads 1 on each side
(not 'SAME'). Three dropouts of rate ``drop_rate`` (0.1, hard-coded in
flax) in each block and one in the ViT.

No Pallas kernel serves this model in the JAX package: its convs are cuDNN
(``conv_nhwc``) and its Dense layers and attention ``torch.matmul``. Every
init is torch's default but the two ViT tables. Names are the flax ones
(``encoder1.down_conv``, ``vit.block0.attn.qkv``, ``decoder1.bn1``, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hpfg_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    LayerNorm,
    attention,
    conv_nhwc,
    conv_same,
    dropout,
    resize_bilinear_align_corners,
)

#: the LayerNorms' epsilon (flax ``epsilon=1e-5``)
EPS = 1e-5
#: the published geometry (flax ``TransUNet``'s defaults, which no caller
#: changes): the stem's width, the ViT's heads, MLP width and blocks, and
#: the patch (a grid cell of the 1/16 map)
OUT_CHANNELS, HEADS, MLP_DIM, BLOCKS, PATCH = 128, 4, 512, 8, 16


def _bn_relu(bn: BatchNorm, x, train: bool, dtype):
    return torch.relu(bn(x, train)).to(dtype)


class MultiHeadAttention(nn.Module):
    """Bias-free qkv and out projections; logits x sqrt(head_dim)."""

    def __init__(self, dim: int, heads: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = Dense(dim, 3 * dim, generator, use_bias=False)
        self.out = Dense(dim, dim, generator, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        hd = self.dim // self.heads
        qkv = self.qkv(x).reshape(b, t, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)
        out = attention(qkv[0], qkv[1], qkv[2], hd ** 0.5)
        return self.out(out.transpose(1, 2).reshape(b, t, self.dim))


class TransformerBlock(nn.Module):
    """Post-norm: x = LN(x + drop(attn(x))), x = LN(x + drop(fc2(drop(
    gelu(fc1(x))))))."""

    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 drop_rate: float = 0.1, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.drop_rate, self.dtype = drop_rate, dtype
        self.attn = MultiHeadAttention(dim, heads, generator)
        self.norm1 = LayerNorm(dim, eps=EPS)
        self.fc1 = Dense(dim, mlp_dim, generator)
        self.fc2 = Dense(mlp_dim, dim, generator)
        self.norm2 = LayerNorm(dim, eps=EPS)

    def forward(self, x, train: bool, generator=None):
        r = self.drop_rate
        y = dropout(self.attn(x), r, train, generator)
        x = self.norm1(x + y).to(self.dtype)
        y = dropout(F.gelu(self.fc1(x)), r, train, generator)
        y = dropout(self.fc2(y), r, train, generator)
        return self.norm2(x + y).to(self.dtype)


class ViT(nn.Module):
    """Tokens [B, N, C] -> [B, N, dim]: projection, the class token
    prepended, the positional embedding added, dropout, the blocks, and the
    class token dropped."""

    def __init__(self, num_tokens: int, in_dim: int, dim: int, heads: int,
                 mlp_dim: int, blocks: int, drop_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.blocks, self.drop_rate, self.dtype = blocks, drop_rate, dtype
        self.projection = Dense(in_dim, dim, generator)
        self.cls_token = nn.Parameter(torch.randn((1, 1, dim),
                                                  generator=generator))
        self.embedding = nn.Parameter(torch.rand((num_tokens + 1, dim),
                                                 generator=generator))
        for i in range(blocks):
            setattr(self, f"block{i}", TransformerBlock(
                dim, heads, mlp_dim, drop_rate, dtype, generator))

    def forward(self, tokens, train: bool, generator=None):
        x = self.projection(tokens)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.embedding.to(x.dtype)
        x = dropout(x, self.drop_rate, train, generator)
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x, train, generator)
        return x[:, 1:]


class EncoderBottleneck(nn.Module):
    """1x1 -> 3x3/2 (pad 1) -> 1x1, bias-free, each with BN (ReLU on the
    first two), plus the residual: a 1x1/2 conv and BN; ReLU of the sum."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.down_conv = Conv(in_ch, out_ch, 1, generator, use_bias=False)
        self.down_bn = BatchNorm(out_ch)
        self.conv1 = Conv(in_ch, out_ch, 1, generator, use_bias=False)
        self.norm1 = BatchNorm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3, generator, use_bias=False)
        self.norm2 = BatchNorm(out_ch)
        self.conv3 = Conv(out_ch, out_ch, 1, generator, use_bias=False)
        self.norm3 = BatchNorm(out_ch)

    def forward(self, x, train: bool):
        dt = self.dtype
        down = self.down_bn(conv_same(x, self.down_conv, 2), train).to(dt)
        y = _bn_relu(self.norm1, conv_nhwc(x, self.conv1), train, dt)
        y = _bn_relu(self.norm2, conv_nhwc(y, self.conv2, 2, (1, 1, 1, 1)),
                     train, dt)
        y = self.norm3(conv_nhwc(y, self.conv3), train).to(dt)
        return torch.relu(y + down).to(dt)


class DecoderBottleneck(nn.Module):
    """x2 align-corners upsample, concat [skip, x] (when there is a skip),
    two 3x3 conv-BN-ReLUs."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(in_ch, out_ch, 3, generator)
        self.bn1 = BatchNorm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3, generator)
        self.bn2 = BatchNorm(out_ch)

    def forward(self, x, skip, train: bool):
        x = resize_bilinear_align_corners(x, (2 * x.shape[1],
                                              2 * x.shape[2]))
        if skip is not None:
            x = torch.cat([skip.to(x.dtype), x], dim=-1)
        x = _bn_relu(self.bn1, conv_same(x, self.conv1), train, self.dtype)
        return _bn_relu(self.bn2, conv_same(x, self.conv2), train,
                        self.dtype)


class TransUNet(nn.Module):
    """NHWC image [B, H, W, in_channels] -> fp32 logits [B, H, W,
    num_classes] (flax ``TransUNet``); H = W = ``image_size``, a multiple of
    16. ``train`` turns the dropouts on, their draws made from
    ``generator``, and the BatchNorms to batch statistics, which they fold
    into their running ones."""

    def __init__(self, image_size: int = 224, num_classes: int = 4,
                 in_channels: int = 3, drop_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        oc = OUT_CHANNELS
        self.grid = image_size // PATCH
        self.conv1 = Conv(in_channels, oc, 7, generator, use_bias=False)
        self.norm1 = BatchNorm(oc)
        self.encoder1 = EncoderBottleneck(oc, 2 * oc, dtype, generator)
        self.encoder2 = EncoderBottleneck(2 * oc, 4 * oc, dtype, generator)
        self.encoder3 = EncoderBottleneck(4 * oc, 8 * oc, dtype, generator)
        self.vit = ViT(self.grid ** 2, 8 * oc, 8 * oc, HEADS, MLP_DIM,
                       BLOCKS, drop_rate, dtype, generator)
        self.conv2 = Conv(8 * oc, 512, 3, generator)
        self.norm2 = BatchNorm(512)
        self.decoder1 = DecoderBottleneck(512 + 4 * oc, 2 * oc, dtype,
                                          generator)
        self.decoder2 = DecoderBottleneck(4 * oc, oc, dtype, generator)
        self.decoder3 = DecoderBottleneck(2 * oc, oc // 2, dtype, generator)
        self.decoder4 = DecoderBottleneck(oc // 2, oc // 8, dtype, generator)
        self.head = Conv(oc // 8, num_classes, 1, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = self.dtype
        x = conv_nhwc(x.to(dt), self.conv1, 2, (3, 3, 3, 3))
        x1 = _bn_relu(self.norm1, x, train, dt)
        x2 = self.encoder1(x1, train)
        x3 = self.encoder2(x2, train)
        x4 = self.encoder3(x3, train)
        b, g, c = x4.shape[0], self.grid, x4.shape[-1]
        tokens = self.vit(x4.reshape(b, g * g, c), train, generator)
        x4 = conv_same(tokens.reshape(b, g, g, c), self.conv2)
        x4 = _bn_relu(self.norm2, x4, train, dt)
        y = self.decoder1(x4, x3, train)
        y = self.decoder2(y, x2, train)
        y = self.decoder3(y, x1, train)
        y = self.decoder4(y, None, train)
        return conv_nhwc(y, self.head).float()

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self(x, train=False)


def build_transunet(name: str, img_size: int, in_channels: int,
                    num_classes: int, dtype: torch.dtype = torch.float32,
                    generator: torch.Generator | None = None,
                    **hooks) -> TransUNet:
    """``transunet`` / ``transunet_lidc`` at ``img_size``². ``hooks``
    (``drop_rate``) override the dropout rate, for tests."""
    return TransUNet(image_size=img_size, num_classes=num_classes,
                     in_channels=in_channels, dtype=dtype,
                     generator=generator, **hooks)
