"""SegFormer / MiT (port of ``hpfg_tpu/models/segformer.py``), NHWC.

The MiT encoder: four stages, each an overlap patch embed (7x7 stride 4,
then 3x3 stride 2), MiT blocks of spatial-reduction attention (heads
1/2/5/8, reduction 8/4/2/1) and a MixFFN with a 3x3 depthwise conv, and a
LayerNorm. The all-MLP head projects every stage to 256 channels, upsamples
them to the 1/4 scale, fuses them with a 1x1 conv, BatchNorm and ReLU, and
upsamples the logits to the input size. ``segformer`` is the B0 backbone,
``segformer_plus`` B1 with the two DenseCL projection necks.

Module and parameter names are the flax ones (``encoder.block1_0.attn.q``,
``decoder.linear_c1``, ``decoder.bn``, ...), Dense kernels [in, out] and conv
kernels HWIO, so ``utils/jax_weights.py`` maps a flax tree by flattening it.

No Pallas kernel serves this model in the JAX package: its convs (patch
embeds, the reduction conv, the depthwise conv, the head's 1x1 convs) are
``F.conv2d`` on the NHWC storage seen as channels-last NCHW (cuDNN on the
card), its Dense layers ``torch.matmul`` (cuBLAS), and the attention plain
matmuls and softmax. The dtype flow is the flax one: LayerNorm and the
head's BatchNorm compute in fp32, attention logits and softmax are fp32,
P·V sums in fp32 and is cast to the compute dtype, and the logits return
as fp32.
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
    dropout,
    same_padding,
)

MIT_SETTINGS = {
    "B0": ([32, 64, 160, 256], [2, 2, 2, 2]),
    "B1": ([64, 128, 320, 512], [2, 2, 2, 2]),
    "B2": ([64, 128, 320, 512], [3, 4, 6, 3]),
    "B3": ([64, 128, 320, 512], [3, 4, 18, 3]),
    "B4": ([64, 128, 320, 512], [3, 8, 27, 3]),
    "B5": ([64, 128, 320, 512], [3, 6, 40, 3]),
}
STAGE_HEADS = (1, 2, 5, 8)
STAGE_SR = (8, 4, 2, 1)
#: every LayerNorm's epsilon (flax ``epsilon=1e-5``, as the head's BN's)
EPS = 1e-5
HEAD_DIM = 256
#: the parameters whose exact gradient is zero: the biases of the head's
#: ``linear_c1..4`` and of the encoder's last LayerNorm add a constant to
#: each channel of the fused features, which the train-mode BatchNorm after
#: ``linear_fuse`` subtracts again; a backward gives them rounding noise
BN_INVARIANT = frozenset({f"decoder.linear_c{i}.bias" for i in range(1, 5)}
                         | {"encoder.norm4.bias"})


def resize_half_pixel(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(method="linear")`` of NHWC ``x`` to ``hw``, for an
    upsample: bilinear with half-pixel centres (``align_corners=False``),
    which for an upsample equals JAX's triangle kernel, borders included.
    A downsample is refused: JAX's linear resize then antialiases and
    ``F.interpolate`` does not."""
    hw = tuple(int(v) for v in hw)
    if tuple(x.shape[1:3]) == hw:
        return x
    if hw[0] < x.shape[1] or hw[1] < x.shape[2]:
        raise ValueError(f"resize_half_pixel upsamples only: "
                         f"{tuple(x.shape[1:3])} -> {hw}")
    y = F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()


class EfficientAttention(nn.Module):
    """Spatial-reduction attention (flax ``EfficientAttention``): q from
    every token, k and v from the tokens after a kernel = stride =
    ``sr_ratio`` conv and a LayerNorm. The reduction conv pads as flax's
    default ``'SAME'`` does (none where sr divides the size, as at 224²:
    56/8, 28/4, 14/2)."""

    def __init__(self, dim: int, heads: int, sr_ratio: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dim, self.heads, self.sr_ratio, self.dtype = (dim, heads,
                                                           sr_ratio, dtype)
        self.q = Dense(dim, dim, generator)
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, generator)
            self.norm = LayerNorm(dim, eps=EPS)
        self.kv = Dense(dim, 2 * dim, generator)
        self.proj = Dense(dim, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        heads, hd = self.heads, self.dim // self.heads
        q = self.q(x).reshape(b, h * w, heads, hd).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            s = self.sr_ratio
            kv_in = conv_nhwc(x, self.sr, s, same_padding(h, s, s)
                              + same_padding(w, s, s))
            kv_in = self.norm(kv_in).to(self.dtype)
        n_kv = kv_in.shape[1] * kv_in.shape[2]
        kv = self.kv(kv_in).reshape(b, n_kv, 2, heads, hd).permute(
            2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        out = attention(q, k, v, hd ** -0.5).transpose(1, 2)
        out = out.reshape(b, h, w, self.dim)
        return self.proj(out)


class MixFFN(nn.Module):
    """fc1 -> 3x3 depthwise conv -> exact GELU -> fc2 (flax ``MixFFN``). The
    depthwise kernel is HWIO [3, 3, 1, hidden] as flax keeps it (fan-in 9)."""

    def __init__(self, dim: int, hidden: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.fc1 = Dense(dim, hidden, generator)
        self.dwconv = Conv(1, hidden, 3, generator)
        self.fc2 = Dense(hidden, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        x = conv_nhwc(x, self.dwconv, padding=(1, 1, 1, 1),
                      groups=self.hidden)
        return self.fc2(F.gelu(x))


class MiTBlock(nn.Module):
    """LN -> attention -> residual + drop path -> LN -> MixFFN -> residual +
    drop path (flax ``MiTBlock``); the residual stream is in the compute
    dtype."""

    def __init__(self, dim: int, heads: int, sr_ratio: int, drop_path: float,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, eps=EPS)
        self.attn = EfficientAttention(dim, heads, sr_ratio, dtype, generator)
        self.dp1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=EPS)
        self.mlp = MixFFN(dim, 4 * dim, generator)
        self.dp2 = DropPath(drop_path)

    def forward(self, x, train: bool, generator=None, rows=None):
        y = self.attn(self.norm1(x).to(self.dtype))
        x = x + self.dp1(y, train, generator, rows)
        y = self.mlp(self.norm2(x).to(self.dtype))
        return x + self.dp2(y, train, generator, rows)


class OverlapPatchEmbed(nn.Module):
    """p x p conv, stride s, symmetric padding p // 2, then LayerNorm
    (flax ``OverlapPatchEmbed``)."""

    def __init__(self, in_ch: int, dim: int, patch_size: int, stride: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.p, self.stride, self.dtype = patch_size, stride, dtype
        self.proj = Conv(in_ch, dim, patch_size, generator)
        self.norm = LayerNorm(dim, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.p // 2
        x = conv_nhwc(x, self.proj, self.stride, (p, p, p, p))
        return self.norm(x).to(self.dtype)


class MiT(nn.Module):
    """Mix Transformer encoder (flax ``MiT``): four NHWC stage features in
    the compute dtype. Drop path rates rise linearly from 0 to
    ``drop_path_rate`` over all blocks."""

    def __init__(self, model_name: str = "B0", in_channels: int = 3,
                 drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims, depths = MIT_SETTINGS[model_name]
        self.embed_dims, self.depths = list(dims), list(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        cur, in_ch = 0, in_channels
        for s in range(4):
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(
                in_ch, dims[s], 7 if s == 0 else 3, 4 if s == 0 else 2,
                dtype, generator))
            for i in range(depths[s]):
                setattr(self, f"block{s + 1}_{i}", MiTBlock(
                    dims[s], STAGE_HEADS[s], STAGE_SR[s], float(dpr[cur + i]),
                    dtype, generator))
            setattr(self, f"norm{s + 1}", LayerNorm(dims[s], eps=EPS))
            cur += depths[s]
            in_ch = dims[s]
        self.dtype = dtype

    def forward(self, x, train: bool, generator=None,
                rows=None) -> list[torch.Tensor]:
        feats = []
        for s in range(4):
            x = getattr(self, f"patch_embed{s + 1}")(x)
            for i in range(self.depths[s]):
                x = getattr(self, f"block{s + 1}_{i}")(x, train, generator,
                                                       rows)
            x = getattr(self, f"norm{s + 1}")(x).to(self.dtype)
            feats.append(x)
        return feats


class SegFormerHead(nn.Module):
    """All-MLP decode head (flax ``SegFormerHead``): ``linear_c1..4`` to
    ``embed_dim``, the 1/8-1/32 features upsampled to 1/4, concatenated
    deepest first, the bias-free 1x1 ``linear_fuse``, BatchNorm in fp32,
    ReLU, dropout, the 1x1 ``linear_pred``, and the fp32 logits upsampled to
    ``image_size``.

    The BatchNorm is flax's (momentum 0.9, epsilon 1e-5): in train mode it
    normalizes with the batch's biased variance and folds that same
    variance into the running statistics (``BatchNorm.fold``), where
    ``F.batch_norm`` would fold the unbiased one; in eval mode it uses the
    running statistics."""

    def __init__(self, in_dims: Sequence[int], num_classes: int,
                 image_size: Sequence[int], embed_dim: int = HEAD_DIM,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.image_size = tuple(int(v) for v in image_size)
        self.dropout_rate, self.dtype = float(dropout_rate), dtype
        for i, c in enumerate(in_dims):
            setattr(self, f"linear_c{i + 1}", Dense(c, embed_dim, generator))
        self.linear_fuse = Conv(4 * embed_dim, embed_dim, 1, generator,
                                use_bias=False)
        self.bn = BatchNorm(embed_dim)
        self.linear_pred = Conv(embed_dim, num_classes, 1, generator)

    def forward(self, feats: list[torch.Tensor], train: bool,
                generator=None, rows=None) -> torch.Tensor:
        hw = tuple(feats[0].shape[1:3])
        outs = []
        for i, f in enumerate(feats):
            y = getattr(self, f"linear_c{i + 1}")(f)
            outs.append(resize_half_pixel(y, hw) if i > 0 else y)
        x = conv_nhwc(torch.cat(outs[::-1], dim=-1), self.linear_fuse)
        x = torch.relu(self.bn(x, train, rows=rows)).to(self.dtype)
        x = dropout(x, self.dropout_rate, train, generator, rows)
        x = conv_nhwc(x, self.linear_pred)
        return resize_half_pixel(x.float(), self.image_size)


class SegFormer(nn.Module):
    """NHWC image [B, H, W, in_channels] -> fp32 logits [B, H, W,
    num_classes] (flax ``SegFormer``, B0). ``train`` turns the head's
    dropout and the encoder's drop path on, their draws made from
    ``generator``, and the head's BatchNorm to batch statistics; ``rows``
    (``parallel.mesh.Rows``) places a data-parallel forward's rows in the
    global batch."""

    default_mit = "B0"

    def __init__(self, image_size: Sequence[int] = (224, 224),
                 in_channels: int = 3, num_classes: int = 4,
                 model_name: str | None = None, drop_path_rate: float = 0.1,
                 drop_rate: float = 0.1, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.encoder = MiT(model_name or self.default_mit, in_channels,
                           drop_path_rate, dtype, generator)
        self.decoder = SegFormerHead(self.encoder.embed_dims, num_classes,
                                     image_size, HEAD_DIM, drop_rate, dtype,
                                     generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, rows=None):
        x = x.to(self.dtype)
        return self.decoder(self.encoder(x, train, generator, rows), train,
                            generator, rows)

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x.to(self.dtype), False), False)


class SegFormerPlus(SegFormer):
    """SegFormer B1 + the DenseCL necks (flax ``SegFormerPlus``):
    ``dense_projection_high`` on the last stage (hid 2048) and
    ``dense_projection_head`` on the logits (hid 1024). ``forward`` returns
    (logits, (g_high, d_high), (g_head, d_head)); ``val`` the logits
    alone."""

    default_mit = "B1"

    def __init__(self, image_size: Sequence[int] = (224, 224),
                 in_channels: int = 3, num_classes: int = 4,
                 model_name: str | None = None, drop_path_rate: float = 0.1,
                 drop_rate: float = 0.1, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__(image_size, in_channels, num_classes, model_name,
                         drop_path_rate, drop_rate, dtype, generator)
        self.dense_projection_high = ProjectionNeck(
            self.encoder.embed_dims[-1], hid_dim=2048, out_dim=128, s=4,
            dtype=dtype, generator=generator)
        self.dense_projection_head = ProjectionNeck(
            num_classes, hid_dim=1024, out_dim=128, s=4, dtype=dtype,
            generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, rows=None):
        feats = self.encoder(x.to(self.dtype), train, generator, rows)
        logits = self.decoder(feats, train, generator, rows)
        high = self.dense_projection_high(feats[-1])
        head = self.dense_projection_head(logits.to(self.dtype))
        return logits, high, head


def build_segformer(name: str, img_size: int, in_channels: int,
                    num_classes: int, dtype: torch.dtype = torch.float32,
                    generator: torch.Generator | None = None, **hooks):
    """``segformer`` (B0) or ``segformer_plus`` (B1 + necks) at
    ``img_size``². ``hooks`` (``mit``: a MIT_SETTINGS name, ``drop_path_rate``,
    ``drop_rate``: the head's dropout) override the published geometry and
    rates, for tests."""
    cls = SegFormerPlus if name.endswith("plus") else SegFormer
    return cls(image_size=(img_size, img_size), in_channels=in_channels,
               num_classes=num_classes, model_name=hooks.pop("mit", None),
               dtype=dtype, generator=generator, **hooks)
