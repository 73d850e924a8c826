"""Swin-Transformer U-Net (port of ``hpfg_tpu/models/swinunet.py``), NHWC.

PatchEmbed(4), embed 96, four stages of depths (2, 2, 6, 2) and heads
(3, 6, 12, 24), window 7 at 224 px (8 at 256), mlp ratio 4, drop 0.1,
attention drop 0.1, drop path 0.2; a decoder of PatchExpanding stages with
linear skip fusions, a final 4x patch expansion and a 1x1 head.
``SwinUNetPlus`` adds the DenseCL necks on the 8C bottleneck and on the
logits. Module and parameter names are the flax ones, Dense kernels
[in, out] and conv kernels HWIO, so ``utils/jax_weights.py`` maps a flax
tree by flattening it.

Every window attention runs through the hand-written kernels K13 (forward)
and K14 (backward) (``ops/window_attention.py``), attention dropout inside
them. The Dense layers, LayerNorm, GELU, roll, partition and reverse are
plain torch, as the JAX package leaves them to XLA; the patch-embedding conv
(4x4, stride 4) and the 1x1 head are convs whose stride equals their kernel,
so they run as reshapes and ``torch.matmul``. The dtype flow is the flax
one: LayerNorm returns fp32, each Dense casts its input to the compute
dtype, ``PatchEmbedding`` casts back to it, ``PatchExpanding`` hands fp32 to
the decoder's skip concat, and the logits return as fp32.

The relative-position index and the shift masks are numpy constants built
once per shape (cached) and held as non-persistent buffers, so they move
with the module, cost no host copy per forward and stay out of the weight
map. Each ``WindowAttention`` is built for the token resolution of its
stage (``img_size``), which fixes its shift mask.

Every train-mode forward takes ``rows`` (``parallel.mesh.Rows``, default
None) down to each block, as the UNet does (``models/layers.py``): under
data parallelism the attention dropout hashes each window's index in the
global batch (``rows.ids`` and ``rows.total`` into K13 / K14), and the
dropouts and drop paths draw for the global batch and keep this rank's
rows. LayerNorm mixes no images, so nothing else changes.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hpfg_tpu_torch.models.layers import (
    Conv,
    Dense,
    DropPath,
    LayerNorm,
    ProjectionNeck,
    _uniform,
    dropout,
    trunc_normal,
)
from hpfg_tpu_torch.ops.conv_block import HashDropout
from hpfg_tpu_torch.ops.window_attention import window_attention

#: std of the truncated-normal Dense and bias-table init (``_DENSE_INIT``)
DENSE_STD = 0.02


@functools.lru_cache(maxsize=None)
def _relative_position_index(ws: int) -> np.ndarray:
    """[ws², ws²] indices into the (2ws-1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))  # [2, ws, ws]
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, ws², ws²]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def _shift_attention_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """SW-MSA mask [num_windows, ws², ws²] with 0 / -100 entries."""
    img_mask = np.zeros((h, w))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws_ in slices:
            img_mask[hs, ws_] = cnt
            cnt += 1
    mask = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    mask = mask.reshape(-1, ws * ws)
    attn_mask = mask[:, None, :] - mask[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B·nH·nW, ws², C]."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _swin_dense(in_dim: int, out_dim: int, generator, use_bias=True):
    return Dense(in_dim, out_dim, generator, use_bias=use_bias, std=DENSE_STD)


class WindowAttention(nn.Module):
    """W-MSA / SW-MSA with relative position bias, for a [B, H, W, C] input
    of the token resolution ``resolution`` = (H, W)."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 shift: bool, resolution: tuple[int, int],
                 qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        ws = window_size
        self.dim, self.ws, self.heads = dim, ws, num_heads
        self.shift = ws // 2 if shift else 0
        self.resolution = tuple(resolution)
        self.attn_drop, self.proj_drop, self.dtype = attn_drop, proj_drop, dtype
        self.relative_position_bias_table = nn.Parameter(trunc_normal(
            ((2 * ws - 1) ** 2, num_heads), DENSE_STD, generator))
        self.qkv = _swin_dense(dim, 3 * dim, generator, qkv_bias)
        self.proj = _swin_dense(dim, dim, generator)
        self.register_buffer("rel_index", torch.from_numpy(
            _relative_position_index(ws).reshape(-1)), persistent=False)
        mask = None
        if self.shift:
            mask = torch.from_numpy(_shift_attention_mask(
                *self.resolution, ws, self.shift))
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor, train: bool,
                generator: torch.Generator | None = None,
                rows=None) -> torch.Tensor:
        b, h, w, c = x.shape
        if (h, w) != self.resolution:
            raise ValueError(f"WindowAttention built for {self.resolution} "
                             f"tokens, got {(h, w)}")
        ws, shift, l = self.ws, self.shift, self.ws * self.ws
        bias = self.relative_position_bias_table[self.rel_index].view(
            l, l, self.heads).permute(2, 0, 1)
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        qkv = self.qkv(window_partition(x.to(self.dtype), ws))
        drop = None
        if train and self.attn_drop > 0.0:
            seed = int(torch.randint(0, 1 << 23, (), generator=generator))
            ids = () if rows is None else (rows.ids, rows.total)
            drop = HashDropout(seed, 1.0 - self.attn_drop, *ids)
        out = window_attention(qkv, bias, self.attn_mask, self.heads, drop)
        out = dropout(self.proj(out), self.proj_drop, train, generator,
                      None if rows is None else rows.expand(len(out) // b))
        out = window_reverse(out, ws, h, w)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        return out


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, drop: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.drop, self.dtype = drop, dtype
        self.fc1 = _swin_dense(dim, hidden, generator)
        self.fc2 = _swin_dense(hidden, out, generator)

    def forward(self, x, train: bool, generator=None, rows=None):
        x = F.gelu(self.fc1(x.to(self.dtype)))  # exact erf GELU
        x = dropout(x, self.drop, train, generator, rows)
        x = self.fc2(x)
        return dropout(x, self.drop, train, generator, rows)


class SwinBlock(nn.Module):
    """LN -> (S)W-MSA -> residual + drop path -> LN -> MLP -> residual."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: bool, resolution: tuple[int, int],
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, shift,
                                    resolution, qkv_bias, attn_drop, drop,
                                    dtype, generator)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop, dtype, generator)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x, train: bool, generator=None, rows=None):
        y = self.attn(self.norm1(x), train, generator, rows)
        x = x + self.drop_path1(y, train, generator, rows)
        y = self.mlp(self.norm2(x), train, generator, rows)
        return x + self.drop_path2(y, train, generator, rows)


class PatchEmbedding(nn.Module):
    """p x p stride-p conv patchify to NHWC tokens, as reshape + matmul;
    ``proj`` kernel [p, p, C, E] and bias with torch's default init."""

    def __init__(self, in_ch: int, patch_size: int = 4, embed_dim: int = 96,
                 patch_norm: bool = True, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        p = patch_size
        self.p, self.embed_dim, self.dtype = p, embed_dim, dtype
        self.proj = Conv(in_ch, embed_dim, p, generator)
        self.norm = LayerNorm(embed_dim) if patch_norm else None

    def forward(self, x):
        b, h, w, c = x.shape
        p = self.p
        x = x.to(self.dtype).view(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // p, w // p, p * p * c)
        kernel = self.proj.kernel.reshape(p * p * c, self.embed_dim)
        x = torch.matmul(x, kernel.to(self.dtype)) \
            + self.proj.bias.to(self.dtype)
        if self.norm is not None:
            x = self.norm(x)
        return x.to(self.dtype)


class PatchMergingExact(nn.Module):
    """2x2 neighbourhood concat in the order [0::2,0::2], [1::2,0::2],
    [0::2,1::2], [1::2,1::2], LN, then a bias-free Dense 4C -> 2C."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(4 * dim)
        self.reduction = _swin_dense(4 * dim, 2 * dim, generator, False)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x).to(self.dtype))


class PatchExpanding(nn.Module):
    """Dense C -> 2C, 2x2 depth-to-space, LN over C/2 (fp32 out)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.expand = _swin_dense(dim, 2 * dim, generator, False)
        self.norm = LayerNorm(dim // 2)

    def forward(self, x):
        b, h, w, _ = x.shape
        x = self.expand(x.to(self.dtype)).view(b, h, w, 2, 2, self.dim // 2)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w,
                                                self.dim // 2)
        return self.norm(x)


class FinalPatchExpanding(nn.Module):
    """Dense C -> p²C, p x p depth-to-space, LN over C (fp32 out)."""

    def __init__(self, dim: int, patch: int = 4,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dim, self.p, self.dtype = dim, patch, dtype
        self.expand = _swin_dense(dim, patch * patch * dim, generator, False)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        b, h, w, _ = x.shape
        p = self.p
        x = self.expand(x.to(self.dtype)).view(b, h, w, p, p, self.dim)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * p, w * p, self.dim)
        return self.norm(x)


def _drop_path_rates(drop_path: float, depths: Sequence[int]):
    total = sum(depths)
    rates = np.linspace(0, drop_path, total)
    out, start = [], 0
    for d in depths:
        out.append(list(rates[start:start + d]))
        start += d
    return out


def _blocks(idx: int, embed_dim: int, window_size: int, depths, num_heads,
            mlp_ratio, qkv_bias, drop_rate, attn_drop_rate, drop_path,
            resolution, dtype, generator) -> dict[str, SwinBlock]:
    """Stage ``idx``'s SwinBlocks, named ``block{i}`` as in flax."""
    dim = embed_dim * 2 ** idx
    rates = _drop_path_rates(drop_path, depths)[idx]
    return {f"block{i}": SwinBlock(
        dim, num_heads[idx], window_size, i % 2 == 1, resolution, mlp_ratio,
        qkv_bias, drop_rate, attn_drop_rate, float(rates[i]), dtype,
        generator) for i in range(depths[idx])}


class SwinStage(nn.Module):
    """depth x SwinBlock (+ PatchMerging), stage ``index`` of the encoder."""

    def __init__(self, index: int, embed_dim: int, window_size: int,
                 depths, num_heads, mlp_ratio, qkv_bias, drop_rate,
                 attn_drop_rate, drop_path, patch_merging: bool,
                 resolution, dtype=torch.float32, generator=None):
        super().__init__()
        blocks = _blocks(index, embed_dim, window_size, depths, num_heads,
                         mlp_ratio, qkv_bias, drop_rate, attn_drop_rate,
                         drop_path, resolution, dtype, generator)
        for name, block in blocks.items():
            self.add_module(name, block)
        self.n = len(blocks)
        self.downsample = (PatchMergingExact(embed_dim * 2 ** index, dtype,
                                             generator)
                           if patch_merging else None)

    def forward(self, x, train: bool, generator=None, rows=None):
        for i in range(self.n):
            x = getattr(self, f"block{i}")(x, train, generator, rows)
        return x if self.downsample is None else self.downsample(x)


class SwinStageUp(nn.Module):
    """A decoder stage: the blocks of encoder stage len(depths) - index - 2
    (+ PatchExpanding)."""

    def __init__(self, index: int, embed_dim: int, window_size: int,
                 depths, num_heads, mlp_ratio, qkv_bias, drop_rate,
                 attn_drop_rate, drop_path, patch_expanding: bool,
                 resolution, dtype=torch.float32, generator=None):
        super().__init__()
        idx = len(depths) - index - 2
        blocks = _blocks(idx, embed_dim, window_size, depths, num_heads,
                         mlp_ratio, qkv_bias, drop_rate, attn_drop_rate,
                         drop_path, resolution, dtype, generator)
        for name, block in blocks.items():
            self.add_module(name, block)
        self.n = len(blocks)
        self.upsample = (PatchExpanding(embed_dim * 2 ** idx, dtype,
                                        generator)
                         if patch_expanding else None)

    def forward(self, x, train: bool, generator=None, rows=None):
        for i in range(self.n):
            x = getattr(self, f"block{i}")(x, train, generator, rows)
        return x if self.upsample is None else self.upsample(x)


class SwinUNetEncoder(nn.Module):
    def __init__(self, in_ch: int, img_size: int, patch_size: int = 4,
                 embed_dim: int = 96, window_size: int = 7,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.patch_embed = PatchEmbedding(in_ch, patch_size, embed_dim, True,
                                          dtype, generator)
        n = len(depths)
        self.n = n
        for i in range(n):
            r = img_size // patch_size // 2 ** i
            self.add_module(f"layer{i}", SwinStage(
                i, embed_dim, window_size, depths, num_heads, mlp_ratio,
                qkv_bias, drop_rate, attn_drop_rate, drop_path_rate,
                i != n - 1, (r, r), dtype, generator))

    def forward(self, x, train: bool, generator=None,
                rows=None) -> list[torch.Tensor]:
        x = dropout(self.patch_embed(x), self.drop_rate, train, generator,
                    rows)
        feats = []
        for i in range(self.n):
            if i != self.n - 1:
                feats.append(x)
            x = getattr(self, f"layer{i}")(x, train, generator, rows)
        feats.append(x)
        return feats


class SwinUNetDecoder(nn.Module):
    def __init__(self, num_classes: int, img_size: int, embed_dim: int = 96,
                 window_size: int = 7, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, patch_size: int = 4,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        n = len(depths)
        self.n, self.dtype = n, dtype
        self.first_patch_expanding = PatchExpanding(
            embed_dim * 2 ** (n - 1), dtype, generator)
        for i in range(n - 1):
            dim = embed_dim * 2 ** (n - 2 - i)
            self.add_module(f"skip{i}", _swin_dense(2 * dim, dim, generator))
            r = img_size // patch_size // 2 ** (n - 2 - i)
            self.add_module(f"layer_up{i}", SwinStageUp(
                i, embed_dim, window_size, depths, num_heads, mlp_ratio,
                qkv_bias, drop_rate, attn_drop_rate, drop_path_rate,
                i < n - 2, (r, r), dtype, generator))
        self.norm_up = LayerNorm(embed_dim)
        self.final_patch_expanding = FinalPatchExpanding(
            embed_dim, patch_size, dtype, generator)
        self.head = nn.Module()
        self.head.kernel = nn.Parameter(_uniform(
            (1, 1, embed_dim, num_classes), 1.0 / float(np.sqrt(embed_dim)),
            generator))

    def forward(self, feats, train: bool, generator=None,
                rows=None) -> torch.Tensor:
        x = self.first_patch_expanding(feats[-1])
        for i in range(self.n - 1):
            skip = feats[len(feats) - i - 2]
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
            x = getattr(self, f"skip{i}")(x.to(self.dtype))
            x = getattr(self, f"layer_up{i}")(x, train, generator, rows)
        x = self.final_patch_expanding(self.norm_up(x))
        x = torch.matmul(x.to(self.dtype), self.head.kernel[0, 0].to(
            self.dtype))
        return x.float()


class SwinUNet(nn.Module):
    """NHWC image [B, H, W, in_channels] -> fp32 logits [B, H, W,
    num_classes]; ``train`` turns dropout, attention dropout and drop path
    on, their draws made from ``generator``; ``rows`` places a
    data-parallel forward's rows in the global batch."""

    def __init__(self, in_channels: int = 3, num_classes: int = 4,
                 img_size: int = 224, patch_size: int = 4,
                 embed_dim: int = 96, window_size: int = 7,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.1, attn_drop_rate: float = 0.1,
                 drop_path_rate: float = 0.2,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(embed_dim=embed_dim, window_size=window_size,
                  depths=tuple(depths), num_heads=tuple(num_heads),
                  mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                  drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                  drop_path_rate=drop_path_rate, dtype=dtype,
                  generator=generator)
        self.encoder = SwinUNetEncoder(in_channels, img_size, patch_size,
                                       **kw)
        self.decoder = SwinUNetDecoder(num_classes, img_size,
                                       patch_size=patch_size, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                rows=None) -> torch.Tensor:
        x = x.to(self.dtype)
        return self.decoder(self.encoder(x, train, generator, rows), train,
                            generator, rows)

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self(x, train=False)


class SwinUNetPlus(SwinUNet):
    """SwinUNet + the DenseCL necks (``dense_projection_high`` on the 8C
    bottleneck, hid 2048; ``dense_projection_head`` on the logits, hid
    1024). ``forward`` returns (logits, (g_high, d_high), (g_head, d_head));
    ``val`` the logits alone."""

    def __init__(self, in_channels: int = 3, num_classes: int = 4,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, **kwargs):
        super().__init__(in_channels, num_classes, embed_dim=embed_dim,
                         depths=depths, dtype=dtype, generator=generator,
                         **kwargs)
        bottleneck = embed_dim * 2 ** (len(depths) - 1)
        self.dense_projection_high = ProjectionNeck(
            bottleneck, hid_dim=2048, out_dim=128, s=4, dtype=dtype,
            generator=generator)
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

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x.to(self.dtype), False), False)


def build_swinunet(name: str, img_size: int, in_channels: int,
                   num_classes: int, dtype: torch.dtype = torch.float32,
                   generator: torch.Generator | None = None, **hooks):
    """``swinunet``, ``swinunet_plus`` (window 7 at 224 px, 8 at 256) and
    ``swinunet_lidc`` (patch 2, window 3 at 96 px, 4 at 64). ``hooks``
    (embed_dim, depths, num_heads, window_size, drop_rate, attn_drop_rate,
    drop_path_rate) override the published geometry, for tests."""
    patch_size = 4
    window_size = hooks.pop("window_size", None)
    if name == "swinunet_lidc":
        patch_size = 2
        window_size = window_size or {96: 3, 64: 4}.get(img_size)
    elif window_size is None:
        window_size = {224: 7, 256: 8}.get(img_size)
    if window_size is None:
        raise NotImplementedError(f"{name} img_size {img_size}")
    cls = SwinUNetPlus if name.endswith("plus") else SwinUNet
    return cls(in_channels=in_channels, num_classes=num_classes,
               img_size=img_size, patch_size=patch_size,
               window_size=window_size, dtype=dtype, generator=generator,
               **hooks)
