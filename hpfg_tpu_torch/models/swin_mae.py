"""Swin-MAE, masked-autoencoder pretraining of a Swin encoder (port of
``hpfg_tpu/models/swin_mae.py``), NHWC.

Geometry of the reference's ``swin_mae()``: image 224, patch 4, depths
(2, 2, 2, 2), heads (3, 6, 12, 24), window 7, embed 96, decoder embed 768
(= 8 x 96), drop path 0.1, no attention dropout. The encoder is the
SwinUNet encoder's modules under the same names (``patch_embed``,
``layer{i}``), so ``utils/pretrain.py`` moves them into a SwinUNet by key;
the decoder is ``first_patch_expanding``, ``layer_up{i}`` (the encoder
stages' blocks in reverse, without skips), ``norm_up`` and
``decoder_pred``, a Dense to p^2 * C pixels with a xavier-uniform kernel
and a zero bias.

Window masking: adjacent r x r = 4 x 4 patch windows are masked together.
An argsort of uniform noise over the d^2 = 14^2 windows keeps (1 -
mask_ratio) d^2 = 49 of them, and the learned ``mask_token`` takes every
other token's place; every token, masked or not, still goes through every
block, so the window attentions (K13 / K14 on the card) run over all
windows. The noise is drawn on the device from a seed of ``generator``
(or injected). An eval-mode forward masks with a fixed-seed generator: the
same mask every call, but not the mask of the JAX package's
``PRNGKey(0)``. Under data parallelism (``rows``, ``parallel.mesh.Rows``)
the noise is drawn for the global batch and this rank's rows are kept, and
``rows`` goes down to every block as in the SwinUNet.

A fixed 2-D sin-cos table is kept, as in the reference and the JAX model,
and never added to the tokens.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from hpfg_tpu_torch.models.layers import Dense, LayerNorm, _draw
from hpfg_tpu_torch.models.swinunet import (
    PatchEmbedding,
    PatchExpanding,
    SwinStage,
    SwinStageUp,
)

#: the seed of an eval-mode forward's mask noise
EVAL_MASK_SEED = 0


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """The fixed sin-cos table [grid^2, embed_dim] (kept, never added)."""
    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float64)
    grid_w = np.arange(grid_size, dtype=np.float64)
    grid = np.stack(np.meshgrid(grid_w, grid_h)).reshape(2, -1)
    emb = np.concatenate([_1d(embed_dim // 2, grid[0]),
                          _1d(embed_dim // 2, grid[1])], axis=1)
    return emb.astype(np.float32)


class SwinMAE(nn.Module):
    """``forward(x, train)`` -> (reconstruction [B, H, W, C] fp32, mask
    [B, H, W, C] fp32 with 1 where masked)."""

    def __init__(self, in_channels: int = 3, img_size: int = 224,
                 patch_size: int = 4, mask_ratio: float = 0.75,
                 embed_dim: int = 96, decoder_embed_dim: int = 768,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 norm_pix_loss: bool = False, mask_window: int = 4,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_channels, self.patch_size = in_channels, patch_size
        self.mask_ratio, self.mask_window = mask_ratio, mask_window
        self.norm_pix_loss, self.dtype = norm_pix_loss, dtype
        self.grid = img_size // patch_size
        depths, num_heads = tuple(depths), tuple(num_heads)
        n = self.n = len(depths)
        self.patch_embed = PatchEmbedding(in_channels, patch_size, embed_dim,
                                          True, dtype, generator)
        self.mask_token = nn.Parameter(
            torch.randn((1, 1, embed_dim), generator=generator) * 0.02)
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim, self.grid)), persistent=False)
        kw = dict(embed_dim=embed_dim, window_size=window_size,
                  depths=depths, num_heads=num_heads, mlp_ratio=mlp_ratio,
                  qkv_bias=qkv_bias, drop_rate=drop_rate,
                  attn_drop_rate=attn_drop_rate, drop_path=drop_path_rate,
                  dtype=dtype, generator=generator)
        for i in range(n):
            r = self.grid // 2 ** i
            self.add_module(f"layer{i}", SwinStage(
                i, patch_merging=i != n - 1, resolution=(r, r), **kw))
        self.first_patch_expanding = PatchExpanding(decoder_embed_dim, dtype,
                                                    generator)
        for i in range(n - 1):
            r = self.grid // 2 ** (n - 2 - i)
            self.add_module(f"layer_up{i}", SwinStageUp(
                i, patch_expanding=i < n - 2, resolution=(r, r), **kw))
        self.norm_up = LayerNorm(embed_dim)
        out = patch_size ** 2 * in_channels
        bound = math.sqrt(6.0 / (embed_dim + out))
        self.decoder_pred = Dense(embed_dim, out, generator)
        with torch.no_grad():
            self.decoder_pred.kernel.uniform_(-bound, bound,
                                              generator=generator)
            self.decoder_pred.bias.zero_()

    def windows(self) -> int:
        """d^2, the count of r x r mask windows."""
        return (self.grid // self.mask_window) ** 2

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """NHWC [N, H, W, C] -> [N, L, p^2 C]."""
        n, h, w, c = imgs.shape
        p = self.patch_size
        x = imgs.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, (h // p) * (w // p), p * p * c)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """[N, L, p^2 C] -> NHWC."""
        n, l, _ = x.shape
        p = self.patch_size
        g = int(round(l ** 0.5))
        x = x.reshape(n, g, g, p, p, self.in_channels)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, g * p, g * p, self.in_channels)

    def window_masking(self, x: torch.Tensor, noise: torch.Tensor):
        """``x`` [B, H, W, C] tokens, ``noise`` [B, d^2] -> (tokens with the
        mask token in every masked place, mask [B, L] with 1 = masked)."""
        b, h, w, c = x.shape
        l, r = h * w, self.mask_window
        d = h // r
        keep = int(d * d * (1.0 - self.mask_ratio))
        sparse_keep = torch.argsort(noise, dim=1, stable=True)[:, :keep]
        part = (sparse_keep // d) * d * r * r + (sparse_keep % d) * r
        rr = torch.arange(r, device=x.device)
        offsets = (rr[:, None] * h + rr[None, :]).reshape(-1)
        index_keep = (part[:, :, None] + offsets[None, None, :]).reshape(b, -1)
        keep_mask = torch.zeros((b, l), device=x.device).scatter_(
            1, index_keep, 1.0)
        tokens = x.reshape(b, l, c)
        x_masked = torch.where(keep_mask[:, :, None] > 0, tokens,
                               self.mask_token.to(tokens.dtype))
        return x_masked.reshape(b, h, w, c), 1.0 - keep_mask

    def forward_encoder(self, x, noise, train: bool, generator=None,
                        rows=None):
        x, mask = self.window_masking(self.patch_embed(x), noise)
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x, train, generator, rows)
        return x, mask

    def forward_decoder(self, x, train: bool, generator=None, rows=None):
        x = self.first_patch_expanding(x)
        for i in range(self.n - 1):
            x = getattr(self, f"layer_up{i}")(x, train, generator, rows)
        x = self.norm_up(x)
        b, h, w, c = x.shape
        return self.decoder_pred(x.reshape(b, h * w, c).to(self.dtype)).float()

    def forward_loss(self, imgs, pred, mask) -> torch.Tensor:
        """Masked per-patch MSE of patchified ``pred`` [N, L, p^2 C] against
        the images (the reference model's own loss; the trainer uses the
        image-space one)."""
        target = self.patchify(imgs.float())
        if self.norm_pix_loss:
            mean = target.mean(-1, keepdim=True)
            var = target.var(-1, keepdim=True, unbiased=False)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        loss = ((pred - target) ** 2).mean(-1)
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None, rows=None):
        """``noise`` [B, d^2] (this forward's rows) replaces the mask's
        uniform draw: from ``generator``'s seed in train mode (with
        ``rows``, the global batch's draw at this rank's rows), from
        EVAL_MASK_SEED else."""
        x = x.to(self.dtype)
        if noise is None:
            shape = (x.shape[0], self.windows())
            if train:
                noise = _draw(shape, generator, x.device, rows)
            else:
                gen = torch.Generator(device=x.device)
                gen.manual_seed(EVAL_MASK_SEED)
                noise = torch.rand(shape, generator=gen, device=x.device)
        latent, mask = self.forward_encoder(x, noise.to(x.device), train,
                                            generator, rows)
        pred_img = self.unpatchify(self.forward_decoder(latent, train,
                                                        generator, rows))
        rep = self.patch_size ** 2 * self.in_channels
        mask_img = self.unpatchify(mask[:, :, None].repeat(1, 1, rep))
        return pred_img, mask_img
