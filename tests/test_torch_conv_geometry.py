"""The buffer sizes the conv wrappers allocate for the CUDA kernels
(``hpfg_tpu_torch/ops/conv_block.py`` ``conv_tiles`` and ``wgrad_split``)
against a brute-force count, at every conv shape of the full-width UNet's
main paths (224^2 images; batch 24 and 32, and ICT's 12, 16, 20 and 48)
and every channel tile the wgrad kernels use (fp32: 16 x 16/32; bf16: 16/32 x 8/16/32/64);
and at the shapes of the LIDC, ISIC, Synapse and Building configs: the
C = 3 stem, the F = 2 and F = 9 heads, 96^2 images (stages 96 down to 6:
one 8 x 16 tile holds a whole 6 x 6 image) at batches 8, 24, 32 and 40,
224^2 at 8, 24, 32 and 40, and 512^2 at batch 12 (3.1 M pixels a
tensor; its wgrad partials meet the byte cap).

The kernels write one statistics row per output tile and one dW partial row
per block of tiles; a buffer sized by other arithmetic than the kernel's
grid is written out of bounds. No card and no JAX needed.
"""

import functools

import pytest

from hpfg_tpu_torch.ops import conv_block as cb

TILE = (8, 16)  # csrc/conv3x3.cu TH x TW, as hpfg_tile_h/hpfg_tile_w return
# (H=W, C, F) of every conv the UNet's forward and backward launch: the
# ConvBlocks' conv1 and conv2 (an UpBlock's conv1 over its concat), the
# UpBlock 1x1s (run as 3x3), the head, and each dgrad (F -> C)
_FEATS = [16, 32, 64, 128, 256]


def unet_shapes(hw: int, c_in: int, f_out: int) -> list[tuple[int, int, int]]:
    """(H=W, C, F) of every conv of the UNet at ``hw`` with a ``c_in``
    stem and an ``f_out`` head, forward and dgrad."""
    shapes = ({(hw, c_in, 16), (hw, 16, 16), (hw, 16, f_out)}
              | {(hw >> i, _FEATS[i - 1], _FEATS[i]) for i in range(1, 5)}
              | {(hw >> i, _FEATS[i], _FEATS[i]) for i in range(5)}
              | {(hw >> i, 2 * _FEATS[i], _FEATS[i]) for i in range(4)}
              | {(hw >> (i + 1), _FEATS[i + 1], _FEATS[i])
                 for i in range(4)})
    return sorted(shapes | {(h, f, c) for h, c, f in shapes})


SHAPES = unet_shapes(224, 1, 4)
# (batch, H=W, C, F) of the LIDC (96^2, C = 3, F = 2), ISIC (224^2, C = 3,
# F = 2), Synapse (224^2, C = 1, F = 9) and Building (512^2, C = 3, F = 2)
# convs at the batches their configs give them
SHAPES_2D = sorted(
    {(b, *s) for b in (8, 24, 32, 40) for s in unet_shapes(96, 3, 2)}
    | {(b, *s) for b in (8, 24, 32, 40) for s in unet_shapes(224, 3, 2)}
    | {(24, *s) for s in unet_shapes(224, 1, 9)}
    | {(12, *s) for s in unet_shapes(512, 3, 2)})
CHANNEL_TILES = [(16, 16), (16, 32), (16, 8), (16, 64), (32, 8), (32, 16),
                 (32, 32), (32, 64)]


@functools.lru_cache(maxsize=None)
def _image_tiles(h, w):
    return len({(y // TILE[0], x // TILE[1]) for y in range(h)
                for x in range(w)})


def _brute_tiles(b, h, w):
    """Tiles that hold an output pixel: those of one image, counted pixel
    by pixel, times the images."""
    return b * _image_tiles(h, w)


@pytest.mark.parametrize("hw", [224, 112, 56, 28, 14, 20, 7])
@pytest.mark.parametrize("b", [24, 32, 3, 12, 16, 20, 48])
def test_conv_tiles_counts_every_output_tile(b, hw):
    assert cb.conv_tiles(b, hw, hw, TILE) == _brute_tiles(b, hw, hw)


@pytest.mark.parametrize("hw", [96, 48, 24, 12, 6, 512, 256, 128, 64, 32])
@pytest.mark.parametrize("b", [8, 12, 24, 32, 40])
def test_conv_tiles_at_the_2d_dataset_stages(b, hw):
    """96^2 down to 6^2 (a tile of 128 pixels holds 36 of a 6 x 6 image)
    and 512^2 down to 32^2."""
    assert cb.conv_tiles(b, hw, hw, TILE) == _brute_tiles(b, hw, hw)


def _check_wgrad_split(b, hw, c, f):
    """The fewest tiles per block that keep the grid within the target and
    the partials within their byte cap; every tile in exactly one block,
    every partial row used."""
    total = _brute_tiles(b, hw, hw)
    row_bytes = 4 * 9 * c * f
    for cm, bn in CHANNEL_TILES:
        ch_tiles = -(-c // cm) * -(-f // bn)
        per_block = next(
            p for p in range(1, total + 1)
            if p * cb.WGRAD_TARGET_BLOCKS >= total * ch_tiles
            and -(-total // p) * row_bytes <= max(cb.WGRAD_PART_BYTES,
                                                  row_bytes))
        got = cb.wgrad_split(b, hw, hw, c, f, TILE, cm, bn)
        assert got[0] == per_block, (cm, bn)
        blocks = [t // got[0] for t in range(total)]
        assert sorted(set(blocks)) == list(range(got[1]))
        assert max(blocks.count(k) for k in (0, got[1] - 1)) <= got[0]
        assert got[1] * row_bytes <= cb.WGRAD_PART_BYTES


@pytest.mark.parametrize("b", [24, 32, 12, 16, 20, 48])
@pytest.mark.parametrize("hw,c,f", SHAPES)
def test_wgrad_split_matches_a_brute_force_search(b, hw, c, f):
    _check_wgrad_split(b, hw, c, f)


@pytest.mark.parametrize("b,hw,c,f", SHAPES_2D)
def test_wgrad_split_at_the_2d_dataset_shapes(b, hw, c, f):
    """As above, at the LIDC / ISIC / Synapse / Building shapes: the C = 3
    stem (one 16-channel tile with 3 live), the F = 2 and 9 heads, 6^2
    images, and 512^2 at batch 12 (24,576 tiles)."""
    _check_wgrad_split(b, hw, c, f)
