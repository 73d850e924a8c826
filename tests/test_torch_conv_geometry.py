"""The buffer sizes the conv wrappers allocate for the CUDA kernels
(``hpfg_tpu_torch/ops/conv_block.py`` ``conv_tiles`` and ``wgrad_split``)
against a brute-force count, at every conv shape of the full-width UNet's
main path (224^2 images, batch 24 and 32) and every channel tile the wgrad
kernels use (fp32: 16 x 16/32; bf16: 16/32 x 8/16/32/64).

The kernels write one statistics row per output tile and one dW partial row
per block of tiles; a buffer sized by other arithmetic than the kernel's
grid is written out of bounds. No card and no JAX needed.
"""

import pytest

from hpfg_tpu_torch.ops import conv_block as cb

TILE = (8, 16)  # csrc/conv3x3.cu TH x TW, as hpfg_tile_h/hpfg_tile_w return
# (H=W, C, F) of every conv the UNet's forward and backward launch: the
# ConvBlocks' conv1 and conv2 (an UpBlock's conv1 over its concat), the
# UpBlock 1x1s (run as 3x3), the head, and each dgrad (F -> C)
_FEATS = [16, 32, 64, 128, 256]
_SHAPES = sorted(
    {(224, 1, 16), (224, 16, 16), (224, 16, 4)}
    | {(224 >> i, _FEATS[i - 1], _FEATS[i]) for i in range(1, 5)}
    | {(224 >> i, _FEATS[i], _FEATS[i]) for i in range(5)}
    | {(224 >> i, 2 * _FEATS[i], _FEATS[i]) for i in range(4)}
    | {(224 >> (i + 1), _FEATS[i + 1], _FEATS[i]) for i in range(4)})
SHAPES = sorted(set(_SHAPES) | {(h, f, c) for h, c, f in _SHAPES})
CHANNEL_TILES = [(16, 16), (16, 32), (16, 8), (16, 64), (32, 8), (32, 16),
                 (32, 32), (32, 64)]


def _brute_tiles(b, h, w):
    return len({(i, y // TILE[0], x // TILE[1]) for i in range(b)
                for y in range(h) for x in range(w)})


@pytest.mark.parametrize("hw", [224, 112, 56, 28, 14, 20, 7])
@pytest.mark.parametrize("b", [24, 32, 3])
def test_conv_tiles_counts_every_output_tile(b, hw):
    assert cb.conv_tiles(b, hw, hw, TILE) == _brute_tiles(b, hw, hw)


@pytest.mark.parametrize("b", [24, 32])
@pytest.mark.parametrize("hw,c,f", SHAPES)
def test_wgrad_split_matches_a_brute_force_search(b, hw, c, f):
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
