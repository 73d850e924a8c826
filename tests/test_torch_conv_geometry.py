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

import numpy as np
import pytest
import torch

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


# -- K8 and K10 on wgmma (csrc/conv3x3_sm90.cu) -------------------------------

PAIR_CONV_TILE = (8, 32)   # hpfg_pair_conv_tile_h / _w
PAIR_WGRAD_TILE = (8, 16)  # hpfg_pair_wgrad_tile_h / _w
SMS = 132                  # the H100's SMs
# (batch, H=W, Ca, Cb, F) of every UpBlock conv1 on the main paths (ACDC
# 224^2 at batches 12, 20, 24, 32; ISIC 224^2 at 40; LIDC 96^2 at 32;
# Building 512^2 at 12), and of the GPU tests' aligned pair calls (20^2 at
# batch 2, 14^2 and 7^2 at 3, 40^2 at 4: 8 + 24 channels, F = 256)
UPBLOCKS = [(b, hw >> (4 - i), _FEATS[4 - i], _FEATS[4 - i], _FEATS[4 - i])
            for b, hw in ((12, 224), (20, 224), (24, 224), (32, 224),
                          (40, 224), (32, 96), (12, 512))
            for i in range(1, 5)]
PAIR_SHAPES = UPBLOCKS + [(2, 20, 16, 16, 16), (2, 20, 16, 32, 16),
                          (2, 20, 128, 128, 128), (3, 14, 16, 16, 64),
                          (3, 7, 64, 64, 256), (4, 40, 8, 24, 64)]


def _fragment_pixels():
    """K8's warp walk inside an 8 x 32 tile: warpgroup g, warp w, its two
    accumulators i and lane l's halves h hold pixel (2w + i, 16g + l/4 +
    8h) (wgmma's m64 D fragment: warp w's rows 16w.., lane l/4 + 8h)."""
    return [(2 * w + i, 16 * g + lane // 4 + 8 * h)
            for g in range(2) for w in range(4) for i in range(2)
            for lane in range(0, 32, 4) for h in range(2)]


def _n_walk(f, n_tile, n_tiles):
    """The output channels the N tiles' fragments hold: N tile y, n8 block
    j, lane quad q, element e is channel y*n_tile + 8j + 2q + e."""
    return [y * n_tile + 8 * j + 2 * q + e for y in range(n_tiles)
            for j in range(n_tile // 8) for q in range(4) for e in range(2)
            if y * n_tile + 8 * j + 2 * q + e < f]


def _cta_tiles(grid, total):
    runs = [range(i * grid.tiles_per_cta,
                  min((i + 1) * grid.tiles_per_cta, total))
            for i in range(grid.ctas)]
    assert all(len(r) > 0 for r in runs), "a CTA without tiles"
    return runs


@pytest.mark.parametrize("b,hw,ca,cb_,f", PAIR_SHAPES)
def test_pair_conv_walk_covers_every_output_once(b, hw, ca, cb_, f):
    """K8's grid: its CTAs' runs of 8 x 32 tiles and the fragments inside a
    tile hold every output pixel exactly once, its N tiles every channel
    exactly once; one statistics partial row a CTA, each CTA with tiles."""
    g = cb.pair_conv_grid(b, hw, hw, ca, cb_, f, PAIR_CONV_TILE, SMS)
    frag = _fragment_pixels()
    assert sorted(frag) == [(r, c) for r in range(8) for c in range(32)]
    total = cb.conv_tiles(b, hw, hw, PAIR_CONV_TILE)
    count = np.zeros((b, hw, hw), dtype=np.int64)
    for run in _cta_tiles(g, total):
        for t in run:
            bi, ty0, tx0 = cb.pair_tile_origin(t, hw, hw, PAIR_CONV_TILE)
            rows, cols = np.array(frag).T
            keep = (ty0 + rows < hw) & (tx0 + cols < hw)
            np.add.at(count, (bi, ty0 + rows[keep], tx0 + cols[keep]), 1)
    assert (count == 1).all()
    assert sorted(_n_walk(f, g.n_tile, g.n_tiles)) == list(range(f))
    assert g.ctas <= SMS * cb.PAIR_CONV_CTAS_PER_SM or g.tiles_per_cta == 1
    chunks = -(-ca // 16) + -(-cb_ // 16)
    assert g.resident == (chunks * 9 * 16 * g.n_tile * 2
                          <= cb.PAIR_RESIDENT_BYTES)


@pytest.mark.parametrize("b,hw,ca,cb_,f", PAIR_SHAPES)
def test_pair_wgrad_walk_takes_every_pixel_once_per_dw_element(b, hw, ca,
                                                               cb_, f):
    """K10's grid: every (channel block, N tile) of CTAs walks the 8 x 16
    tiles so that each pixel enters K exactly once (its k16 steps: tile
    row y, 16 pixels); every dW element [tap, c, f] of both halves comes
    from exactly one (channel block, warp = group, warpgroup = ky,
    accumulator = kx, N tile) and lane; one partial row a CTA."""
    g = cb.pair_wgrad_grid(b, hw, hw, ca, cb_, f, PAIR_WGRAD_TILE, SMS)
    steps = [(y, x) for y in range(8) for x in range(16)]
    assert sorted(steps) == [(r, c) for r in range(8) for c in range(16)]
    total = cb.conv_tiles(b, hw, hw, PAIR_WGRAD_TILE)
    count = np.zeros((b, hw + 8, hw + 16), dtype=np.int64)
    for run in _cta_tiles(g, total):
        for t in run:
            bi, ty0, tx0 = cb.pair_tile_origin(t, hw, hw, PAIR_WGRAD_TILE)
            count[bi, ty0:ty0 + 8, tx0:tx0 + 16] += 1
    assert (count[:, :hw, :hw] == 1).all()
    groups = -(-ca // 16) + -(-cb_ // 16)
    assert g.channel_blocks == -(-groups // cb.PAIR_WGRAD_GROUPS)
    dw = [np.zeros((9, c, f), dtype=np.int64) for c in (ca, cb_)]
    for blk in range(g.channel_blocks):
        for q in range(cb.PAIR_WGRAD_GROUPS):
            if blk * cb.PAIR_WGRAD_GROUPS + q >= groups:
                continue  # an idle warp
            src, c0 = cb.pair_group(blk * cb.PAIR_WGRAD_GROUPS + q, ca)
            chans = [c0 + lane // 4 + 8 * h for lane in range(0, 32, 4)
                     for h in range(2)]
            chans = [c for c in chans if c < (ca, cb_)[src]]
            fs = _n_walk(f, g.n_tile, g.n_tiles)
            for ky in range(3):
                for kx in range(3):
                    np.add.at(dw[src], (ky * 3 + kx, np.array(chans)[:, None],
                                        np.array(fs)[None, :]), 1)
    assert all((d == 1).all() for d in dw)
    assert g.ctas * g.channel_blocks * g.n_tiles <= \
        SMS * cb.PAIR_WGRAD_CTAS_PER_SM or g.tiles_per_cta == 1


@pytest.mark.parametrize("ca,cb_,f,dtype,aligned,route", [
    # the main paths' UpBlocks (bf16, fresh allocations)
    (16, 16, 16, torch.bfloat16, True, "wgmma"),
    (32, 32, 32, torch.bfloat16, True, "wgmma"),
    (64, 64, 64, torch.bfloat16, True, "wgmma"),
    (128, 128, 128, torch.bfloat16, True, "wgmma"),
    # the GPU tests: test_pair_kernels_match_plain, small stages, sums
    (16, 32, 16, torch.bfloat16, True, "wgmma"),
    (24, 8, 20, torch.bfloat16, True, "mma"),
    (12, 20, 24, torch.bfloat16, True, "mma"),
    (16, 16, 64, torch.bfloat16, True, "wgmma"),
    (64, 64, 256, torch.bfloat16, True, "wgmma"),
    (10, 10, 4, torch.bfloat16, True, "mma"),
    (8, 24, 64, torch.bfloat16, True, "wgmma"),
    # fp32 and unaligned bases stay on the mma.sync kernels
    (128, 128, 128, torch.float32, True, "mma"),
    (16, 16, 16, torch.float32, True, "mma"),
    (64, 64, 64, torch.bfloat16, False, "mma")])
def test_pair_route(ca, cb_, f, dtype, aligned, route):
    assert cb.pair_route(ca, cb_, f, dtype, aligned) == route


@pytest.mark.parametrize("ca", [8, 16, 24, 128])
def test_pair_groups_cover_both_sources(ca):
    """xa's groups first, then xb's, 16 channels each from channel 0."""
    cb_ = 40
    groups = -(-ca // 16) + -(-cb_ // 16)
    got = [cb.pair_group(g, ca) for g in range(groups)]
    assert got == ([(0, 16 * i) for i in range(-(-ca // 16))]
                   + [(1, 16 * i) for i in range(-(-cb_ // 16))])


# -- A and B on wgmma (csrc/conv3x3_sm90.cu) ----------------------------------

CONV_TILES = {False: (8, 32), True: (16, 16)}  # hpfg_conv_sm90_tile_h / _w
# (batch, H=W, C, F) of every A and B call that conv_route sends to wgmma
# (C and F multiples of 8): the ACDC UNet at batches 12 and 32 (14^2 the
# deepest), ISIC at 40, LIDC 96^2 at 32 (down to 6^2), Building 512^2 at 12
SM90_SHAPES = sorted(
    {(b, *s) for b, hw, c_in, f_out in ((12, 224, 1, 4), (32, 224, 1, 4),
                                        (40, 224, 3, 2), (32, 96, 3, 2),
                                        (12, 512, 3, 2))
     for s in unet_shapes(hw, c_in, f_out) if s[1] % 8 == 0 and s[2] % 8 == 0})


def _tall_fragment_pixels():
    """A's warp walk inside a 16 x 16 tile: warpgroup g takes rows 8g..,
    warp w its rows 2w and 2w + 1 (accumulator i), lane l's halves h the
    columns l/4 + 8h."""
    return [(8 * g + 2 * w + i, lane // 4 + 8 * h)
            for g in range(2) for w in range(4) for i in range(2)
            for lane in range(0, 32, 4) for h in range(2)]


@pytest.mark.parametrize("b,hw,c,f", SM90_SHAPES)
def test_conv_walk_covers_every_output_once(b, hw, c, f):
    """A's wgmma grid: the tall 16 x 16 tile at 16 pixels wide and less
    (F >= 32), else 8 x 32; its CTAs' runs of tiles and the fragments
    inside a tile hold every output pixel exactly once, its N tiles every
    channel exactly once; the grid fills the SMs where the N tile allows
    (halved down to 32 or 16), one statistics row a CTA."""
    g = cb.conv_grid(b, hw, hw, c, f, CONV_TILES, SMS)
    assert g.tall == (hw <= cb.CONV_TALL_MAX_W and f >= 32)
    tile = CONV_TILES[g.tall]
    frag = _tall_fragment_pixels() if g.tall else _fragment_pixels()
    assert sorted(frag) == [(r, q) for r in range(tile[0])
                            for q in range(tile[1])]
    total = cb.conv_tiles(b, hw, hw, tile)
    count = np.zeros((b, hw + tile[0], hw + tile[1]), dtype=np.int64)
    for run in _cta_tiles(g, total):
        for t in run:
            bi, ty0, tx0 = cb.pair_tile_origin(t, hw, hw, tile)
            count[bi, ty0:ty0 + tile[0], tx0:tx0 + tile[1]] += 1
    assert (count[:, :hw, :hw] == 1).all()
    assert sorted(_n_walk(f, g.n_tile, g.n_tiles)) == list(range(f))
    least = 32 if g.tall else 16
    full = cb._n_tile(f, 128)
    # halved only while the grid would leave SMs idle, never below least
    assert least <= g.n_tile <= full or g.n_tile == full
    if g.n_tile < full:
        assert total * -(-f // (2 * g.n_tile)) < cb.CONV_MIN_FILL * SMS
    assert g.ctas <= SMS * cb.PAIR_CONV_CTAS_PER_SM or g.tiles_per_cta == 1
    assert g.resident == (-(-c // 16) * 9 * 16 * g.n_tile * 2
                          <= cb.PAIR_RESIDENT_BYTES)


@pytest.mark.parametrize("b,hw,c,f", SM90_SHAPES)
def test_wgrad_walk_takes_every_pixel_once_per_dw_element(b, hw, c, f):
    """B's wgmma grid (one source): every pixel enters K once per (channel
    block, N tile) of CTAs, each dW element [tap, c, f] comes from exactly
    one (channel block, warp, warpgroup, accumulator, N tile) and lane,
    and the fp32 partial rows stay within WGRAD_SM90_PART_RATIO of the
    operands' bytes unless one row (dW itself) exceeds it."""
    g = cb.wgrad_grid(b, hw, hw, c, f, PAIR_WGRAD_TILE, SMS)
    total = cb.conv_tiles(b, hw, hw, PAIR_WGRAD_TILE)
    count = np.zeros((b, hw + 8, hw + 16), dtype=np.int64)
    for run in _cta_tiles(g, total):
        for t in run:
            bi, ty0, tx0 = cb.pair_tile_origin(t, hw, hw, PAIR_WGRAD_TILE)
            count[bi, ty0:ty0 + 8, tx0:tx0 + 16] += 1
    assert (count[:, :hw, :hw] == 1).all()
    groups = -(-c // 16)
    assert g.channel_blocks == -(-groups // cb.PAIR_WGRAD_GROUPS)
    dw = np.zeros((9, c, f), dtype=np.int64)
    fs = np.array(_n_walk(f, g.n_tile, g.n_tiles))
    for grp in range(groups):
        assert cb.pair_group(grp, c) == (0, 16 * grp)
        chans = [16 * grp + lane // 4 + 8 * h for lane in range(0, 32, 4)
                 for h in range(2)]
        chans = np.array([ch for ch in chans if ch < c])
        for tap in range(9):
            np.add.at(dw, (tap, chans[:, None], fs[None, :]), 1)
    assert (dw == 1).all()
    row = 4 * 9 * c * f
    assert g.ctas == 1 or g.ctas * row <= \
        cb.WGRAD_SM90_PART_RATIO * 2 * b * hw * hw * (c + f)
    pair = cb.pair_wgrad_grid(b, hw, hw, c, 0, f, PAIR_WGRAD_TILE, SMS)
    assert g.tiles_per_cta >= pair.tiles_per_cta


@pytest.mark.parametrize("c,f,dtype,aligned,form,route", [
    # the main paths' A calls: conv1 and plain forwards, dgrads, conv2
    (16, 32, torch.bfloat16, True, "conv", "wgmma"),
    (256, 128, torch.bfloat16, True, "conv", "wgmma"),
    (256, 256, torch.bfloat16, True, "prologue", "wgmma"),
    (16, 16, torch.bfloat16, True, "prologue", "wgmma"),
    (32, 16, torch.bfloat16, True, "conv", "wgmma"),
    # B's identity and prologue forms
    (128, 256, torch.bfloat16, True, "wgrad", "wgmma"),
    (64, 64, torch.bfloat16, True, "wgrad_prologue", "wgmma"),
    (32, 32, torch.bfloat16, True, "wgrad_prologue", "wgmma"),
    (8, 24, torch.bfloat16, True, "wgrad", "wgmma"),
    # B's prologue form below WGRAD_PROLOGUE_MIN_C (the 224^2 stage's 16)
    (16, 16, torch.bfloat16, True, "wgrad_prologue", "mma"),
    (16, 16, torch.bfloat16, True, "wgrad", "wgmma"),
    # the C = 1 and C = 3 stems, the F = 4, 2, 9 heads and their dgrads
    (1, 16, torch.bfloat16, True, "conv", "mma"),
    (3, 16, torch.bfloat16, True, "wgrad", "mma"),
    (16, 4, torch.bfloat16, True, "conv", "mma"),
    (2, 16, torch.bfloat16, True, "conv", "mma"),
    (16, 9, torch.bfloat16, True, "wgrad", "mma"),
    # an output dropout mask, fp32, unaligned bases
    (32, 32, torch.bfloat16, True, "out_drop", "mma"),
    (64, 64, torch.float32, True, "conv", "mma"),
    (64, 64, torch.float32, True, "wgrad_prologue", "mma"),
    (64, 64, torch.bfloat16, False, "prologue", "mma")])
def test_conv_route(c, f, dtype, aligned, form, route):
    assert cb.conv_route(c, f, dtype, aligned, form) == route


def test_conv_route_refuses_an_unknown_form():
    with pytest.raises(ValueError):
        cb.conv_route(16, 16, torch.bfloat16, True, "dgrad")


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.bfloat16).view(torch.int16).numpy().astype(np.uint16)


def _prologue_box(x, affine, drop, bi, gy0, gx0, bw, bh, c0):
    """A Python mirror of csrc/conv3x3_sm90.cu's prologue on one halo box:
    TMA's copy of x's channels [c0, c0 + 16) over box pixels (r, col) =
    image pixels (gy0 + r, gx0 + col) of image bi (zeros outside the image
    and past C) into 32-byte-swizzled 16-byte chunks, then prologue_chunk
    on every chunk j: its pixel and channels from un-swizzling its
    address, the transform on in-image channels below C. Returns the box
    read back by halo_byte as [pixels, 16] bf16 bits."""
    _, h, w, c = x.shape
    pix = bh * bw
    p = np.arange(pix)
    gy, gx = gy0 + p // bw, gx0 + p % bw
    inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    raw = np.zeros((pix, 16), dtype=np.uint16)
    xb = _bf16_bits(x[bi])
    for ch in range(16):
        if c0 + ch < c:
            raw[inside, ch] = xb[gy[inside], gx[inside], c0 + ch]
    swz = lambda q, hh: 2 * q + (hh ^ ((q >> 2) & 1))  # noqa: E731
    chunks = np.zeros((2 * pix, 8), dtype=np.uint16)
    for hh in range(2):
        chunks[swz(p, hh)] = raw[:, 8 * hh:8 * hh + 8]
    j = np.arange(2 * pix)
    q = j >> 1
    hh = (j & 1) ^ ((q >> 2) & 1)
    cj = c0 + 8 * hh
    live = inside[q] & (cj < c)
    a, b = (v.numpy() for v in affine)
    for e in range(8):
        jl = j[live]
        cc = cj[live] + e
        v = (chunks[jl, e].astype(np.uint32) << 16).view(np.float32)
        v = np.float32(v * a[cc]) + b[cc]
        v = np.where(v >= 0, v, v * np.float32(0.01)).astype(np.float32)
        if drop is not None:
            img = bi if drop.image_ids is None else int(drop.image_ids[bi])
            lane = torch.from_numpy((gx[q[jl]] * c + cc).astype(np.int64))
            v = v * cb.hash_keep(drop.seed, torch.tensor(img),
                                 torch.from_numpy(gy[q[jl]].astype(np.int64))
                                 * (w * c) + lane, drop.keep).numpy()
        chunks[jl, e] = _bf16_bits(torch.from_numpy(v.astype(np.float32)))
    out = np.zeros((pix, 16), dtype=np.uint16)
    for hh in range(2):
        out[:, 8 * hh:8 * hh + 8] = chunks[swz(p, hh)]
    return out


@pytest.mark.parametrize("bw,bh,gy0,gx0,c0,bi,keep,ids", [
    (18, 18, -1, -1, 0, 0, 0.7, False),   # A's tall box over a whole image
    (34, 10, -1, 15, 16, 1, 0.5, True),   # A's wide box past the right edge
    (34, 10, 7, -1, 0, 1, None, False),   # past the bottom, no dropout
    (18, 10, 3, 3, 16, 0, 0.9, True),     # B's box inside, channels past C
    (18, 10, -1, -1, 16, 1, 0.8, False)])
def test_prologue_box_matches_the_plain_operand(bw, bh, gy0, gx0, c0, bi,
                                                keep, ids):
    """The prologue box's index math (swizzled address to pixel and
    channel, zeros outside the image and past C) against conv3x3_reference's
    operand (``_source``, zero-padded: SAME padding pads the transformed
    input), bit for bit, on an 8 x 20 image of 24 channels (a second group
    half past C)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 8, 20, 24),
                                             dtype=np.float32)).bfloat16()
    affine = (torch.from_numpy(rng.uniform(0.5, 1.5, 24).astype(np.float32)),
              torch.from_numpy(rng.uniform(-0.5, 0.5, 24).astype(np.float32)))
    drop = None
    if keep is not None:
        ids_map = torch.tensor([5, 3], dtype=torch.int32) if ids else None
        drop = cb.HashDropout(4242, keep, ids_map)
    got = _prologue_box(x, affine, drop, bi, gy0, gx0, bw, bh, c0)
    src = cb._source(x, affine, drop).bfloat16()
    pad = torch.zeros((2, 8 + 2 * bh, 20 + 2 * bw, 40), dtype=torch.bfloat16)
    pad[:, bh:bh + 8, bw:bw + 20, :24] = src
    win = pad[bi, bh + gy0:bh + gy0 + bh, bw + gx0:bw + gx0 + bw, c0:c0 + 16]
    assert np.array_equal(got, _bf16_bits(win).reshape(bh * bw, 16))


# -- K9 and K11 on wgmma (csrc/conv3x3_sm90.cu) -------------------------------

BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("f,c,dtype,aligned,form,split,route", [
    # K9 at the main paths' UpBlocks: the cotangent's F -> Ca + Cb
    (16, 32, BF16, True, "dgrad_pair", 16, "wgmma"),
    (32, 64, BF16, True, "dgrad_pair", 32, "wgmma"),
    (64, 128, BF16, True, "dgrad_pair", 64, "wgmma"),
    (128, 256, BF16, True, "dgrad_pair", 128, "wgmma"),
    # the GPU tests' pairs: 8 + 24 (a zero group tail), 12 + 20 and 24 + 8
    # into F = 20 (splits and channels not multiples of 8)
    (64, 32, BF16, True, "dgrad_pair", 8, "wgmma"),
    (24, 32, BF16, True, "dgrad_pair", 12, "mma"),
    (20, 32, BF16, True, "dgrad_pair", 24, "mma"),
    # fp32 and unaligned bases keep PR 4's kernel
    (16, 32, FP32, True, "dgrad_pair", 16, "mma"),
    (128, 256, BF16, False, "dgrad_pair", 128, "mma"),
    # K11 at every ConvBlock's conv2 (C -> C) and the GPU tests' 24 and 20
    (16, 16, BF16, True, "dgrad_reduce", None, "wgmma"),
    (32, 32, BF16, True, "dgrad_reduce", None, "wgmma"),
    (64, 64, BF16, True, "dgrad_reduce", None, "wgmma"),
    (128, 128, BF16, True, "dgrad_reduce", None, "wgmma"),
    (256, 256, BF16, True, "dgrad_reduce", None, "wgmma"),
    (24, 24, BF16, True, "dgrad_reduce", None, "wgmma"),
    (20, 20, BF16, True, "dgrad_reduce", None, "mma"),
    (64, 64, FP32, True, "dgrad_reduce", None, "mma"),
    (64, 64, BF16, False, "dgrad_reduce", None, "mma")])
def test_dgrad_route(f, c, dtype, aligned, form, split, route):
    """K9's and K11's route (``conv_route``'s "dgrad_pair" and
    "dgrad_reduce" forms): wgmma for aligned bf16 calls whose channels
    (and K9's split) are multiples of 8, else PR 4's mma.sync kernel."""
    assert cb.conv_route(f, c, dtype, aligned, form, split) == route


@pytest.mark.parametrize("form,split", [("dgrad_pair", None),
                                        ("dgrad_reduce", 16),
                                        ("conv", 16)])
def test_conv_route_takes_a_split_with_the_pair_form_alone(form, split):
    with pytest.raises(ValueError):
        cb.conv_route(32, 32, BF16, True, form, split)


# (batch, H=W, F, Ca, Cb) of every K9 call on the main paths (the UpBlocks
# of ACDC 224^2 at batches 12, 20, 24, 32, ISIC 224^2 at 40, LIDC 96^2 at
# 32 and Building 512^2 at 12) and of the GPU tests' aligned pairs
K9_SHAPES = sorted(
    {(b, hw >> (4 - i), _FEATS[4 - i], _FEATS[4 - i], _FEATS[4 - i])
     for b, hw in ((12, 224), (20, 224), (24, 224), (32, 224), (40, 224),
                   (32, 96), (12, 512)) for i in range(1, 5)}
    | {(2, 20, 16, 16, 16), (2, 20, 16, 16, 32), (2, 20, 128, 128, 128),
       (2, 20, 64, 8, 24)})


def _k9_writes(ca, cb_, g) -> list[np.ndarray]:
    """How often the wgmma epilogue writes each channel of dxa [Ca] and dxb
    [Cb] for one pixel: N tile y's channels n0 = y * n_tile.. go out as
    64-wide TMA boxes at n_tile >= 64 (box hb at n0 + 64 hb into the half
    it starts in, at its offset there; TMA clips it to that half's
    channels; it must not straddle the split) or from the registers below
    (each fragment's channel pair n, n + 1 < Ca + Cb into dxa below Ca, else
    dxb at n - Ca; a pair must not straddle either)."""
    sizes = (ca, cb_)
    count = [np.zeros(ca, dtype=np.int64), np.zeros(cb_, dtype=np.int64)]
    for y in range(g.n_tiles):
        n0 = y * g.n_tile
        if g.n_tile >= cb.PAIR_STORE_BOX:
            for hb in range(g.n_tile // cb.PAIR_STORE_BOX):
                nb = n0 + hb * cb.PAIR_STORE_BOX
                half = int(nb >= ca)
                assert half or nb + cb.PAIR_STORE_BOX <= ca, "straddles"
                off = nb - ca * half
                count[half][off:min(off + cb.PAIR_STORE_BOX,
                                    sizes[half])] += 1
        else:
            for n in _n_walk(ca + cb_, g.n_tile, g.n_tiles):
                if n // g.n_tile != y or n % 2:
                    continue  # the pair's first channel, this N tile
                half = int(n >= ca)
                assert int(n + 1 >= ca) == half, "a pair straddles"
                count[half][n - ca * half:n - ca * half + 2] += 1
    return count


@pytest.mark.parametrize("b,hw,f,ca,cb_", K9_SHAPES + [(2, 20, 24, 12, 20)])
def test_dgrad_pair_split_writes_every_channel_once(b, hw, f, ca, cb_):
    """K9's wgmma epilogue writes every channel of dxa and dxb exactly once
    for every N tile and store width it uses (the 16 + 16 and 32 + 32
    splits in N tiles of 32 from the registers, 64 + 64 and 128 + 128 in
    N tiles of 128 by 64-wide TMA boxes, one half each), its grid's tiles
    hold every pixel once, and no call trips the launcher's refusal of a
    store box across the split; the odd 12 + 20 split routes to mma."""
    if cb.conv_route(f, ca + cb_, BF16, True, "dgrad_pair", ca) == "mma":
        assert ca % 8 or cb_ % 8 or f % 8
        return
    g = cb.dgrad_pair_grid(b, hw, hw, f, ca, cb_, CONV_TILES, SMS)
    if g.n_tile >= cb.PAIR_STORE_BOX:
        assert ca % cb.PAIR_STORE_BOX == 0 and cb_ % cb.PAIR_STORE_BOX == 0
    assert all((c == 1).all() for c in _k9_writes(ca, cb_, g))
    tile = CONV_TILES[g.tall]
    total = cb.conv_tiles(b, hw, hw, tile)
    count = np.zeros((b, hw + tile[0], hw + tile[1]), dtype=np.int64)
    for run in _cta_tiles(g, total):
        for t in run:
            bi, ty0, tx0 = cb.pair_tile_origin(t, hw, hw, tile)
            count[bi, ty0:ty0 + tile[0], tx0:tx0 + tile[1]] += 1
    assert (count[:, :hw, :hw] == 1).all()


@pytest.mark.parametrize("f,ca,cb_,n_tile", [
    (16, 16, 16, 32), (32, 32, 32, 32), (64, 64, 64, 128),
    (128, 128, 128, 128)])
def test_dgrad_pair_n_tile_at_the_acdc_upblocks(f, ca, cb_, n_tile):
    """K9's N tile at the four ACDC UpBlocks (batch 32): 32 + 32 is capped
    at 32 (two N tiles, one a half) where A's grid would take one of 64
    with a box across the split; 64 + 64 and 128 + 128 take 128."""
    hw = {16: 224, 32: 112, 64: 56, 128: 28}[f]
    g = cb.dgrad_pair_grid(32, hw, hw, f, ca, cb_, CONV_TILES, SMS)
    assert g.n_tile == n_tile
    assert g.n_tiles == -(-(ca + cb_) // n_tile)


def _tma_box(x, b, y0, x0, c0, th, tw, width):
    """A Python mirror of TMA's load of x's box [th rows][tw columns][width
    channels from c0] of image b at (y0, x0) into shared memory as
    conv_sm90_kernel lays it (its own tile, or the output tile at N >= 64):
    box rows of ``width`` bf16 (sw = 2 * width bytes) pixel after pixel,
    16-byte chunk q of byte address A stored at chunk q ^ ((A >> 7) &
    (sw / 16 - 1)) (TMA's 32, 64 or 128-byte swizzle), zeros outside the
    image and past C. Returns the box as bytes."""
    _, h, w, c = x.shape
    sw = 2 * width
    bits = _bf16_bits(x[b])
    box = np.zeros(th * tw * sw, dtype=np.uint8)
    for p in range(th * tw):
        gy, gx = y0 + p // tw, x0 + p % tw
        row = np.zeros(width, dtype=np.uint16)
        if gy < h and gx < w:
            n = max(0, min(width, c - c0))
            row[:n] = bits[gy, gx, c0:c0 + n]
        raw = row.view(np.uint8)
        for q in range(sw // 16):
            addr = p * sw + 16 * q
            phys = p * sw + 16 * (q ^ ((addr >> 7) & (sw // 16 - 1)))
            box[phys:phys + 16] = raw[16 * q:16 * q + 16]
    return box


@pytest.mark.parametrize("bn,tall,b,y0,x0,n0", [
    (16, False, 1, 216, 192, 0),   # 224^2 (C = 16): the last tile row
    (32, False, 0, 104, 96, 0),    # 112^2: past the right edge
    (64, False, 1, 48, 32, 64),    # 56^2, the second N tile of 128
    (128, False, 0, 24, 0, 128),   # 28^2, a 28-row image's last tile row
    (64, True, 1, 0, 0, 192)])     # 14^2 in the tall tile, N tile 4 of 4
def test_k11_pre_tile_addressing_matches_the_plain_operand(bn, tall, b, y0,
                                                           x0, n0):
    """K11's epilogue reads each fragment's pre (channel pair n, n + 1 of
    pixel (oy, ox)) from the TMA-staged box at the swizzled address where
    it writes its output (``off`` in conv_sm90_kernel: 64-wide boxes
    OUT_HALF apart at N >= 64, one box of N below): the value read there
    is the plain residual's, for every in-image pixel and live channel of
    the tile."""
    tile = CONV_TILES[tall]
    th, tw = tile
    hw = {16: 224, 32: 112, 64: 56 if not tall else 14, 128: 28}[bn]
    c = 256 if tall else max(bn, n0 + bn)
    rng = np.random.default_rng(bn)
    pre = torch.from_numpy(rng.standard_normal((2, hw, hw, c),
                                               dtype=np.float32)).bfloat16()
    bnb = min(bn, 64)
    sw = 2 * bnb
    half = th * tw * sw  # OUT_HALF
    smem = np.concatenate([_tma_box(pre, b, y0, x0, n0 + hb * bnb, th, tw,
                                    bnb) for hb in range(bn // bnb)])
    bits = _bf16_bits(pre[b])
    seen = 0
    for g in range(2):
        r0, q0 = (8 * g, 0) if tall else (0, 16 * g)
        for w in range(4):
            for lane in range(32):
                for j in range(bn // 8):
                    col = 8 * j + 2 * (lane & 3)
                    for i in range(2):
                        rr = r0 + 2 * w + i
                        for h in range(2):
                            px = q0 + (lane >> 2) + 8 * h
                            oy, ox, n = y0 + rr, x0 + px, n0 + col
                            if oy >= hw or ox >= hw or n >= c:
                                continue
                            pix = rr * tw + px
                            hc = (col % bnb) >> 3
                            off = ((col // bnb) * half + pix * sw
                                   + ((hc ^ ((pix * sw >> 7)
                                             & (sw // 16 - 1))) << 4)
                                   + (col & 7) * 2)
                            got = smem[off:off + 4].view(np.uint16)
                            assert list(got) == list(bits[oy, ox, n:n + 2])
                            seen += 1
    assert seen > 0
