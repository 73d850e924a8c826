"""The walk of the window-attention kernels K13 and K14
(``hpfg_tpu_torch/ops/window_attention.py`` ``attention_walk``) against a
brute-force check, at every window-attention shape of the full-width
SwinUNet and Swin-MAE (224^2, window 7: Bn = batch x 64, 16, 4, 1 windows
of 3, 6, 12, 24 heads, shifted or not; Swin-MAE trains at batch 24 over
every window, masked tokens included), at those of the LIDC SwinUNet
(``swinunet_lidc``: 96^2, patch 2, window 3, so L = 9 and Bn = batch x
256, 64, 16, 4 windows; shifted by 1, whose masks give 256, 64, 16 and 4
mask classes) and at the shapes of the GPU tests.

The kernels run a grid of (CTAs, heads); each CTA walks a run of windows
of one head and writes one dbias partial row. A window left out is never
computed, a window walked twice is written twice and summed twice into
dbias, and a partial buffer sized by other arithmetic than the grid is
written out of bounds. No card and no JAX needed.
"""

import pytest

from hpfg_tpu_torch.ops import window_attention as wa

SM_COUNT = 132  # H100 SXM
# (Bn, heads, n_mask): the SwinUNet's stages at 224^2 for the batches it
# sees (8 labelled + 24 unlabelled in training, the teacher's 24, eval
# slices; Swin-MAE's 24 and its panels' 1), unshifted (n_mask 1) and
# shifted (the stage's nW windows)
_STAGES = [(64, 3), (16, 6), (4, 12), (1, 24)]
SWIN = sorted({(b * nw, h, m) for b in (1, 2, 8, 24, 32)
               for nw, h in _STAGES for m in {1, nw}})
# the LIDC SwinUNet's stages (48^2 tokens, window 3) at its train batch 24
# and the eval chunks of its test loader (16 and 8), and one image
_LIDC_STAGES = [(256, 3), (64, 6), (16, 12), (4, 24)]
LIDC = sorted({(b * nw, h, m) for b in (1, 8, 16, 24)
               for nw, h in _LIDC_STAGES for m in {1, nw}})
# the shapes tests/test_torch_gpu_kernels.py and chip_smoke.py give them
GPU = [(6, 3, 3), (6, 3, 1), (19, 3, 1), (2048, 3, 64), (2048, 3, 1),
       (512, 6, 16), (8, 2, 4), (19, 2, 1), (40, 2, 1), (6, 2, 1),
       (2048, 2, 1), (19, 4, 1), (7, 1, 7), (1536, 3, 64), (384, 6, 16),
       (96, 12, 4), (24, 24, 1)]


@pytest.mark.parametrize("bn,heads,n_mask", SWIN + LIDC + GPU)
def test_walk_covers_every_window_once(bn, heads, n_mask):
    walk = wa.attention_walk(bn, heads, n_mask)
    assert walk.windows_per_cta >= 1
    runs = [walk.windows(x) for x in range(walk.ctas)]
    # every (window, head) in exactly one CTA: the heads are the grid's
    # second axis, so each window in exactly one run
    walked = sorted(w for run in runs for w in run)
    assert walked == list(range(bn))
    for run in runs:
        assert 1 <= len(run) <= walk.windows_per_cta
        # one mask class per CTA: the CTA reads mask[w % n_mask] once
        assert len({w % n_mask for w in run}) == 1
    # one dbias partial row per CTA (each row holds the H heads' slices)
    assert walk.ctas == len(runs)


@pytest.mark.parametrize("bn,heads,n_mask", SWIN + LIDC)
def test_walk_fills_the_card(bn, heads, n_mask):
    """Runs as short as the target allows: the grid reaches the target CTA
    count or every CTA walks one window, and never asks for a run that the
    target does not need."""
    walk = wa.attention_walk(bn, heads, n_mask)
    pairs = bn * heads
    assert walk.ctas * heads >= min(pairs, SM_COUNT, wa.TARGET_CTAS)
    if walk.windows_per_cta > 1:
        assert (walk.windows_per_cta - 1) * wa.TARGET_CTAS < pairs


def test_stage3_call_fills_132_sms():
    """The last stage (Bn = 32 windows of 24 heads: 768 pairs) keeps one
    window per CTA, 768 CTAs."""
    walk = wa.attention_walk(32, 24, 1)
    assert (walk.windows_per_cta, walk.ctas * 24) == (1, 768)


@pytest.mark.parametrize("side", [48, 24, 12, 6])
def test_lidc_shift_masks_have_one_class_per_window(side):
    """Window 3 shifted by 1 on a side x side token grid: the mask has one
    [9, 9] slice per window (side / 3)^2, each symmetric with a zero
    diagonal; the walk's class r = w % n_mask picks the window's slice."""
    import numpy as np

    from hpfg_tpu_torch.models.swinunet import _shift_attention_mask

    mask = _shift_attention_mask(side, side, 3, 1)
    n = (side // 3) ** 2
    assert mask.shape == (n, 9, 9)
    assert set(np.unique(mask)) <= {0.0, -100.0}
    assert (mask == mask.transpose(0, 2, 1)).all()
    assert not mask[:, np.arange(9), np.arange(9)].any()
    # the windows that straddle the roll's seam (the last row or column of
    # windows) are masked, the others are not
    g = side // 3
    seam = {r * g + c for r in range(g) for c in range(g)
            if r == g - 1 or c == g - 1}
    assert {w for w in range(n) if mask[w].any()} == seam


# ---------------------------------------------------------------------------
# the wgmma route (csrc/window_attention_sm90.cu): its route rule, its
# packed walk and K14's dbias groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,l,aligned,route", [
    ("bfloat16", 32, 49, True, "wgmma"),   # the SwinUNets' calls
    ("bfloat16", 32, 9, True, "wgmma"),
    ("bfloat16", 16, 16, True, "wgmma"),
    ("bfloat16", 64, 64, True, "wgmma"),
    ("bfloat16", 32, 49, False, "mma"),    # a base TMA cannot take
    ("bfloat16", 8, 49, True, "mma"),      # 16-byte rows: no swizzle width
    ("bfloat16", 12, 16, True, "mma"),
    ("bfloat16", 40, 16, True, "mma"),
    ("bfloat16", 48, 49, True, "mma"),     # 96-byte rows: no swizzle width
    ("bfloat16", 32, 65, True, "mma"),     # past one 64-row tile
    ("float32", 32, 49, True, "mma"),      # fp32 keeps the CUDA cores
    ("float32", 64, 9, True, "mma"),
])
def test_attn_route(dtype, d, l, aligned, route):
    import torch

    assert wa.attn_route(getattr(torch, dtype), d, l, aligned) == route


# (L, the walks' window counts): the SwinUNet's and Swin-MAE's window 7,
# the LIDC SwinUNet's window 3, and L = 16 and 25 over both
PACKED = sorted({(l, bn, heads, m) for l in (9, 16, 25, 49)
                 for bn, heads, m in SWIN + LIDC})


@pytest.mark.parametrize("l,bn,heads,n_mask", PACKED)
def test_packed_walk_covers_every_window_once(l, bn, heads, n_mask):
    """Every window lands in exactly one slot of one tile (the heads are
    the grid's second axis), all windows of a tile share one mask class
    and are consecutive in it, a tile packs G = 64 // L of them (the last
    of a class may hold fewer; TMA reads zeros past it), and every CTA of
    the grid walks at least one tile, none twice."""
    walk = wa.packed_walk(bn, heads, n_mask, l,
                          wa.sm90_target(False, 32, SM_COUNT))
    assert walk.g == min(64 // l, bn // n_mask) and walk.g * l <= 64
    slots = [walk.slots(t) for t in range(walk.tiles)]
    assert sorted(w for s in slots for w in s) == list(range(bn))
    for s in slots:
        assert 1 <= len(s) <= walk.g
        assert len({w % n_mask for w in s}) == 1
        assert [w // n_mask for w in s] == list(range(
            s[0] // n_mask, s[0] // n_mask + len(s)))
    walked = [t for x in range(walk.ctas) for t in walk.tiles_of(x)]
    assert walked == list(range(walk.tiles))
    assert all(len(walk.tiles_of(x)) >= 1 for x in range(walk.ctas))


@pytest.mark.parametrize("l,bn,heads,n_mask", PACKED)
def test_packed_walk_dbias_groups(l, bn, heads, n_mask):
    """K14's dbias partials a head: one row a CTA, about three CTAs an SM
    over the heads (or one a tile), in groups of 8 whose last CTA sums
    the group and whose group rows the last closer sums: every CTA's row
    in exactly one group, at most 8 rows a group and ceil(ctas / 8) group
    rows."""
    target = wa.sm90_target(True, 32, SM_COUNT)
    walk = wa.packed_walk(bn, heads, n_mask, l, target)
    assert walk.ctas <= walk.tiles
    assert walk.ctas * heads <= target + heads
    assert walk.ctas * heads >= min(walk.tiles * heads, SM_COUNT) or \
        walk.tiles_per_cta == 1
    groups = [list(range(g * walk.group, min((g + 1) * walk.group,
                                             walk.ctas)))
              for g in range(walk.groups)]
    assert sorted(x for grp in groups for x in grp) == list(range(walk.ctas))
    assert all(1 <= len(grp) <= 8 for grp in groups)


# the dbias partial rows a head at the stage shapes of the main paths
# (batch, stage side, heads, window, shifted) on an H100's 132 SMs (K14 at
# D = 32: three CTAs an SM): CTAs and group rows
STAGE_PARTIALS = [
    (32, 56, 3, 7, True, 128, 16), (32, 56, 3, 7, False, 128, 16),
    (32, 28, 6, 7, True, 64, 8), (32, 14, 12, 7, True, 32, 4),
    (32, 7, 24, 7, False, 16, 2), (24, 56, 3, 7, True, 128, 16),
    (24, 7, 24, 7, False, 12, 2), (24, 48, 3, 3, True, 128, 16),
    (24, 24, 6, 3, True, 64, 8), (24, 12, 12, 3, True, 32, 4),
    (24, 6, 24, 3, True, 16, 2)]


@pytest.mark.parametrize("batch,side,heads,ws,shifted,ctas,groups",
                         STAGE_PARTIALS)
def test_dbias_partials_at_the_stage_shapes(batch, side, heads, ws, shifted,
                                            ctas, groups):
    nw = (side // ws) ** 2
    walk = wa.packed_walk(batch * nw, heads, nw if shifted else 1, ws * ws,
                          wa.sm90_target(True, 32, SM_COUNT))
    assert (walk.ctas, walk.groups) == (ctas, groups)
    assert walk.ctas * heads <= wa.sm90_target(True, 32, SM_COUNT) + heads


@pytest.mark.parametrize("l", [9, 16, 25, 49])
@pytest.mark.parametrize("shifted", [False, True])
def test_packed_tile_softmax_is_block_diagonal(l, shifted):
    """The packed tile's score term (``tile_bias``: bias[h] + mask[r] down
    the diagonal, -inf between windows) makes the softmax of a 64-row tile
    of G windows the per-window softmax of each, and exactly 0 between
    windows."""
    import torch

    gen = torch.Generator().manual_seed(l)
    g = 64 // l
    bias = torch.randn((l, l), generator=gen) * 0.5
    mask = (torch.where(torch.randn((l, l), generator=gen) > 0.8, -100.0,
                        0.0) if shifted else None)
    s = torch.randn((64, 64), generator=gen)
    p = torch.softmax(s + wa.tile_bias(bias, mask, l, g), dim=-1)
    block = bias + (0 if mask is None else mask)
    for w in range(g):
        rows = slice(w * l, (w + 1) * l)
        want = torch.softmax(s[rows, rows] + block, dim=-1)
        assert torch.allclose(p[rows, rows], want, rtol=1e-6, atol=1e-7)
        off = torch.ones(64, dtype=torch.bool)
        off[rows] = False
        assert not p[rows][:, off].any()
