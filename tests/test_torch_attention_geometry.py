"""The walk of the window-attention kernels K13 and K14
(``hpfg_tpu_torch/ops/window_attention.py`` ``attention_walk``) against a
brute-force check, at every window-attention shape of the full-width
SwinUNet and Swin-MAE (224^2, window 7: Bn = batch x 64, 16, 4, 1 windows
of 3, 6, 12, 24 heads, shifted or not; Swin-MAE trains at batch 24 over
every window, masked tokens included) and at the shapes of the GPU
tests.

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
# the shapes tests/test_torch_gpu_kernels.py and chip_smoke.py give them
GPU = [(6, 3, 3), (6, 3, 1), (19, 3, 1), (2048, 3, 64), (2048, 3, 1),
       (512, 6, 16), (8, 2, 4), (19, 2, 1), (40, 2, 1), (6, 2, 1),
       (2048, 2, 1), (19, 4, 1), (7, 1, 7), (1536, 3, 64), (384, 6, 16),
       (96, 12, 4), (24, 24, 1)]


@pytest.mark.parametrize("bn,heads,n_mask", SWIN + GPU)
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


@pytest.mark.parametrize("bn,heads,n_mask", SWIN)
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
