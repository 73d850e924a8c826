"""The port's hand-written kernels (A conv3x3_nhwc, B conv3x3_wgrad_nhwc,
C bn_act, D bn_act_bwd and bn_act_dpre, K8 conv3x3_pair_nhwc, K9
conv3x3_dgrad_pair, K10 conv3x3_wgrad_pair, K11 conv3x3_dgrad_reduce, K13
window_attention_fwd, K14 window_attention_bwd) against their plain PyTorch
versions on a CUDA card, at small ragged shapes (20x20 images do not fill
the 8x16 tiles; channel splits that are not multiples of the 16-channel
tile; windows of 9, 16, 49 and 64 tokens, head widths of 8 to 64 (not all
multiples of the 16-wide MMA step, one not a multiple of the 8-element
copy piece), window counts that are not multiples of the hash's 16-window
block).

Marked ``gpu``: without a card every test skips. On the card (which has no
jax, so the JAX-side conftest is left out):

    python -m pytest tests/test_torch_gpu_kernels.py -q --noconftest -m gpu

Tolerances, relative to the reference's largest magnitude: fp32 1e-4
(another summation order), bf16 2e-2 (bf16 rounding of outputs that were
summed in another order); D's sums, fp32 sums of the same inputs in both
dtypes, 1e-4. Hash dropout masks (the ConvBlock's and the attention's,
forward and backward, in fp32 and bf16) are bit-exact, and
the attention's output and bias gradient are bitwise the same from run to
run. C, and D's dpre from given sums, round as their plain versions and
are bitwise equal to them; D's sums are bitwise the same from run to run.

Beside the kernels: A and D at the supervised path's batch of 24 at 224^2
and 14^2; A to D and K8 to K11 at the LIDC, ISIC and Building shapes (the
C = 3 stem, 96^2 stages down to 6^2, 512^2 at batch 12), the F = 2 and
F = 9 heads, and K13 and K14 at the LIDC SwinUNet's window 3 (L = 9) with
its shift-by-1 masks; A's dgrad into F = 1 and F = 3 output channels (SS-Net's VAT
differentiates the model with respect to its 1-channel image, so the
stem's input gradient runs); A to D and K8 to K10 at ICT's batches 12 and
20; K13 and K14 at Swin-MAE's batch 24; the ConvBlock and plain-conv
Functions with frozen weights launching no weight-gradient kernel (B, K10)
while their input gradients stay those of the full backward; and the
SegFormer B0 (no hand-written kernel: cuDNN convs and
cuBLAS matmuls) in train mode, forward and backward on the card against
the same module on the CPU, with the same tolerances.
"""

import copy

import pytest
import torch

from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.models.segformer import BN_INVARIANT
from hpfg_tpu_torch.ops import bn_act as ba
from hpfg_tpu_torch.ops import conv_block as cb
from hpfg_tpu_torch.ops import window_attention as wa

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(dev, *shape, scale=1.0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed + sum(shape))
    return torch.randn(shape, generator=gen, device=dev) * scale


def _close(got, ref, dtype):
    got, ref = got.float(), ref.float().to(got.device)
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,f,prologue", [(1, 16, False), (16, 32, True),
                                          (40, 20, True), (4, 16, False),
                                          (16, 4, False), (24, 136, True)])
def test_conv3x3_matches_plain(dev, dtype, c, f, prologue):
    x = _randn(dev, 2, 20, 20, c).to(dtype)
    w = _randn(dev, 3, 3, c, f, scale=(9 * c) ** -0.5).to(dtype)
    kw = dict(bias=_randn(dev, f, scale=0.1), want_stats=True)
    if prologue:
        kw.update(affine=(1 + _randn(dev, c, scale=0.1),
                          _randn(dev, c, scale=0.1)),
                  drop=cb.HashDropout(7, 0.8))
    y, st = cb.conv3x3_nhwc(x, w, **kw)
    y_r, st_r = cb.conv3x3_reference(x, w, **kw)
    _close(y, y_r, dtype)
    _close(st, st_r, dtype)
    dp = _randn(dev, 2, 20, 20, f).to(dtype)
    wf = cb.flip_transpose(w)
    out_drop = kw.get("drop")
    _close(cb.conv3x3_nhwc(dp, wf, out_drop=out_drop)[0],
           cb.conv3x3_reference(dp, wf, out_drop=out_drop)[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,f,act", [(1, 16, False), (16, 32, True),
                                     (40, 20, True), (4, 16, False),
                                     (16, 4, False), (48, 72, True)])
def test_wgrad_matches_plain(dev, dtype, c, f, act):
    src = _randn(dev, 2, 20, 20, c).to(dtype)
    dp = _randn(dev, 2, 20, 20, f).to(dtype)
    kw = {}
    if act:
        kw = dict(affine=(1 + _randn(dev, c, scale=0.1),
                          _randn(dev, c, scale=0.1)),
                  drop=cb.HashDropout(9, 0.7))
    _close(cb.conv3x3_wgrad_nhwc(src, dp, **kw),
           cb.conv3x3_wgrad_reference(src, dp, **kw), dtype)


def _bn_inputs(dev, dtype, shape, seed=0):
    f = shape[-1]
    g = _randn(dev, *shape, seed=seed).to(dtype)
    dy = _randn(dev, *shape, seed=seed + 1).to(dtype)
    a, b = 1 + _randn(dev, f, scale=0.1), _randn(dev, f, scale=0.1, seed=1)
    m, inv = _randn(dev, f, scale=0.1, seed=2), 1 + _randn(dev, f).abs()
    return g, dy, a, b, m, inv


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [4, 12, 16, 20, 48, 256, 300])
def test_bn_act_and_bwd_match_plain(dev, dtype, f):
    """C bitwise equal to its plain version; D within tolerance. P = 800
    rows is not a multiple of any CTA's rows a turn; F = 4, 12, 20 and 300
    in bf16 take the element path, and F = 300 there has 300 channel
    groups, more than a CTA's 256: two chunks of the grid's y."""
    g, dy, a, b, m, inv = _bn_inputs(dev, dtype, (2, 20, 20, f))
    assert torch.equal(ba.bn_act(g, a, b), ba.bn_act_reference(g, a, b))
    s, d = ba.bn_act_bwd(dy, g, a, b, m, inv)
    s_r, d_r = ba.bn_act_bwd_reference(dy, g, a, b, m, inv)
    _close(s, s_r, torch.float32)
    _close(d, d_r, dtype)
    # dpre from given sums rounds as the plain version: bitwise equal
    assert torch.equal(ba.bn_act_dpre(dy, g, a, b, m, inv, s_r),
                       ba.bn_act_dpre_reference(dy, g, a, b, m, inv, s_r))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [4, 16, 256])
def test_bn_dpre_branch_is_exact(dev, dtype, f):
    """Zero sums, mean 0 and inv 0: dpre = a*dz, with dz = dy or 0.01*dy by
    the sign of z = a*pre + b. A few pre values put z exactly on 0 and one
    step to either side; the kernel must take the plain version's branch at
    every element (an FMA-contracted z would not)."""
    g, dy, a, b, _, _ = _bn_inputs(dev, dtype, (2, 20, 20, f))
    b = (-a * g[0, 0, 0].float()).contiguous()  # z = fl(fl(a*p0) + b) = 0
    p0 = g[0, 0, 0].cpu()
    for i, to in ((1, float("inf")), (2, -float("inf"))):
        g[0, 0, i] = torch.nextafter(p0, torch.full_like(p0, to)).to(dev)
    zeros = torch.zeros(f, device=dev)
    sums = torch.zeros(2, f, device=dev)
    got = ba.bn_act_dpre(dy, g, a, b, zeros, zeros, sums)
    ref = ba.bn_act_dpre_reference(dy, g, a, b, zeros, zeros, sums)
    assert torch.equal(got, ref)
    assert torch.equal(ba.bn_act(g, a, b), ba.bn_act_reference(g, a, b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_reduce_last_cta_finish_is_reproducible(dev, dtype):
    """A P that gives every reduce CTA several steps, run three times back
    to back: the sums bitwise the same each time (the last CTA sums the
    partials in a fixed order and resets the device's counter), within
    tolerance of the plain version."""
    g, dy, a, b, m, inv = _bn_inputs(dev, dtype, (16, 112, 112, 32))
    runs = [ba.bn_act_bwd(dy, g, a, b, m, inv) for _ in range(3)]
    # the walk the wrapper launched: several turns a CTA
    _, w = ba._walk(True, dy, tuple(t.data_ptr() for t in
                                    (dy, g, a, b, m, inv)))
    assert w.turns > 2 * w.ctas
    for s, d in runs[1:]:
        assert torch.equal(s, runs[0][0])
        assert torch.equal(d, runs[0][1])
    s_r, d_r = ba.bn_act_bwd_reference(dy, g, a, b, m, inv)
    _close(runs[0][0], s_r, torch.float32)
    _close(runs[0][1], d_r, dtype)
    assert int(ba._counter(dev).item()) == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [16, 48])
def test_bn_element_path_on_misaligned_views(dev, dtype, f):
    """Tensors that start one element past a 16-byte boundary take the
    element path (contiguous views of a larger buffer) and agree with the
    plain version: C bitwise, D within tolerance."""
    n = 2 * 20 * 20 * f

    def shifted(t):
        buf = torch.empty(n + 1, device=dev, dtype=dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    g, dy, a, b, m, inv = _bn_inputs(dev, dtype, (2, 20, 20, f))
    gs, dys = shifted(g), shifted(dy)
    assert torch.equal(ba.bn_act(gs, a, b), ba.bn_act_reference(g, a, b))
    s, d = ba.bn_act_bwd(dys, gs, a, b, m, inv)
    s_r, d_r = ba.bn_act_bwd_reference(dy, g, a, b, m, inv)
    _close(s, s_r, torch.float32)
    _close(d, d_r, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ca,cu,f", [(16, 16, 16), (16, 32, 16),
                                     (24, 8, 20), (12, 20, 24),
                                     (128, 128, 128)])
def test_pair_kernels_match_plain(dev, dtype, ca, cu, f):
    """K8 (forward + statistics), K9 (both input gradients) and K10 (both
    weight gradients) against their plain versions."""
    xa = _randn(dev, 2, 20, 20, ca).to(dtype)
    xb = _randn(dev, 2, 20, 20, cu, seed=1).to(dtype)
    w = _randn(dev, 3, 3, ca + cu, f, scale=(9 * (ca + cu)) ** -0.5).to(dtype)
    bias = _randn(dev, f, scale=0.1)
    y, st = cb.conv3x3_pair_nhwc(xa, xb, w, bias, want_stats=True)
    y_r, st_r = cb.conv3x3_pair_reference(xa, xb, w, bias, want_stats=True)
    _close(y, y_r, dtype)
    _close(st, st_r, dtype)
    dp = _randn(dev, 2, 20, 20, f, seed=2).to(dtype)
    wf = cb.flip_transpose(w)
    for got, ref in zip(cb.conv3x3_dgrad_pair(dp, wf, ca),
                        cb.conv3x3_dgrad_pair_reference(dp, wf, ca)):
        assert got.is_contiguous()
        _close(got, ref, dtype)
    for got, ref in zip(cb.conv3x3_wgrad_pair(xa, xb, dp),
                        cb.conv3x3_wgrad_pair_reference(xa, xb, dp)):
        _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,f,keep", [(16, 16, 0.8), (32, 16, None),
                                      (20, 40, 0.5)])
def test_dgrad_reduce_and_dpre_match_plain(dev, dtype, c, f, keep):
    """K11 (dgrad x dropout mask with the BN-backward reduce epilogue) and
    D's dpre-only entry against their plain versions."""
    dp = _randn(dev, 2, 20, 20, f).to(dtype)
    w = _randn(dev, 3, 3, c, f, scale=(9 * c) ** -0.5).to(dtype)
    pre = _randn(dev, 2, 20, 20, c, seed=1).to(dtype)
    a, b = 1 + _randn(dev, c, scale=0.1), _randn(dev, c, scale=0.1, seed=1)
    m, inv = _randn(dev, c, scale=0.1, seed=2), 1 + _randn(dev, c).abs()
    drop = None if keep is None else cb.HashDropout(5, keep)
    wf = cb.flip_transpose(w)
    dd, s = cb.conv3x3_dgrad_reduce(dp, wf, pre, a, b, m, inv, out_drop=drop)
    dd_r, s_r = cb.conv3x3_dgrad_reduce_reference(dp, wf, pre, a, b, m, inv,
                                                  out_drop=drop)
    _close(dd, dd_r, dtype)
    _close(s, s_r, dtype)
    _close(ba.bn_act_dpre(dd, pre, a, b, m, inv, s),
           ba.bn_act_dpre_reference(dd, pre, a, b, m, inv, s), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pair", [False, True])
def test_block_backward_matches_plain(dev, dtype, pair):
    """The ConvBlock backward on kernels against the same backward on the
    CPU (plain versions), from the same forward residuals; with a pair
    input (16 + 16 channels) it runs K8 to K11."""
    c, f = 16, 32
    p = [_randn(dev, 3, 3, c, f, scale=(9 * c) ** -0.5),
         _randn(dev, f, scale=0.1), 1 + _randn(dev, f, scale=0.1, seed=1),
         _randn(dev, f, scale=0.1, seed=2),
         _randn(dev, 3, 3, f, f, scale=(9 * f) ** -0.5),
         _randn(dev, f, scale=0.1, seed=3), 1 + _randn(dev, f, scale=0.1,
                                                       seed=4),
         _randn(dev, f, scale=0.1, seed=5)]
    x = _randn(dev, 2, 20, 20, c).to(dtype)
    dy = _randn(dev, 2, 20, 20, f, seed=6).to(dtype)
    drop = cb.HashDropout(11, 0.9)
    if pair:
        x = (x[..., :8].contiguous(), x[..., 8:].contiguous())
    y, st, res = cb.block_forward(x, *p, None, True, drop)
    y_r, st_r, _ = cb.block_forward(_cpu(x), *(t.cpu() for t in p), None,
                                    True, drop)
    _close(y, y_r, dtype)
    args = (p[2], p[3], p[6], p[7])
    got = cb.block_backward(dy, res, *args, st, drop)
    ref = cb.block_backward(dy.cpu(), [_cpu(t) for t in res],
                            *(t.cpu() for t in args),
                            [t.cpu() for t in st], drop)
    for g, r in zip(got, ref):
        for gi, ri in zip(*((g, r) if pair and isinstance(g, tuple)
                            else ((g,), (r,)))):
            _close(gi, ri, dtype)


def _cpu(t):
    return tuple(u.cpu() for u in t) if isinstance(t, tuple) else t.cpu()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("keep", [0.95, 0.5])
def test_kernel_hash_masks_are_bit_exact(dev, keep, dtype):
    """An all-ones input through the prologue a = 1, b = 0 and a centre-tap
    identity conv outputs the mask itself: one product each, so in bf16 it
    is the fp32 mask rounded to bf16, bit for bit."""
    c = 24
    x = torch.ones((3, 20, 20, c), device=dev, dtype=dtype)
    eye = torch.zeros((3, 3, c, c), device=dev, dtype=dtype)
    eye[1, 1] = torch.eye(c, device=dev, dtype=dtype)
    drop = cb.HashDropout(1234, keep)
    ref = cb.hash_mask(drop.seed, 3, 20, 20 * c, keep, dev).view(
        3, 20, 20, c).to(dtype)
    ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    assert torch.equal(cb.conv3x3_nhwc(x, eye, affine=(ones, zeros),
                                       drop=drop)[0], ref)
    assert torch.equal(cb.conv3x3_nhwc(x, eye, out_drop=drop)[0], ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,c,f", [(14, 32, 64), (7, 128, 256),
                                    (14, 1, 16), (28, 20, 4)])
def test_conv_forms_at_small_stages(dev, dtype, hw, c, f):
    """Images smaller than or ragged against the 8x16 tile (the UNet's 14^2
    and 28^2 stages, a 7^2 one), with the stem's C = 1 and the head's F = 4:
    A with its prologue and statistics, A's dgrad with the output mask, B,
    and the pair kernels K8-K10 split at c // 2 (not a multiple of 16)."""
    x = _randn(dev, 3, hw, hw, c).to(dtype)
    w = _randn(dev, 3, 3, c, f, scale=(9 * c) ** -0.5).to(dtype)
    dp = _randn(dev, 3, hw, hw, f, seed=1).to(dtype)
    aff = (1 + _randn(dev, c, scale=0.1), _randn(dev, c, scale=0.1))
    drop = cb.HashDropout(3, 0.7)
    kw = dict(bias=_randn(dev, f, scale=0.1), want_stats=True, affine=aff,
              drop=drop)
    for got, ref in zip(cb.conv3x3_nhwc(x, w, **kw),
                        cb.conv3x3_reference(x, w, **kw)):
        _close(got, ref, dtype)
    wf = cb.flip_transpose(w)
    _close(cb.conv3x3_nhwc(dp, wf, out_drop=drop)[0],
           cb.conv3x3_reference(dp, wf, out_drop=drop)[0], dtype)
    _close(cb.conv3x3_wgrad_nhwc(x, dp, affine=aff, drop=drop),
           cb.conv3x3_wgrad_reference(x, dp, affine=aff, drop=drop), dtype)
    if c < 2:
        return
    xa, xb = x[..., :c // 2].contiguous(), x[..., c // 2:].contiguous()
    for got, ref in zip(cb.conv3x3_pair_nhwc(xa, xb, w, kw["bias"], True),
                        cb.conv3x3_pair_reference(xa, xb, w, kw["bias"],
                                                  True)):
        _close(got, ref, dtype)
    for got, ref in zip(cb.conv3x3_dgrad_pair(dp, wf, c // 2),
                        cb.conv3x3_dgrad_pair_reference(dp, wf, c // 2)):
        _close(got, ref, dtype)
    for got, ref in zip(cb.conv3x3_wgrad_pair(xa, xb, dp),
                        cb.conv3x3_wgrad_pair_reference(xa, xb, dp)):
        _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_block_sums_are_reproducible(dev, dtype):
    """The forward statistics, K11's sums, B's dW and K10's dW are summed
    from per-block partials in a fixed order: two runs agree bit for bit."""
    c, f = 32, 64
    x = _randn(dev, 4, 40, 40, c).to(dtype)
    w = _randn(dev, 3, 3, c, f, scale=(9 * c) ** -0.5).to(dtype)
    dp = _randn(dev, 4, 40, 40, f, seed=1).to(dtype)
    pre = _randn(dev, 4, 40, 40, c, seed=2).to(dtype)
    aff = (1 + _randn(dev, c, scale=0.1), _randn(dev, c, scale=0.1))
    v = 1 + _randn(dev, c, scale=0.1, seed=3).abs()
    drop = cb.HashDropout(8, 0.8)
    xa, xb = x[..., :8].contiguous(), x[..., 8:].contiguous()
    wf = cb.flip_transpose(w)

    def run():
        return (cb.conv3x3_nhwc(x, w, affine=aff, drop=drop,
                                want_stats=True)[1],
                cb.conv3x3_dgrad_reduce(dp, wf, pre, *aff, aff[1], v,
                                        out_drop=drop)[1],
                cb.conv3x3_wgrad_nhwc(x, dp, affine=aff, drop=drop),
                *cb.conv3x3_wgrad_pair(xa, xb, dp))

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


def test_wrappers_count_their_launches(dev):
    x = _randn(dev, 1, 8, 8, 16)
    w = _randn(dev, 3, 3, 16, 16)
    w2 = _randn(dev, 3, 3, 32, 16)
    v = torch.ones(16, device=dev)
    fns = [cb.conv3x3_nhwc, cb.conv3x3_wgrad_nhwc, ba.bn_act, ba.bn_act_bwd,
           ba.bn_act_dpre, cb.conv3x3_pair_nhwc, cb.conv3x3_dgrad_pair,
           cb.conv3x3_wgrad_pair, cb.conv3x3_dgrad_reduce]
    before = [fn.launches for fn in fns]
    cb.conv3x3_nhwc(x, w, want_stats=True)
    cb.conv3x3_wgrad_nhwc(x, x)
    ba.bn_act(x, v, v)
    s, _ = ba.bn_act_bwd(x, x, v, v, v, v)
    ba.bn_act_dpre(x, x, v, v, v, v, s)
    cb.conv3x3_pair_nhwc(x, x, w2)
    cb.conv3x3_dgrad_pair(x, cb.flip_transpose(w2), 16)
    cb.conv3x3_wgrad_pair(x, x, x)
    cb.conv3x3_dgrad_reduce(x, w, x, v, v, v, v)
    assert [fn.launches - b for fn, b in zip(fns, before)] == [1] * 9


def _attn_inputs(dev, dtype, bn, l, n_mask, heads=3, d=32):
    c = heads * d
    qkv = _randn(dev, bn, l, 3 * c).to(dtype)
    bias = _randn(dev, heads, l, l, scale=0.5, seed=1)
    mask = torch.where(_randn(dev, n_mask, l, l, seed=2) > 0.8, -100.0, 0.0)
    do = _randn(dev, bn, l, c, seed=3).to(dtype)
    return qkv, bias, mask, do


def _attention_matches_plain(dev, dtype, l, bn, n_mask, heads=3, d=32):
    """K13 (output) and K14 (dq, dk, dv, dbias) against their plain
    versions, shifted (a per-image mask) and unshifted, with attention
    dropout at keep 0.9 and without."""
    qkv, bias, mask, do = _attn_inputs(dev, dtype, bn, l, n_mask, heads, d)
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    for m in (None, mask):
        for drop in (None, cb.HashDropout(321, 0.9)):
            _close(wa.window_attention_fwd(qkv, bias, m, heads, drop),
                   wa.window_attention_reference(q, k, v, bias, m, heads,
                                                 drop), dtype)
            dqkv, dbias = wa.window_attention_bwd(qkv, bias, m, do, heads,
                                                  drop)
            *ref, dbias_r = wa.window_attention_bwd_reference(
                q, k, v, bias, m, do, heads, drop)
            for got, r in zip(dqkv.split(q.shape[-1], dim=-1), ref):
                _close(got, r, dtype)
            _close(dbias, dbias_r, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l", [9, 49, 64])
@pytest.mark.parametrize("bn,n_mask", [(6, 3), (19, 1), (2048, 64)])
def test_window_attention_matches_plain(dev, dtype, l, bn, n_mask):
    _attention_matches_plain(dev, dtype, l, bn, n_mask)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 12, 16, 40, 64])
def test_window_attention_matches_plain_head_widths(dev, dtype, d):
    """Head widths other than the SwinUNet's 32: padded to the 16-wide MMA
    step (8, 12, 40), one 16-wide step (16), four (64), and one not a
    multiple of the 8-element copy piece (12, staged element by element),
    at L = 16 with Bn = 19 windows and n_mask = 1."""
    _attention_matches_plain(dev, dtype, 16, 19, 1, heads=4, d=d)


def _mask_inputs(dev, dtype, bn, heads, d, l):
    """q = k = 0 (every probability fl(1/L)) and the identity in the first
    L channels of each head's v and do, so K13's output and K14's dv are
    the probabilities times the dropout mask, one product each."""
    qkv = torch.zeros((bn, l, 3 * heads * d), device=dev)
    do = torch.zeros((bn, l, heads * d), device=dev)
    for h in range(heads):
        qkv[:, :, 2 * heads * d + h * d:2 * heads * d + h * d + l] = \
            torch.eye(l, device=dev)
        do[:, :, h * d:h * d + l] = torch.eye(l, device=dev)
    return qkv.to(dtype), do.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bn", [6, 19, 40])
def test_attention_dropout_mask_is_bit_exact(dev, dtype, bn):
    """K13's output (v = the identity, D = 64 >= L) equals fl(1/L) *
    attn_drop_mask bit for bit, rounded once to the dtype: the kernel
    normalises and applies the mask in fp32 and rounds P once."""
    heads, d, l, keep = 2, 64, 49, 0.9
    qkv, _ = _mask_inputs(dev, dtype, bn, heads, d, l)
    drop = cb.HashDropout(4242, keep)
    out = wa.window_attention_fwd(qkv, torch.zeros((heads, l, l), device=dev),
                                  None, heads, drop).view(bn, l, heads, d)
    p = torch.tensor(1.0, device=dev) / l
    ref = (wa.attn_drop_mask(drop.seed, bn, heads, l, keep, dev) * p).to(dtype)
    assert torch.equal(out[..., :l].permute(0, 2, 1, 3), ref)
    assert not out[..., l:].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bn", [6, 19, 40])
def test_attention_backward_dropout_mask_is_bit_exact(dev, dtype, bn):
    """K14's dv = (P o M)^T do with do = the identity: dv[j][i] is
    fl(1/L) * attn_drop_mask[i][j] bit for bit, rounded once to the dtype,
    so K14 regenerates the forward's mask at every (i, j)."""
    heads, d, l, keep = 2, 64, 49, 0.9
    qkv, do = _mask_inputs(dev, dtype, bn, heads, d, l)
    drop = cb.HashDropout(4242, keep)
    dqkv, _ = wa.window_attention_bwd(
        qkv, torch.zeros((heads, l, l), device=dev), None, do, heads, drop)
    dv = dqkv[..., 2 * heads * d:].reshape(bn, l, heads, d)
    p = torch.tensor(1.0, device=dev) / l
    ref = (wa.attn_drop_mask(drop.seed, bn, heads, l, keep, dev) * p).to(dtype)
    assert torch.equal(dv[..., :l].permute(0, 2, 3, 1), ref)
    assert not dv[..., l:].any()


@pytest.mark.parametrize("drop", [None, 0.9])
def test_attention_bias_gradient_is_reproducible(dev, drop):
    """K13's output and K14's dqkv and dbias are bitwise the same in two
    runs (dbias: per-CTA partials summed in a fixed order)."""
    qkv, bias, mask, do = _attn_inputs(dev, torch.bfloat16, 512, 49, 16, 6)
    drop = None if drop is None else cb.HashDropout(77, drop)
    runs = [wa.window_attention_bwd(qkv, bias, mask, do, 6, drop)
            for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0], runs[1][0])
    outs = [wa.window_attention_fwd(qkv, bias, mask, 6, drop)
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


def test_attention_function_launches_both_kernels(dev):
    """The autograd Function runs K13 forward and K14 backward, once each,
    and its gradients are the wrappers' results."""
    qkv, bias, mask, do = _attn_inputs(dev, torch.float32, 8, 16, 4, 2, 8)
    fns = (wa.window_attention_fwd, wa.window_attention_bwd)
    before = [fn.launches for fn in fns]
    x = qkv.clone().requires_grad_(True)
    b = bias.clone().requires_grad_(True)
    out = wa.window_attention(x, b, mask, 2)
    out.backward(do)
    assert [fn.launches - n for fn, n in zip(fns, before)] == [1, 1]
    dqkv, dbias = wa.window_attention_bwd(qkv, bias, mask, do, 2)
    assert torch.equal(x.grad, dqkv) and torch.equal(b.grad, dbias)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,c,f", [(224, 1, 16), (224, 16, 16),
                                    (14, 128, 256), (14, 256, 256)])
def test_conv_and_bn_backward_at_the_supervised_batch(dev, dtype, hw, c, f):
    """Batch 24, the supervised path's: A forward (the prologue on a
    conv2) and dgrad, D's sums and dpre, and its dpre-only entry."""
    x = _randn(dev, 24, hw, hw, c).to(dtype)
    w = _randn(dev, 3, 3, c, f, scale=(9 * c) ** -0.5).to(dtype)
    kw = dict(bias=_randn(dev, f, scale=0.1), want_stats=True)
    if c == f:
        kw.update(affine=(1 + _randn(dev, c, scale=0.1),
                          _randn(dev, c, scale=0.1)),
                  drop=cb.HashDropout(24, 0.8))
    for got, ref in zip(cb.conv3x3_nhwc(x, w, **kw),
                        cb.conv3x3_reference(x, w, **kw)):
        _close(got, ref, dtype)
    g, dy, a, b, m, inv = _bn_inputs(dev, dtype, (24, hw, hw, f))
    if c > 1:
        wf = cb.flip_transpose(w)
        _close(cb.conv3x3_nhwc(dy, wf)[0], cb.conv3x3_reference(dy, wf)[0],
               dtype)
    s, d = ba.bn_act_bwd(dy, g, a, b, m, inv)
    s_r, d_r = ba.bn_act_bwd_reference(dy, g, a, b, m, inv)
    _close(s, s_r, torch.float32)
    _close(d, d_r, dtype)
    assert torch.equal(ba.bn_act_dpre(dy, g, a, b, m, inv, s_r),
                       ba.bn_act_dpre_reference(dy, g, a, b, m, inv, s_r))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [1, 3])
@pytest.mark.parametrize("b,hw", [(2, 20), (4, 224)])
def test_dgrad_into_few_channels(dev, dtype, f, b, hw):
    """A on the flipped weights of a conv from ``f`` channels to 16: the
    input gradient of the stem (F = 1, SS-Net's VAT) and of a 3-channel
    stem."""
    w = _randn(dev, 3, 3, f, 16, scale=(9 * f) ** -0.5).to(dtype)
    dp = _randn(dev, b, hw, hw, 16, seed=1).to(dtype)
    wf = cb.flip_transpose(w)
    dx = cb.conv3x3_nhwc(dp, wf)[0]
    assert dx.shape == (b, hw, hw, f)
    _close(dx, cb.conv3x3_reference(dp, wf)[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [12, 20])
@pytest.mark.parametrize("hw,c,f", [(224, 1, 16), (112, 32, 32),
                                    (28, 128, 128), (14, 128, 256)])
def test_conv_kernels_at_the_ict_batches(dev, dtype, batch, hw, c, f):
    """ICT's teacher (12) and student (20) batches: A forward (with the
    prologue on a conv2) and dgrad, B, C, D's sums and dpre, and at the
    square shapes K8 to K10 over a (skip, up) pair of half the channels and
    K11."""
    _conv_kernels_match_plain(dev, dtype, batch, hw, c, f)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,hw,c,f", [
    # the C = 3 stems: LIDC (96^2, 8 + 24), ISIC HPFG (224^2, 8 + 32),
    # Building (512^2, 12)
    (32, 96, 3, 16), (40, 224, 3, 16), (12, 512, 3, 16),
    # the LIDC stages at 8 + 24, down to 6 x 6 images (one 8 x 16 tile
    # holds 36 live pixels)
    (32, 96, 16, 16), (32, 48, 32, 32), (32, 24, 64, 64), (32, 12, 128, 128),
    (32, 6, 128, 256), (32, 6, 256, 256),
    # the Building stages at batch 12 (3.1 M pixels at 512^2)
    (12, 512, 16, 16), (12, 256, 32, 32), (12, 128, 64, 64),
    (12, 64, 128, 128), (12, 32, 256, 256)])
def test_conv_kernels_at_the_2d_dataset_shapes(dev, dtype, batch, hw, c, f):
    """The LIDC, ISIC and Building shapes: A forward and dgrad (into 3
    channels at the stem), B, C, D's sums and dpre, and at the square
    shapes K8 to K10 over a (skip, up) pair and K11."""
    _conv_kernels_match_plain(dev, dtype, batch, hw, c, f)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [2, 9])
@pytest.mark.parametrize("batch,hw", [(32, 96), (40, 224), (24, 224),
                                      (12, 512)])
def test_conv_heads_into_few_channels(dev, dtype, f, batch, hw):
    """The logits heads of the binary (F = 2) and Synapse (F = 9) configs:
    A forward with bias, its dgrad from F into 16 channels, and B; F is no
    multiple of the 8-element vector, so every load and store of F runs
    element by element."""
    x = _randn(dev, batch, hw, hw, 16).to(dtype)
    w = _randn(dev, 3, 3, 16, f, scale=(9 * 16) ** -0.5).to(dtype)
    bias = _randn(dev, f, scale=0.1)
    _close(cb.conv3x3_nhwc(x, w, bias)[0],
           cb.conv3x3_reference(x, w, bias)[0], dtype)
    dp = _randn(dev, batch, hw, hw, f, seed=1).to(dtype)
    wf = cb.flip_transpose(w)
    _close(cb.conv3x3_nhwc(dp, wf)[0], cb.conv3x3_reference(dp, wf)[0],
           dtype)
    _close(cb.conv3x3_wgrad_nhwc(x, dp), cb.conv3x3_wgrad_reference(x, dp),
           dtype)


def _conv_kernels_match_plain(dev, dtype, batch, hw, c, f):
    x = _randn(dev, batch, hw, hw, c).to(dtype)
    w = _randn(dev, 3, 3, c, f, scale=(9 * c) ** -0.5).to(dtype)
    kw = dict(bias=_randn(dev, f, scale=0.1), want_stats=True)
    if c == f:
        kw.update(affine=(1 + _randn(dev, c, scale=0.1),
                          _randn(dev, c, scale=0.1)),
                  drop=cb.HashDropout(12, 0.8))
    for got, ref in zip(cb.conv3x3_nhwc(x, w, **kw),
                        cb.conv3x3_reference(x, w, **kw)):
        _close(got, ref, dtype)
    dp = _randn(dev, batch, hw, hw, f, seed=1).to(dtype)
    wf = cb.flip_transpose(w)
    _close(cb.conv3x3_nhwc(dp, wf)[0], cb.conv3x3_reference(dp, wf)[0],
           dtype)
    wk = {k: kw[k] for k in ("affine", "drop") if k in kw}
    _close(cb.conv3x3_wgrad_nhwc(x, dp, **wk),
           cb.conv3x3_wgrad_reference(x, dp, **wk), dtype)
    g, dy, a, b, m, inv = _bn_inputs(dev, dtype, (batch, hw, hw, f))
    assert torch.equal(ba.bn_act(g, a, b), ba.bn_act_reference(g, a, b))
    s, d = ba.bn_act_bwd(dy, g, a, b, m, inv)
    s_r, d_r = ba.bn_act_bwd_reference(dy, g, a, b, m, inv)
    _close(s, s_r, torch.float32)
    _close(d, d_r, dtype)
    if c == f:
        xa, xb = x[..., :c // 2].contiguous(), x[..., c // 2:].contiguous()
        for got, ref in zip(cb.conv3x3_pair_nhwc(xa, xb, w, want_stats=True),
                            cb.conv3x3_pair_reference(xa, xb, w,
                                                      want_stats=True)):
            _close(got, ref, dtype)
        for got, ref in zip(cb.conv3x3_dgrad_pair(dp, wf, c // 2),
                            cb.conv3x3_dgrad_pair_reference(dp, wf, c // 2)):
            _close(got, ref, dtype)
        for got, ref in zip(cb.conv3x3_wgrad_pair(xa, xb, dp),
                            cb.conv3x3_wgrad_pair_reference(xa, xb, dp)):
            _close(got, ref, dtype)
        pre = _randn(dev, batch, hw, hw, c, seed=2).to(dtype)
        dd, sums = cb.conv3x3_dgrad_reduce(dp, wf, pre, a, b, m, inv,
                                           out_drop=kw["drop"])
        dd_r, sums_r = cb.conv3x3_dgrad_reduce_reference(
            dp, wf, pre, a, b, m, inv, out_drop=kw["drop"])
        _close(dd, dd_r, dtype)
        _close(sums, sums_r, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("side,heads", [(56, 3), (28, 6), (14, 12), (7, 24)])
def test_attention_at_the_swin_mae_batch(dev, dtype, side, heads):
    """K13 and K14 at Swin-MAE's batch 24, every stage's windows (all of
    them: the masked tokens go through the blocks too), with the stage's
    own shift mask and without, with attention dropout and without."""
    _attention_stage_matches_plain(dev, dtype, 24, side, heads, 7)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("side,heads", [(48, 3), (24, 6), (12, 12), (6, 24)])
def test_attention_at_the_lidc_swin_shapes(dev, dtype, side, heads):
    """K13 and K14 at the LIDC SwinUNet's stages (96^2 images, patch 2,
    window 3: L = 9, most of each 64-row tile is padding) at its batch 24,
    with the stage's shift-by-1 mask and without, with attention dropout
    and without."""
    _attention_stage_matches_plain(dev, dtype, 24, side, heads, 3)


def _attention_stage_matches_plain(dev, dtype, batch, side, heads, ws):
    """K13 and K14 over every ws x ws window of a side x side token grid at
    ``batch``, head width 32, shifted by ws // 2 and not."""
    from hpfg_tpu_torch.models.swinunet import _shift_attention_mask

    l, d = ws * ws, 32
    bn = batch * (side // ws) ** 2
    qkv, bias, _, do = _attn_inputs(dev, dtype, bn, l, 1, heads, d)
    q, k, v = qkv.split(heads * d, dim=-1)
    smask = torch.from_numpy(_shift_attention_mask(side, side, ws,
                                                   ws // 2)).to(dev)
    for m in (None, smask):
        for drop in (None, cb.HashDropout(24, 0.9)):
            _close(wa.window_attention_fwd(qkv, bias, m, heads, drop),
                   wa.window_attention_reference(q, k, v, bias, m, heads,
                                                 drop), dtype)
            dqkv, dbias = wa.window_attention_bwd(qkv, bias, m, do, heads,
                                                  drop)
            *ref, dbias_r = wa.window_attention_bwd_reference(
                q, k, v, bias, m, do, heads, drop)
            for got, r in zip(dqkv.split(heads * d, dim=-1), ref):
                _close(got, r, dtype)
            _close(dbias, dbias_r, dtype)


@pytest.mark.parametrize("pair", [False, True])
def test_frozen_weights_launch_no_weight_gradient(dev, pair):
    """With weights that need no gradient (VAT's inner gradient), the
    FusedConvBlock and Conv3x3Plain backwards launch no B and no K10; the
    input gradients equal those of the full backward."""
    from hpfg_tpu_torch.models.layers import ConvBlock

    c, f = 16, 32
    block = ConvBlock(c, f, 0.0).to(dev)
    x0 = _randn(dev, 2, 20, 20, c)
    dy = _randn(dev, 2, 20, 20, f, seed=1)
    wgrads = (cb.conv3x3_wgrad_nhwc, cb.conv3x3_wgrad_pair)
    grads = []
    for frozen in (False, True):
        for p in block.parameters():
            p.requires_grad_(not frozen)
            p.grad = None
        x = x0.clone().requires_grad_(True)
        inp = ((x[..., :8].contiguous(), x[..., 8:].contiguous()) if pair
               else x)
        before = [fn.launches for fn in wgrads]
        y = block(inp, train=True, fold=False)
        y = cb.conv3x3_plain(y, block.conv2.kernel, block.conv2.bias)
        y.backward(dy)
        launched = [fn.launches - n for fn, n in zip(wgrads, before)]
        if frozen:
            assert launched == [0, 0]
            assert all(p.grad is None for p in block.parameters())
        else:
            assert launched == ([2, 1] if pair else [3, 0])
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])


#: the SegFormer test's seeds
SEGFORMER_SEEDS = tuple(range(8))
#: the most the card's bf16 gradients may lie farther from the CPU's fp32
#: ones than the CPU's bf16 gradients do (L2 over all parameters): that
#: ratio ran from 0.94 to 1.15 over seeds 0-9 on an H100
#: (``scripts/segformer_bf16_grads.py``, PERF.md section 6)
SEGFORMER_BF16_MARGIN = 1.25
#: how near ReLU's kink the head's ReLU input may be where the two devices
#: put it on opposite sides, relative to its largest magnitude
SEGFORMER_KINK = 1e-5


def segformer_grads(dtype, device, seed=0, relu_side=None):
    """SegFormer B0 at 64^2, 4 images, drop rates 0, weights drawn from
    ``2 * seed`` and inputs from ``2 * seed + 1``, one train-mode forward
    and backward of sum(logits * dy): (logits, the head's BN running
    statistics, {parameter: gradient} but for ``BN_INVARIANT``, the head's
    ReLU input). ``relu_side``: a bool tensor, where another run's ReLU
    input was positive; where this run's lies on the other side of zero it
    is mirrored (a constant added, so the gradients flow as before) and
    the ReLU takes that run's side."""
    model = build_model({"model": "segformer", "train_crop_size": [64, 64],
                         "drop_rate": 0.0, "drop_path_rate": 0.0},
                        dtype=dtype,
                        generator=torch.Generator().manual_seed(2 * seed))
    model = model.to(device)
    relu_in = []

    def take_side(module, args, y):
        relu_in.append(y.detach())
        if relu_side is None:
            return y
        flip = (y > 0) != relu_side.to(y.device)
        return y - 2 * torch.where(flip, y, 0).detach()

    model.decoder.bn.register_forward_hook(take_side)
    gen = torch.Generator().manual_seed(2 * seed + 1)
    x = torch.randn((4, 64, 64, 1), generator=gen).to(device)
    dy = torch.randn((4, 64, 64, 4), generator=gen).to(device)
    out = model(x, train=True)
    (out * dy).sum().backward()
    return (out, (model.decoder.bn.mean, model.decoder.bn.var),
            {n: p.grad for n, p in model.named_parameters()
             if n not in BN_INVARIANT}, relu_in[0])


def l2_rel(got: dict, ref: dict) -> float:
    """||got - ref|| / ||ref|| over every parameter's gradient at once."""
    diff = torch.cat([(got[n].float().cpu() - ref[n].float().cpu()).reshape(-1)
                      for n in ref])
    return (diff.norm() / torch.cat([ref[n].float().cpu().reshape(-1)
                                     for n in ref]).norm()).item()


@pytest.mark.parametrize("seed", SEGFORMER_SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_segformer_train_forward_backward_matches_cpu(dev, dtype, seed):
    """The SegFormer B0 (cuDNN convs on channels-last views, cuBLAS
    matmuls, the fp32 attention flow) on the card against the same module
    on the CPU, in train mode: logits and the head's BN running statistics
    within the dtype's tolerance; in fp32 every parameter gradient too.

    The head's ReLU input has about 10^5 values; one of them can lie a few
    1e-6 from zero, within the two devices' rounding, and take the ReLU's
    other side on the CPU, which moves ``linear_fuse``'s gradient by up to
    7e-3 of its largest magnitude (seeds 2, 5 and 7 on an H100). So in
    fp32 the CPU run takes the card's side wherever the two differ, and
    each such value must lie within ``SEGFORMER_KINK`` of zero.

    In bf16 the gradients carry bf16's own rounding error, whichever device
    computes them: biases and norm parameters are sums over every position
    that cancel, and one tensor's bf16 gradient can lie a tenth of its
    largest magnitude from the fp32 one on the CPU alone
    (``scripts/segformer_bf16_grads.py`` measures both devices). So in
    bf16 the card must be no farther from the CPU's fp32 gradients than the
    CPU's bf16 ones are, in L2 over all parameters, but for the margin
    ``SEGFORMER_BF16_MARGIN`` taken from the spread of that ratio over ten
    seeds: a layout or dtype slip moves the gradients by O(1)."""
    cpu = torch.device("cpu")
    out, stats, grads, relu_in = segformer_grads(dtype, dev, seed)
    side = relu_in > 0 if dtype == torch.float32 else None
    out_c, stats_c, grads_c, relu_in_c = segformer_grads(dtype, cpu, seed,
                                                         side)
    assert out.dtype == torch.float32
    _close(out, out_c, dtype)
    for got, ref in zip(stats, stats_c):
        _close(got, ref, dtype)
    if dtype == torch.float32:
        flipped = relu_in_c[(relu_in_c > 0) != side.cpu()]
        assert flipped.numel() <= 4, flipped
        assert (flipped.abs() <= SEGFORMER_KINK
                * relu_in_c.abs().max()).all(), flipped
        for name, g in grads.items():
            _close(g, grads_c[name], dtype)
        return
    _, _, grads32, _ = segformer_grads(torch.float32, cpu, seed)
    card, cpu_err = l2_rel(grads, grads32), l2_rel(grads_c, grads32)
    assert card <= SEGFORMER_BF16_MARGIN * cpu_err, (card, cpu_err)
