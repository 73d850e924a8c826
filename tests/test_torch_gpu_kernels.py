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
summed in another order). Hash dropout masks (the ConvBlock's and the
attention's, forward and backward, in fp32 and bf16) are bit-exact, and
the attention's output and bias gradient are bitwise the same from run to
run.
"""

import pytest
import torch

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [4, 16, 48])
def test_bn_act_and_bwd_match_plain(dev, dtype, f):
    g = _randn(dev, 2, 20, 20, f).to(dtype)
    dy = _randn(dev, 2, 20, 20, f, seed=1).to(dtype)
    a, b = 1 + _randn(dev, f, scale=0.1), _randn(dev, f, scale=0.1, seed=1)
    m, inv = _randn(dev, f, scale=0.1, seed=2), 1 + _randn(dev, f).abs()
    _close(ba.bn_act(g, a, b), ba.bn_act_reference(g, a, b), dtype)
    s, d = ba.bn_act_bwd(dy, g, a, b, m, inv)
    s_r, d_r = ba.bn_act_bwd_reference(dy, g, a, b, m, inv)
    _close(s, s_r, dtype)
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
