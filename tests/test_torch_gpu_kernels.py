"""The port's hand-written kernels (A conv3x3_nhwc, B conv3x3_wgrad_nhwc,
C bn_act, D bn_act_bwd and bn_act_dpre, K8 conv3x3_pair_nhwc, K9
conv3x3_dgrad_pair, K10 conv3x3_wgrad_pair, K11 conv3x3_dgrad_reduce, K13
window_attention_fwd, K14 window_attention_bwd) against their plain PyTorch
versions on a CUDA card, at small ragged shapes (20x20 images do not fill
the 8x16 tiles; channel splits that are not multiples of the 16-channel
tile; windows of 9, 16, 49 and 64 tokens, head widths of 8 to 64 (not all
multiples of the 16-wide MMA step, one not a multiple of the 8-element
copy piece), window counts that are not multiples of the hash's 16-window
block). The ConvBlock masks also with a two-segment image-id map, each
local image hashing its index in a 2-rank global batch (A's prologue and
output masks bit-exact, B and K11 against their plain versions), K13 and
K14 with that map (each window hashing its index in the global batch's
windows: the masks bit-exact against the full batch's, the outputs and
gradients against the plain versions), and D's reduce alone
(``bn_reduce``). K8 and K10 take their wgmma kernels (bf16, halves and F
multiples of 8, aligned) at the UNet's four UpBlock shapes at batch 32
and at 28^2 with batches 12 and 20, with statistics and dW bitwise the
same in two runs, and each route counts its own launches. A and B take
theirs (``conv_route``) at every ACDC shape of the main path, in the
identity, prologue and dgrad forms, each also on the mma.sync route
against the plain version; the id-map masks, the cross-block sums and
the ConvBlock backward run on the wgmma route in bf16. K9 and K11 take
the same wgmma conv (``conv_route``'s "dgrad_pair" and "dgrad_reduce"
forms) at the UpBlock and conv2 shapes at batch 32 (and 12), each beside
its mma.sync route, with K11's output mask bit-exact on both routes with
a two-segment id map and its sums bitwise the same in two runs. K13
and K14 on both routes (``attn_route``: the wgmma route packs 64 // L
windows a tile and sums K14's dbias in the kernel) at L = 9, 16 and 49
and head widths 8 to 64, their masks bit-exact on both with and without
an id map, the wgmma route's dbias bitwise the same in two runs, and
each route's launch count.

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

K12, the bf16 stem (C = 1 and 3 into F = 16 and 32), takes its own
kernel (``conv_route``'s "stem", ``csrc/stem_sm90.cu``) where TMA can
take its rows, against the plain version at 96^2, 224^2 and 512^2 with
batches 1 to 48, with and without
statistics and bias, its statistics bitwise the same in two calls; an
odd width keeps the mma.sync route. D's full backward takes its
cooperative kernel in one launch, in the hold and the stream form, at
the five ACDC stages and the 2-D datasets' stages: sums bitwise the same
in back-to-back calls on one stream, dpre bitwise equal to the plain
version from the kernel's own sums, the barrier's counter back at 0;
``bn_reduce`` alone likewise; F % 8 != 0 keeps PR 6's two kernels. Each
route counts its launches.

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
    # PR 6's reduce (the element path's; the vector path takes the
    # cooperative kernel), then dpre from its sums
    runs = [ba._reduce(dy, g, a, b, m, inv) for _ in range(3)]
    runs = [(s, ba._dpre(dy, g, a, b, m, inv, s)) for s in runs]
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


def _routes(fn):
    return {r: c.launches for r, c in fn.routes.items()}


# (batch, H=W, C a half, F) of the UNet's UpBlock conv1s at batch 32, and
# 28^2 at ICT's batches 12 and 20 (ragged tiles: 28 = 3.5 tile rows)
UPBLOCKS = [(32, 28, 128, 128), (32, 56, 64, 64), (32, 112, 32, 32),
            (32, 224, 16, 16), (12, 28, 128, 128), (20, 28, 128, 128)]


@pytest.mark.parametrize("b,hw,c,f", UPBLOCKS)
def test_pair_kernels_on_wgmma_at_the_upblock_shapes(dev, b, hw, c, f):
    """K8 (forward + statistics) and K10 on their wgmma route (bf16,
    aligned halves) against their plain versions; the statistics, y and
    both dW bitwise the same in two runs; every launch on that route."""
    dtype = torch.bfloat16
    xa = _randn(dev, b, hw, hw, c).to(dtype)
    xb = _randn(dev, b, hw, hw, c, seed=1).to(dtype)
    w = _randn(dev, 3, 3, 2 * c, f, scale=(18 * c) ** -0.5).to(dtype)
    bias = _randn(dev, f, scale=0.1)
    dp = _randn(dev, b, hw, hw, f, seed=2).to(dtype)
    k8, k10 = _routes(cb.conv3x3_pair_nhwc), _routes(cb.conv3x3_wgrad_pair)
    y, st = cb.conv3x3_pair_nhwc(xa, xb, w, bias, want_stats=True)
    y_r, st_r = cb.conv3x3_pair_reference(xa, xb, w, bias, want_stats=True)
    _close(y, y_r, dtype)
    _close(st, st_r, dtype)
    y2, st2 = cb.conv3x3_pair_nhwc(xa, xb, w, bias, want_stats=True)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    dw = cb.conv3x3_wgrad_pair(xa, xb, dp)
    for got, ref in zip(dw, cb.conv3x3_wgrad_pair_reference(xa, xb, dp)):
        _close(got, ref, dtype)
    assert all(torch.equal(u, v)
               for u, v in zip(dw, cb.conv3x3_wgrad_pair(xa, xb, dp)))
    assert _routes(cb.conv3x3_pair_nhwc) == {"wgmma": k8["wgmma"] + 2,
                                             "mma": k8["mma"]}
    assert _routes(cb.conv3x3_wgrad_pair) == {"wgmma": k10["wgmma"] + 2,
                                              "mma": k10["mma"]}


@pytest.mark.parametrize("ca,cu,f,dtype,route", [
    (16, 16, 16, torch.bfloat16, "wgmma"), (8, 24, 64, torch.bfloat16, "wgmma"),
    (12, 20, 24, torch.bfloat16, "mma"), (16, 16, 16, torch.float32, "mma")])
def test_pair_routes_count_their_launches(dev, ca, cu, f, dtype, route):
    """Each route of K8 and K10 counts its own launches: an aligned bf16
    call (8 + 24: a zero-filled group tail) on wgmma, the 12 + 20 split and
    fp32 on PR 4's mma.sync kernels; the result against the plain version
    either way."""
    xa = _randn(dev, 2, 20, 20, ca).to(dtype)
    xb = _randn(dev, 2, 20, 20, cu, seed=1).to(dtype)
    w = _randn(dev, 3, 3, ca + cu, f, scale=(9 * (ca + cu)) ** -0.5).to(dtype)
    dp = _randn(dev, 2, 20, 20, f, seed=2).to(dtype)
    other = "mma" if route == "wgmma" else "wgmma"
    for fn, call, ref in (
            (cb.conv3x3_pair_nhwc,
             lambda: cb.conv3x3_pair_nhwc(xa, xb, w, want_stats=True),
             lambda: cb.conv3x3_pair_reference(xa, xb, w, want_stats=True)),
            (cb.conv3x3_wgrad_pair, lambda: cb.conv3x3_wgrad_pair(xa, xb, dp),
             lambda: cb.conv3x3_wgrad_pair_reference(xa, xb, dp))):
        before, total = _routes(fn), fn.launches
        for got, want in zip(call(), ref()):
            _close(got, want, dtype)
        after = _routes(fn)
        assert after[route] == before[route] + 1
        assert after[other] == before[other]
        assert fn.launches == total + 1


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
    a_mma = cb.conv3x3_nhwc.routes["mma"].launches
    b_mma = cb.conv3x3_wgrad_nhwc.routes["mma"].launches
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
    if dtype == torch.bfloat16:  # every A and B call took the wgmma route
        assert cb.conv3x3_nhwc.routes["mma"].launches == a_mma
        assert cb.conv3x3_wgrad_nhwc.routes["mma"].launches == b_mma


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

    before = (_routes(cb.conv3x3_nhwc), _routes(cb.conv3x3_wgrad_nhwc))
    for a, b in zip(run(), run()):
        assert torch.equal(a, b)
    if dtype == torch.bfloat16:  # A's statistics and B's dW on wgmma
        assert _routes(cb.conv3x3_nhwc)["wgmma"] == before[0]["wgmma"] + 2
        assert _routes(cb.conv3x3_wgrad_nhwc)["wgmma"] == \
            before[1]["wgmma"] + 2


def _ids(dev, lb=4, ub=8, rank=1):
    """Rank ``rank``'s two-segment image-id map of a 2-rank batch of lb
    labelled and ub unlabelled images."""
    from hpfg_tpu_torch.parallel.mesh import Mesh

    return Mesh(2, rank, dev).rows(lb, ub).ids


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("keep", [0.95, 0.5])
def test_kernel_hash_masks_with_image_ids_are_bit_exact(dev, keep, dtype):
    """As above with a two-segment id map: A's prologue and output masks
    are the global batch's mask rows, bit for bit."""
    c, ids = 24, _ids(dev)
    x = torch.ones((len(ids), 20, 20, c), device=dev, dtype=dtype)
    eye = torch.zeros((3, 3, c, c), device=dev, dtype=dtype)
    eye[1, 1] = torch.eye(c, device=dev, dtype=dtype)
    drop = cb.HashDropout(1234, keep, ids)
    full = cb.hash_mask(drop.seed, 12, 20, 20 * c, keep, dev)
    ref = full[ids.long()].view(len(ids), 20, 20, c).to(dtype)
    ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    before = _routes(cb.conv3x3_nhwc)
    assert torch.equal(cb.conv3x3_nhwc(x, eye, affine=(ones, zeros),
                                       drop=drop)[0], ref)
    route = "wgmma" if dtype == torch.bfloat16 else "mma"
    assert _routes(cb.conv3x3_nhwc)[route] == before[route] + 1
    assert torch.equal(cb.conv3x3_nhwc(x, eye, out_drop=drop)[0], ref)
    assert not torch.equal(ref, full[:len(ids)].view_as(ref).to(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_b_and_k11_with_image_ids_match_plain(dev, dtype):
    """B's recomputed prologue and K11's output mask with a two-segment id
    map against their plain versions; D's reduce alone (``bn_reduce``)
    against its plain version."""
    c, f, ids = 16, 32, _ids(dev)
    n = len(ids)
    drop = cb.HashDropout(21, 0.8, ids)
    src = _randn(dev, n, 20, 20, c).to(dtype)
    dp = _randn(dev, n, 20, 20, f, seed=1).to(dtype)
    a, b = 1 + _randn(dev, c, scale=0.1), _randn(dev, c, scale=0.1, seed=1)
    _close(cb.conv3x3_wgrad_nhwc(src, dp, affine=(a, b), drop=drop),
           cb.conv3x3_wgrad_reference(src, dp, affine=(a, b), drop=drop),
           dtype)
    w = _randn(dev, 3, 3, c, f, scale=(9 * c) ** -0.5).to(dtype)
    m, inv = _randn(dev, c, scale=0.1, seed=2), 1 + _randn(dev, c).abs()
    wf = cb.flip_transpose(w)
    got = cb.conv3x3_dgrad_reduce(dp, wf, src, a, b, m, inv, out_drop=drop)
    ref = cb.conv3x3_dgrad_reduce_reference(dp, wf, src, a, b, m, inv,
                                            out_drop=drop)
    for g, r in zip(got, ref):
        _close(g, r, dtype)
    _close(ba.bn_reduce(got[0], src, a, b, m, inv),
           ba.bn_reduce_reference(got[0], src, a, b, m, inv), dtype)
    with pytest.raises(ValueError, match="image_ids"):
        cb.conv3x3_nhwc(dp, wf, out_drop=cb.HashDropout(21, 0.8, ids[:3]))


def test_wrappers_count_their_launches(dev):
    x = _randn(dev, 1, 8, 8, 16)
    w = _randn(dev, 3, 3, 16, 16)
    w2 = _randn(dev, 3, 3, 32, 16)
    v = torch.ones(16, device=dev)
    fns = [cb.conv3x3_nhwc, cb.conv3x3_wgrad_nhwc, ba.bn_act, ba.bn_act_bwd,
           ba.bn_act_dpre, cb.conv3x3_pair_nhwc, cb.conv3x3_dgrad_pair,
           cb.conv3x3_wgrad_pair, cb.conv3x3_dgrad_reduce, ba.bn_reduce]
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
    ba.bn_reduce(x, x, v, v, v, v)
    assert [fn.launches - b for fn, b in zip(fns, before)] == [1] * 10


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


def _two_segment_rows(dev, lb, ub):
    """Rank 1's rows of a 2-rank global batch of lb + ub images."""
    from hpfg_tpu_torch.parallel.mesh import Mesh

    return Mesh(2, 1, dev).rows(lb, ub)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lb,ub,nw", [(8, 24, 4), (2, 2, 3)])
def test_attention_dropout_masks_with_image_ids_are_bit_exact(dev, dtype, lb,
                                                               ub, nw):
    """With a two-segment image-id map, K13's output and K14's dv carry the
    full batch's masks at the rank's windows (each window hashes its
    global index; the global window counts 128 and 12, over and under the
    hash's block of 16), bit for bit, as attn_drop_mask with the same ids
    does."""
    rows = _two_segment_rows(dev, lb, ub)
    heads, d, l, keep = 2, 64, 49, 0.9
    bn = len(rows.ids) * nw
    qkv, do = _mask_inputs(dev, dtype, bn, heads, d, l)
    drop = cb.HashDropout(4243, keep, rows.ids, rows.total)
    zero = torch.zeros((heads, l, l), device=dev)
    p = torch.tensor(1.0, device=dev) / l
    full = wa.attn_drop_mask(drop.seed, rows.total * nw, heads, l, keep, dev)
    ref = (full[rows.expand(nw).index] * p).to(dtype)
    assert torch.equal(ref, (wa.attn_drop_mask(
        drop.seed, bn, heads, l, keep, dev, rows.ids, rows.total)
        * p).to(dtype))
    out = wa.window_attention_fwd(qkv, zero, None, heads, drop).view(
        bn, l, heads, d)
    assert torch.equal(out[..., :l].permute(0, 2, 1, 3), ref)
    dqkv, _ = wa.window_attention_bwd(qkv, zero, None, do, heads, drop)
    dv = dqkv[..., 2 * heads * d:].reshape(bn, l, heads, d)
    assert torch.equal(dv[..., :l].permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l,nw,n_mask", [(49, 4, 4), (9, 16, 1)])
def test_attention_with_image_ids_matches_plain(dev, dtype, l, nw, n_mask):
    """K13 and K14 (dq, dk, dv, dbias) with attention dropout and a
    two-segment image-id map against their plain versions, shifted and
    unshifted."""
    rows = _two_segment_rows(dev, 8, 24)
    bn = len(rows.ids) * nw
    qkv, bias, mask, do = _attn_inputs(dev, dtype, bn, l, n_mask)
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    drop = cb.HashDropout(322, 0.9, rows.ids, rows.total)
    for m in (None, mask):
        _close(wa.window_attention_fwd(qkv, bias, m, 3, drop),
               wa.window_attention_reference(q, k, v, bias, m, 3, drop),
               dtype)
        dqkv, dbias = wa.window_attention_bwd(qkv, bias, m, do, 3, drop)
        *ref, dbias_r = wa.window_attention_bwd_reference(q, k, v, bias, m,
                                                          do, 3, drop)
        for got, r in zip(dqkv.split(q.shape[-1], dim=-1), ref):
            _close(got, r, dtype)
        _close(dbias, dbias_r, dtype)
    with pytest.raises(ValueError, match="image_ids"):
        wa.window_attention_fwd(qkv[:-1], bias, None, 3, drop)


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


# both routes of K13 and K14 (attn_route): wgmma takes bf16 at head widths
# 16, 32 and 64; the mma route every dtype and width
ROUTE_CASES = [(route, dtype, l, d)
               for l in (9, 16, 49) for d in (8, 12, 16, 32, 40, 64)
               for route, dtype in (("wgmma", torch.bfloat16),
                                    ("mma", torch.bfloat16),
                                    ("mma", torch.float32))
               if route == "mma" or d in wa.SM90_HEAD_WIDTHS]


@pytest.mark.parametrize("route,dtype,l,d", ROUTE_CASES)
def test_attention_routes_match_plain(dev, route, dtype, l, d):
    """K13 (output) and K14 (dq, dk, dv, dbias) on each route, forced
    through ``_launch``, against their plain versions at L = 9, 16 and 49
    (the wgmma route packs 7, 4 and 1 windows a tile) and head widths 8 to
    64, unshifted (Bn = 19) and shifted (Bn = 24 over 4 mask classes),
    with attention dropout at keep 0.9 and without."""
    heads = 3
    for bn, n_mask in ((19, 1), (24, 4)):
        qkv, bias, mask, do = _attn_inputs(dev, dtype, bn, l, n_mask, heads,
                                           d)
        q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
        m = None if n_mask == 1 else mask
        for drop in (None, cb.HashDropout(323, 0.9)):
            _close(wa._launch(route, False, qkv, bias, m, heads, drop),
                   wa.window_attention_reference(q, k, v, bias, m, heads,
                                                 drop), dtype)
            dqkv, dbias = wa._launch(route, True, qkv, bias, m, do, heads,
                                     drop)
            *ref, dbias_r = wa.window_attention_bwd_reference(
                q, k, v, bias, m, do, heads, drop)
            for got, r in zip(dqkv.split(q.shape[-1], dim=-1), ref):
                _close(got, r, dtype)
            _close(dbias, dbias_r, dtype)


@pytest.mark.parametrize("route", wa.ROUTES)
@pytest.mark.parametrize("l,d", [(9, 16), (16, 16), (49, 64)])
@pytest.mark.parametrize("ids", [False, True])
def test_attention_masks_on_both_routes_are_bit_exact(dev, route, l, d, ids):
    """bf16 K13's output and K14's dv (v and do the identity) carry
    fl(1/L) * attn_drop_mask bit for bit on each route, packed (L = 9 and
    16: 7 and 4 windows a tile on the wgmma route) or not, without and
    with a two-segment image-id map (each window hashing its global
    index)."""
    heads, keep = 2, 0.9
    if ids:
        rows = _two_segment_rows(dev, 8, 24)
        bn = len(rows.ids) * 16
        drop = cb.HashDropout(4244, keep, rows.ids, rows.total)
        ref = wa.attn_drop_mask(drop.seed, bn, heads, l, keep, dev,
                                rows.ids, rows.total)
    else:
        bn = 40
        drop = cb.HashDropout(4244, keep)
        ref = wa.attn_drop_mask(drop.seed, bn, heads, l, keep, dev)
    qkv, do = _mask_inputs(dev, torch.bfloat16, bn, heads, d, l)
    ref = (ref * (torch.tensor(1.0, device=dev) / l)).to(torch.bfloat16)
    zero = torch.zeros((heads, l, l), device=dev)
    out = wa._launch(route, False, qkv, zero, None, heads, drop).view(
        bn, l, heads, d)
    assert torch.equal(out[..., :l].permute(0, 2, 1, 3), ref)
    assert not out[..., l:].any()
    dqkv, _ = wa._launch(route, True, qkv, zero, None, do, heads, drop)
    dv = dqkv[..., 2 * heads * d:].reshape(bn, l, heads, d)
    assert torch.equal(dv[..., :l].permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("l,bn,n_mask,heads", [(9, 6144, 256, 3),
                                               (49, 2048, 64, 3),
                                               (16, 40, 1, 2)])
def test_wgmma_attention_dbias_is_reproducible(dev, l, bn, n_mask, heads):
    """The wgmma route's dbias (per-CTA rows, group rows and the head sum,
    each in a fixed order through the tickets) and dqkv bitwise the same in
    two runs, at the LIDC and ACDC stage-0 shapes (86 CTAs a head: eleven
    groups) and a one-group grid; the tickets are left at zero."""
    qkv, bias, mask, do = _attn_inputs(dev, torch.bfloat16, bn, l, n_mask,
                                       heads)
    drop = cb.HashDropout(78, 0.9)
    runs = [wa._launch("wgmma", True, qkv, bias, mask, do, heads, drop)
            for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0], runs[1][0])
    from hpfg_tpu_torch.ops._cuda import ticket

    assert not ticket(dev, "attn_sm90_bwd").any()


def test_attention_routes_count_their_launches(dev):
    """Each wrapper call bumps its route's count once: bf16 at D = 32 the
    wgmma route, bf16 at D = 40 and fp32 the mma route."""
    fns = (wa.window_attention_fwd, wa.window_attention_bwd)
    for dtype, d, route in ((torch.bfloat16, 32, "wgmma"),
                            (torch.bfloat16, 40, "mma"),
                            (torch.float32, 32, "mma")):
        qkv, bias, mask, do = _attn_inputs(dev, dtype, 8, 49, 4, 2, d)
        before = [{r: c.launches for r, c in fn.routes.items()}
                  for fn in fns]
        wa.window_attention_fwd(qkv, bias, mask, 2)
        wa.window_attention_bwd(qkv, bias, mask, do, 2)
        for fn, b in zip(fns, before):
            assert {r: c.launches - b[r] for r, c in fn.routes.items()} == {
                r: int(r == route) for r in wa.ROUTES}


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


# (batch, H=W, C, F, form) of A's and B's calls on the ACDC main path at
# batch 32 that conv_route sends to wgmma: conv1 forwards (identity, with
# statistics), conv2 forwards (prologue: the encoder's dropout keep, or
# None), conv1 and plain-conv dgrads (C -> F here is the dgrad's own), the
# plain convs' forwards; and batch 12 at 14^2 and 28^2
ACDC_A_B = ([(32, 224 >> i, c, f, "conv1") for i, c, f in
             ((1, 16, 32), (2, 32, 64), (3, 64, 128), (4, 128, 256))]
            + [(32, 224 >> i, f, f, keep) for i, f, keep in
               ((0, 16, 0.95), (1, 32, 0.9), (2, 64, 0.8), (3, 128, 0.7),
                (4, 256, 0.5), (3, 128, None), (2, 64, None), (1, 32, None),
                (0, 16, None))]
            + [(32, 224 >> i, f, c, "dgrad") for i, c, f in
               ((1, 16, 32), (2, 32, 64), (3, 64, 128), (4, 128, 256))]
            + [(32, 224 >> (i + 1), c, c // 2, "plain")
               for i, c in ((0, 32), (1, 64), (2, 128), (3, 256))]
            + [(32, 224 >> (i + 1), c // 2, c, "dgrad")
               for i, c in ((0, 32), (1, 64), (2, 128), (3, 256))]
            + [(12, 14, 256, 256, 0.5), (12, 28, 64, 128, "conv1")])


def _case_args(dev, b, hw, c, f, form):
    x = _randn(dev, b, hw, hw, c).to(torch.bfloat16)
    w = _randn(dev, 3, 3, c, f, scale=(9 * c) ** -0.5).to(torch.bfloat16)
    kw = {}
    if form in ("conv1", "plain"):
        kw["bias"] = _randn(dev, f, scale=0.1)
        kw["want_stats"] = form == "conv1"
    elif form != "dgrad":
        kw = dict(bias=_randn(dev, f, scale=0.1), want_stats=True,
                  affine=(1 + _randn(dev, c, scale=0.1),
                          _randn(dev, c, scale=0.1, seed=1)),
                  drop=None if form is None else cb.HashDropout(31, form))
    return x, w, kw


@pytest.mark.parametrize("b,hw,c,f,form", ACDC_A_B)
def test_a_and_b_on_both_routes_at_the_acdc_shapes(dev, b, hw, c, f, form):
    """A (identity, prologue and dgrad forms) and B (identity and prologue)
    at the ACDC main path's shapes: the wrapper, which takes the wgmma
    route (B's prologue form below 32 channels the mma route, by
    conv_route's static rule), and the mma.sync route through its
    launchers, each against the plain version; A's y and statistics and
    B's dW bitwise the same in two runs."""
    x, w, kw = _case_args(dev, b, hw, c, f, form)
    want = kw.get("want_stats", False)
    before = _routes(cb.conv3x3_nhwc), _routes(cb.conv3x3_wgrad_nhwc)
    y, st = cb.conv3x3_nhwc(x, w, **kw)
    y_r, st_r = cb.conv3x3_reference(x, w, **kw)
    _close(y, y_r, torch.bfloat16)
    y2, st2 = cb.conv3x3_nhwc(x, w, **kw)
    assert torch.equal(y, y2)
    if want:
        _close(st, st_r, torch.bfloat16)
        assert torch.equal(st, st2)
    pro = cb._prologue_args(kw.get("affine"), kw.get("drop"), c, b, dev)
    y_m = torch.empty_like(y)
    st_m = cb._launch_conv(x, w, y_m, bias=kw.get("bias"), pro=pro,
                           want_sums=want)
    _close(y_m, y_r, torch.bfloat16)
    if want:
        _close(st_m, st_r, torch.bfloat16)
    dp = _randn(dev, b, hw, hw, f, seed=3).to(torch.bfloat16)
    wkw = {k: kw[k] for k in ("affine", "drop") if k in kw}
    dw = cb.conv3x3_wgrad_nhwc(x, dp, **wkw)
    dw_r = cb.conv3x3_wgrad_reference(x, dp, **wkw)
    _close(dw, dw_r, torch.bfloat16)
    assert torch.equal(dw, cb.conv3x3_wgrad_nhwc(x, dp, **wkw))
    _close(cb._launch_wgrad(x, dp, pro=pro).view_as(dw_r), dw_r,
           torch.bfloat16)
    assert _routes(cb.conv3x3_nhwc) == {"wgmma": before[0]["wgmma"] + 2,
                                        "mma": before[0]["mma"],
                                        "stem": before[0]["stem"]}
    b_route = cb.conv_route(c, f, torch.bfloat16, True,
                            "wgrad_prologue" if wkw else "wgrad")
    want = dict(before[1])
    want[b_route] += 2
    assert _routes(cb.conv3x3_wgrad_nhwc) == want


@pytest.mark.parametrize("c,f,dtype,form,route,b_route", [
    (32, 32, torch.bfloat16, "prologue", "wgmma", "wgmma"),
    (16, 32, torch.bfloat16, "prologue", "wgmma", "mma"),
    (24, 136, torch.bfloat16, "conv", "wgmma", "wgmma"),
    (1, 16, torch.bfloat16, "conv", "mma", "mma"),
    (16, 4, torch.bfloat16, "prologue", "mma", "mma"),
    (12, 20, torch.bfloat16, "prologue", "mma", "mma"),
    (32, 32, torch.bfloat16, "out_drop", "mma", None),
    (32, 32, torch.float32, "prologue", "mma", "mma")])
def test_conv_routes_count_their_launches(dev, c, f, dtype, form, route,
                                          b_route):
    """Each route of A and B counts its own launches (``routes``): aligned
    bf16 calls with channels multiples of 8 on wgmma, the stem's C = 1,
    the head's F = 4, odd channels, an output mask, fp32 and B's prologue
    form below 32 channels on the mma.sync kernels; the results against
    the plain versions either way."""
    x = _randn(dev, 2, 20, 20, c).to(dtype)
    w = _randn(dev, 3, 3, c, f, scale=(9 * c) ** -0.5).to(dtype)
    dp = _randn(dev, 2, 20, 20, f, seed=2).to(dtype)
    drop = cb.HashDropout(5, 0.8)
    aff = (1 + _randn(dev, c, scale=0.1), _randn(dev, c, scale=0.1, seed=1))
    kw = ({"out_drop": drop} if form == "out_drop" else
          dict(affine=aff, drop=drop, want_stats=True)
          if form == "prologue" else {"want_stats": True})
    wkw = {k: kw[k] for k in ("affine", "drop") if k in kw}
    assert cb.conv_route(c, f, dtype, True, form) == route
    for fn, call, ref in (
            (cb.conv3x3_nhwc, lambda: cb.conv3x3_nhwc(x, w, **kw),
             lambda: cb.conv3x3_reference(x, w, **kw)),
            (cb.conv3x3_wgrad_nhwc,
             lambda: (cb.conv3x3_wgrad_nhwc(x, dp, **wkw),),
             lambda: (cb.conv3x3_wgrad_reference(x, dp, **wkw),))):
        if fn is cb.conv3x3_wgrad_nhwc and form == "out_drop":
            continue  # B has no output mask
        expect = route if fn is cb.conv3x3_nhwc else b_route
        other = "mma" if expect == "wgmma" else "wgmma"
        before, total = _routes(fn), fn.launches
        for got, want in zip(call(), ref()):
            if want is not None:
                _close(got, want, dtype)
        after = _routes(fn)
        assert after[expect] == before[expect] + 1
        assert after[other] == before[other]
        assert fn.launches == total + 1


# (batch, H=W, F = the cotangent's channels, Ca, Cb) of K9 at the UNet's
# four UpBlocks at batch 32, and 28^2 at batch 12; (batch, H=W, C, keep of
# the output mask or None) of K11 at every ConvBlock's conv2 at batch 32
# (the encoder's with its dropout, the decoder's without), and 14^2 at 12
ACDC_K9 = [(32, 28, 128, 128, 128), (32, 56, 64, 64, 64),
           (32, 112, 32, 32, 32), (32, 224, 16, 16, 16),
           (12, 28, 128, 128, 128)]
ACDC_K11 = [(32, 224, 16, 0.95), (32, 112, 32, 0.9), (32, 56, 64, 0.8),
            (32, 28, 128, 0.7), (32, 14, 256, 0.5), (32, 28, 128, None),
            (32, 56, 64, None), (32, 112, 32, None), (32, 224, 16, None),
            (12, 14, 256, 0.5)]


def _k11_args(dev, dtype, b, hw, c, seed=0):
    dp = _randn(dev, b, hw, hw, c, seed=seed).to(dtype)
    w = _randn(dev, 3, 3, c, c, scale=(9 * c) ** -0.5, seed=seed).to(dtype)
    pre = _randn(dev, b, hw, hw, c, seed=seed + 1).to(dtype)
    a = 1 + _randn(dev, c, scale=0.1, seed=seed)
    bb = _randn(dev, c, scale=0.1, seed=seed + 1)
    m, inv = _randn(dev, c, scale=0.1, seed=seed + 2), 1 + _randn(dev, c).abs()
    return dp, cb.flip_transpose(w), (pre, a, bb, m, inv)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hw,f,ca,cu", ACDC_K9)
def test_k9_on_both_routes_at_the_acdc_shapes(dev, dtype, b, hw, f, ca, cu):
    """K9 at the UpBlock shapes: the wrapper (bf16: the wgmma route; fp32:
    the mma route) and, in bf16, PR 4's mma.sync route through its
    launcher, each output against the plain version; the wrapper's
    outputs bitwise the same in two runs; each launch counted on its
    route."""
    dp = _randn(dev, b, hw, hw, f).to(dtype)
    w = _randn(dev, 3, 3, ca + cu, f, scale=(9 * (ca + cu)) ** -0.5).to(dtype)
    wf = cb.flip_transpose(w)
    route = cb.conv_route(f, ca + cu, dtype, True, "dgrad_pair", ca)
    assert route == ("wgmma" if dtype == torch.bfloat16 else "mma")
    before = _routes(cb.conv3x3_dgrad_pair)
    got = cb.conv3x3_dgrad_pair(dp, wf, ca)
    ref = cb.conv3x3_dgrad_pair_reference(dp, wf, ca)
    for g, r in zip(got, ref):
        assert g.is_contiguous()
        _close(g, r, dtype)
    assert all(torch.equal(u, v)
               for u, v in zip(got, cb.conv3x3_dgrad_pair(dp, wf, ca)))
    want = dict(before)
    want[route] += 2
    assert _routes(cb.conv3x3_dgrad_pair) == want
    if route == "wgmma":  # the other route at the same shape
        dxa, dxb = torch.empty_like(got[0]), torch.empty_like(got[1])
        cb._launch_conv(dp, wf, dxa, y2=dxb)
        _close(dxa, ref[0], dtype)
        _close(dxb, ref[1], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hw,c,keep", ACDC_K11)
def test_k11_on_both_routes_at_the_acdc_shapes(dev, dtype, b, hw, c, keep):
    """K11 at every ConvBlock's conv2 shape, with the encoder's output mask
    or without: the wrapper (bf16: the wgmma route; fp32: the mma route)
    and, in bf16, both routes through their launchers, dd and the sums
    against the plain version; the wrapper's dd and sums bitwise the same
    in two runs; each launch counted on its route."""
    dp, wf, red = _k11_args(dev, dtype, b, hw, c)
    drop = None if keep is None else cb.HashDropout(17, keep)
    route = cb.conv_route(c, c, dtype, True, "dgrad_reduce")
    before = _routes(cb.conv3x3_dgrad_reduce)
    dd, s = cb.conv3x3_dgrad_reduce(dp, wf, *red, out_drop=drop)
    dd_r, s_r = cb.conv3x3_dgrad_reduce_reference(dp, wf, *red,
                                                  out_drop=drop)
    _close(dd, dd_r, dtype)
    _close(s, s_r, dtype)
    dd2, s2 = cb.conv3x3_dgrad_reduce(dp, wf, *red, out_drop=drop)
    assert torch.equal(dd, dd2) and torch.equal(s, s2)
    want = dict(before)
    want[route] += 2
    assert _routes(cb.conv3x3_dgrad_reduce) == want
    if dtype == torch.bfloat16:  # both routes, whichever the wrapper took
        dd_w = torch.empty_like(dd)
        s_w = cb._launch_dgrad_reduce_sm90(dp, wf, dd_w, red, drop)
        dd_m = torch.empty_like(dd)
        s_m = cb._launch_conv(dp, wf, dd_m, out_drop=drop, reduce=red,
                              want_sums=True)
        for got_dd, got_s in ((dd_w, s_w), (dd_m, s_m)):
            _close(got_dd, dd_r, dtype)
            _close(got_s, s_r, dtype)
        # the same rounded output on both routes, so the same mask
        assert torch.equal(dd_w == 0, dd_m == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hw,c,keep", [(16, 224, 16, 0.95),
                                         (16, 28, 128, 0.7),
                                         (16, 14, 256, 0.5)])
def test_k11_with_image_ids_on_both_routes(dev, dtype, b, hw, c, keep):
    """K11's output mask with a two-segment image-id map (rank 1's rows of
    a 2-rank global batch of 8 + 24): bit-exact through the identity
    dgrad of an all-ones cotangent on both routes (the mask rows of the
    global batch, not the local ones), and dd and the sums against the
    plain version."""
    ids = _ids(dev, 8, 24)
    assert len(ids) == b
    drop = cb.HashDropout(1234 + c, keep, ids)
    ones = torch.ones((b, hw, hw, c), device=dev, dtype=dtype)
    eye = torch.zeros((3, 3, c, c), device=dev, dtype=dtype)
    eye[1, 1] = torch.eye(c, device=dev, dtype=dtype)
    one, zero = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    unit = (ones, one, zero, zero, one)
    full = cb.hash_mask(drop.seed, 32, hw, hw * c, keep, dev)
    ref = full[ids.long()].view(b, hw, hw, c).to(dtype)
    got = cb.conv3x3_dgrad_reduce(ones, eye, *unit, out_drop=drop)[0]
    assert torch.equal(got, ref)
    y = torch.empty_like(ones)
    if dtype == torch.bfloat16:
        cb._launch_dgrad_reduce_sm90(ones, eye, y, unit, drop)
        assert torch.equal(y, ref)
    cb._launch_conv(ones, eye, y, out_drop=drop, reduce=unit, want_sums=True)
    assert torch.equal(y, ref)
    assert not torch.equal(ref, full[:b].view_as(ref).to(dtype))
    dp, wf, red = _k11_args(dev, dtype, b, hw, c, seed=5)
    for g, r in zip(cb.conv3x3_dgrad_reduce(dp, wf, *red, out_drop=drop),
                    cb.conv3x3_dgrad_reduce_reference(dp, wf, *red,
                                                      out_drop=drop)):
        _close(g, r, dtype)


@pytest.mark.parametrize("ca,cu,f,c,dtype,route", [
    (16, 16, 16, 16, torch.bfloat16, "wgmma"),
    (8, 24, 64, 24, torch.bfloat16, "wgmma"),
    (12, 20, 24, 20, torch.bfloat16, "mma"),
    (16, 16, 16, 16, torch.float32, "mma")])
def test_k9_and_k11_routes_count_their_launches(dev, ca, cu, f, c, dtype,
                                                route):
    """Each route of K9 and K11 counts its own launches (``routes``): aligned
    bf16 calls whose channels are multiples of 8 on wgmma (8 + 24: a zero
    group tail in the cotangent's 24 channels for K11), the 12 + 20 split,
    20 channels and fp32 on PR 4's mma.sync kernel; the results against
    the plain versions either way."""
    dp = _randn(dev, 2, 20, 20, f, seed=2).to(dtype)
    w = _randn(dev, 3, 3, ca + cu, f, scale=(9 * (ca + cu)) ** -0.5).to(dtype)
    dp11, wf11, red = _k11_args(dev, dtype, 2, 20, c)
    drop = cb.HashDropout(5, 0.8)
    other = "mma" if route == "wgmma" else "wgmma"
    for fn, call, ref in (
            (cb.conv3x3_dgrad_pair,
             lambda: cb.conv3x3_dgrad_pair(dp, cb.flip_transpose(w), ca),
             lambda: cb.conv3x3_dgrad_pair_reference(
                 dp, cb.flip_transpose(w), ca)),
            (cb.conv3x3_dgrad_reduce,
             lambda: cb.conv3x3_dgrad_reduce(dp11, wf11, *red, out_drop=drop),
             lambda: cb.conv3x3_dgrad_reduce_reference(dp11, wf11, *red,
                                                       out_drop=drop))):
        before, total = _routes(fn), fn.launches
        for got, want in zip(call(), ref()):
            _close(got, want, dtype)
        after = _routes(fn)
        assert after[route] == before[route] + 1
        assert after[other] == before[other]
        assert fn.launches == total + 1


# ---------------------------------------------------------------------------
# K12 on its own kernel, D on its cooperative kernel
# ---------------------------------------------------------------------------

STEM_CASES = [(1, 16, 32, 224), (1, 16, 1, 224), (3, 16, 32, 96),
              (3, 16, 48, 96), (3, 16, 2, 512), (3, 16, 4, 224),
              (1, 32, 3, 224), (3, 32, 2, 96), (1, 16, 2, 100),
              (3, 16, 2, 90)]


@pytest.mark.parametrize("c,f,b,hw", STEM_CASES)
@pytest.mark.parametrize("stats,bias", [(True, True), (False, True),
                                        (True, False)])
def test_stem_route_matches_plain(dev, c, f, b, hw, stats, bias):
    """The wrapper's route (stem where the rows are whole 16-byte units:
    100 x 1 and 90 x 3 bf16 are not, and keep mma) and, on the stem
    route, both forms of the kernel; y within bf16 tolerance, the
    statistics within fp32's, and bitwise the same in two calls."""
    dt = torch.bfloat16
    x = _randn(dev, b, hw, hw, c).to(dt)
    w = _randn(dev, 3, 3, c, f, scale=(9 * c) ** -0.5).to(dt)
    kw = dict(bias=_randn(dev, f, scale=0.1) if bias else None,
              want_stats=stats)
    route = cb.conv_route(c, f, dt, True, "conv", width=hw)
    assert route == ("stem" if hw * c * 2 % 16 == 0 else "mma")
    before = cb.conv3x3_nhwc.routes[route].launches
    y, st = cb.conv3x3_nhwc(x, w, **kw)
    assert cb.conv3x3_nhwc.routes[route].launches == before + 1
    y_r, st_r = cb.conv3x3_reference(x, w, **kw)
    _close(y, y_r, dt)
    assert (st is None) == (not stats)
    if stats:
        _close(st, st_r, torch.float32)
        assert torch.equal(st, cb.conv3x3_nhwc(x, w, **kw)[1])
    if route != "stem":
        return
    y2 = torch.empty_like(y)
    st2 = cb._launch_stem(x, w, y2, bias=kw["bias"], want_sums=stats)
    assert torch.equal(y2, y)  # the launcher alone: the wrapper's result
    if stats:
        assert torch.equal(st2, st)
    assert int(cb.ticket(dev, "stem").item()) == 0


#: (batch, side, channels) of the ConvBlock outputs D sees: the ACDC
#: stages at batch 32, the LIDC ones (96^2) at 32, the ISIC ones (224^2)
#: at 40 and the Building ones (512^2) at 12
BN_STAGES = ([(32, 224 >> i, 16 << i) for i in range(5)]
             + [(32, 96 >> i, 16 << i) for i in range(5)]
             + [(40, 224 >> i, 16 << i) for i in range(5)]
             + [(12, 512 >> i, 16 << i) for i in range(5)])


def _coop_checks(dev, dtype, shape, form):
    g, dy, a, b, m, inv = _bn_inputs(dev, dtype, shape)
    counter = ba.ticket(dev, "bn_coop")
    runs = []
    for _ in range(3):  # back to back on one stream
        d = torch.empty_like(dy)
        s, got = ba._coop(dy, g, a, b, m, inv, d, form=form)
        runs.append((s.clone(), d))
    assert got == (form or got)
    for s, d in runs[1:]:
        assert torch.equal(s, runs[0][0])
        assert torch.equal(d, runs[0][1])
    s, d = runs[0]
    s_r, d_r = ba.bn_act_bwd_reference(dy, g, a, b, m, inv)
    _close(s, s_r, torch.float32)
    _close(d, d_r, dtype)
    assert torch.equal(d, ba.bn_act_dpre_reference(dy, g, a, b, m, inv, s))
    assert int(counter.item()) == 0
    return got


@pytest.mark.parametrize("b,hw,f", BN_STAGES)
def test_bn_coop_at_the_main_path_stages(dev, b, hw, f):
    """The wrapper's form (hold where dy and pre fit the resident CTAs)
    and, where that is hold, the stream form at the same shape."""
    shape = (b, hw, hw, f)
    form = _coop_checks(dev, torch.bfloat16, shape, None)
    g, dy, a, bb, m, inv = _bn_inputs(dev, torch.bfloat16, shape)
    before = {r: c.launches for r, c in ba.bn_act_bwd.routes.items()}
    ba.bn_act_bwd(dy, g, a, bb, m, inv)
    after = {r: c.launches for r, c in ba.bn_act_bwd.routes.items()}
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == form) for r in after}
    if form == "hold":
        _coop_checks(dev, torch.bfloat16, shape, "stream")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 20, 20, 16), (3, 7, 7, 256),
                                   (1, 5, 5, 8), (32, 28, 28, 128)])
def test_bn_coop_both_forms_both_dtypes(dev, dtype, shape):
    for form in ("hold", "stream"):
        _coop_checks(dev, dtype, shape, form)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(32, 14, 14, 256), (32, 112, 112, 32),
                                   (2, 20, 20, 48)])
def test_bn_reduce_alone_on_the_cooperative_kernel(dev, dtype, shape):
    g, dy, a, b, m, inv = _bn_inputs(dev, dtype, shape)
    before = {r: c.launches for r, c in ba.bn_reduce.routes.items()}
    runs = [ba.bn_reduce(dy, g, a, b, m, inv) for _ in range(3)]
    after = {r: c.launches for r, c in ba.bn_reduce.routes.items()}
    assert {r: after[r] - before[r] for r in after} == {
        "hold": 0, "stream": 3, "walk": 0}
    for s in runs[1:]:
        assert torch.equal(s, runs[0])
    _close(runs[0], ba.bn_reduce_reference(dy, g, a, b, m, inv),
           torch.float32)
    assert int(ba.ticket(dev, "bn_coop").item()) == 0


@pytest.mark.parametrize("dtype,f,route", [
    (torch.bfloat16, 12, "walk"), (torch.bfloat16, 20, "walk"),
    (torch.float32, 6, "walk"), (torch.bfloat16, 300, "walk"),
    (torch.bfloat16, 16, "hold"), (torch.float32, 12, "hold")])
def test_bn_routes_count_their_launches(dev, dtype, f, route):
    """F % V != 0 (and more than 256 channel groups) keep PR 6's two
    kernels; a small aligned call holds. Each call counts on its route."""
    g, dy, a, b, m, inv = _bn_inputs(dev, dtype, (2, 20, 20, f))
    before = {r: c.launches for r, c in ba.bn_act_bwd.routes.items()}
    s, d = ba.bn_act_bwd(dy, g, a, b, m, inv)
    after = {r: c.launches for r, c in ba.bn_act_bwd.routes.items()}
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    _close(s, ba.bn_reduce_reference(dy, g, a, b, m, inv), torch.float32)
    assert torch.equal(d, ba.bn_act_dpre_reference(dy, g, a, b, m, inv, s))
