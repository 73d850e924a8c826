"""The port's pair ConvBlock (UpBlock: conv1 over the implicit concat of skip
and up) and its fold-reduce backward against the JAX package's Pallas
kernels in interpret mode, on the CPU, where the port's kernel wrappers take
their plain PyTorch versions.

``jcb.fused_conv_block((xa, xb), ...)`` under the package's default flags
(dual backward, fold-reduce) runs _conv_stats_cat (K8), _dgrad_pair (K9),
_wgrad_pair (K10) and _dgrad_reduce (K11); the port's FusedConvBlock with a
pair runs their counterparts conv3x3_pair_nhwc, conv3x3_dgrad_pair,
conv3x3_wgrad_pair and conv3x3_dgrad_reduce. Inputs come from a seeded numpy
generator. Tolerances (fp32 throughout), as in test_torch_conv_block.py: the
two sides sum the products and statistics in other orders, so values agree
to ATOL = 1e-4 (O(1) activations and statistics) and gradients to 1e-4 of
the largest gradient of the same family plus 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.ops.pallas import conv_block as jcb
from hpfg_tpu_torch.ops import conv_block as tcb

ATOL = 1e-4
GRAD_RTOL = 1e-4
NAMES = ("w1", "b1", "scale1", "bias1", "w2", "b2", "scale2", "bias2")


@pytest.fixture(autouse=True)
def _default_bwd_flags():
    """The JAX package's defaults: dual backward and fold-reduce on."""
    saved = (jcb._DUAL_BWD, jcb._FOLD_REDUCE)
    jcb.set_bwd_flags(dual=True, fold=True)
    yield
    jcb.set_bwd_flags(*saved)


def _params(rng, c, f, scale=0.2):
    def g(*s):
        return (rng.normal(size=s) * scale).astype(np.float32)

    return dict(w1=g(3, 3, c, f), b1=g(f), scale1=1.0 + 0.1 * g(f),
                bias1=0.1 * g(f), w2=g(3, 3, f, f), b2=g(f),
                scale2=1.0 + 0.1 * g(f), bias2=0.1 * g(f))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def _grads_close(ref: dict, got: dict):
    scale = max(float(np.max(np.abs(v))) for v in ref.values())
    for k, v in ref.items():
        err = float(np.max(np.abs(np.asarray(v) - np.asarray(got[k]))))
        assert err <= GRAD_RTOL * scale + 1e-6, (k, err, scale)


@pytest.mark.parametrize("cb,keep", [(16, None), (32, 0.8)])
def test_pair_block_matches_pallas(cb, keep):
    """Forward (y, batch statistics) and vjp (dx_skip, dx_up, every
    parameter gradient) of the pair block, (2,16,16,16) + (2,16,16,cb) -> 16,
    against fused_conv_block((xa, xb), interpret=True)."""
    ca, f, seed = 16, 16, 777
    rng = np.random.default_rng(300 + cb)
    p = _params(rng, ca + cb, f)
    xa = rng.normal(size=(2, 16, 16, ca)).astype(np.float32)
    xb = rng.normal(size=(2, 16, 16, cb)).astype(np.float32)
    dy = rng.normal(size=(2, 16, 16, f)).astype(np.float32)
    jseed = None if keep is None else jnp.float32(seed)

    @jax.jit
    def fwd_vjp(a, b, pp):
        (y, st), vjp = jax.vjp(
            lambda x, q: jcb.fused_conv_block(x, q, None, jseed, True, True,
                                              keep, None), (a, b), pp)
        gx, gp = vjp((jnp.asarray(dy),
                      jax.tree_util.tree_map(jnp.zeros_like, st)))
        return y, st, gx, gp

    y_j, st_j, (ga_j, gb_j), gp_j = fwd_vjp(
        jnp.asarray(xa), jnp.asarray(xb),
        jcb.ConvBlockParams(**{k: jnp.asarray(v) for k, v in p.items()}))

    ta = torch.tensor(xa, requires_grad=True)
    tb = torch.tensor(xb, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    drop = None if keep is None else tcb.HashDropout(seed, keep)
    y_t, *st_t = tcb.FusedConvBlock.apply(ta, *(tp[k] for k in NAMES), None,
                                          True, drop, tb)
    (y_t * torch.from_numpy(dy)).sum().backward()

    _close(y_t.detach(), y_j)
    for a, b in zip(st_t, st_j):
        _close(a, b)
    ref = {k: np.asarray(getattr(gp_j, k)) for k in NAMES}
    ref.update(xa=np.asarray(ga_j), xb=np.asarray(gb_j))
    got = {k: tp[k].grad.numpy() for k in NAMES}
    got.update(xa=ta.grad.numpy(), xb=tb.grad.numpy())
    _grads_close(ref, got)
    assert not tp["b1"].grad.any() and not tp["b2"].grad.any()


def test_pair_block_eval_mode_matches_pallas():
    """Eval mode: K8 without statistics, BN from the running statistics."""
    rng = np.random.default_rng(31)
    ca, cb, f = 16, 32, 16
    p = _params(rng, ca + cb, f)
    xa = rng.normal(size=(2, 16, 16, ca)).astype(np.float32)
    xb = rng.normal(size=(2, 16, 16, cb)).astype(np.float32)
    run = [rng.normal(size=f).astype(np.float32) * 0.1,
           rng.uniform(0.5, 1.5, size=f).astype(np.float32),
           rng.normal(size=f).astype(np.float32) * 0.1,
           rng.uniform(0.5, 1.5, size=f).astype(np.float32)]
    y_j, _ = jcb.fused_conv_block(
        (jnp.asarray(xa), jnp.asarray(xb)),
        jcb.ConvBlockParams(**{k: jnp.asarray(v) for k, v in p.items()}),
        None, None, False, True, None, jcb.FusedStats(*map(jnp.asarray, run)))
    with torch.no_grad():
        y_t, *st = tcb.FusedConvBlock.apply(
            torch.from_numpy(xa), *(torch.from_numpy(p[k]) for k in NAMES),
            tuple(map(torch.from_numpy, run)), False, None,
            torch.from_numpy(xb))
    _close(y_t, y_j)
    for a, b in zip(st, run):
        _close(a, b, atol=0)


@pytest.mark.parametrize("c,f,keep", [(16, 16, 0.7), (32, 16, None)])
def test_dgrad_reduce_matches_pallas(c, f, keep):
    """K11 alone: the port's conv3x3_dgrad_reduce (plain version on the CPU)
    against _dgrad_reduce in interpret mode, with and without the output
    dropout mask. (c, f) are the forward conv's channels: the dgrad maps
    dp [B,H,W,F] to dd [B,H,W,C] and reduces against pre [B,H,W,C]."""
    rng = np.random.default_rng(40 + c + f)
    b, hh, ww, seed = 2, 16, 16, 4242
    w = (rng.normal(size=(3, 3, c, f)) * 0.2).astype(np.float32)
    dp = rng.normal(size=(b, hh, ww, f)).astype(np.float32)
    pre = rng.normal(size=(b, hh, ww, c)).astype(np.float32)
    a = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bv = (0.1 * rng.normal(size=c)).astype(np.float32)
    m = (0.1 * rng.normal(size=c)).astype(np.float32)
    inv = rng.uniform(0.5, 1.5, size=c).astype(np.float32)

    pix = jcb.choose_pix(ww, c, f)
    wflip = jcb._expand1(jnp.flip(jnp.asarray(w), axis=(0, 1))
                         .transpose(0, 1, 3, 2), pix)
    vecs = tuple(jnp.tile(jnp.asarray(v), ww) for v in (a, bv, m, inv))
    dd_j, s_j = jcb._dgrad_reduce(
        jnp.asarray(dp).reshape(b, hh, ww * f), wflip, None,
        jnp.asarray(pre).reshape(b, hh, ww * c), vecs, c=c, f=f, w=ww, h=hh,
        pix=pix, dtype=jnp.float32, interpret=True, drop=keep,
        seed=None if keep is None else jnp.float32(seed))
    s_j = np.asarray(s_j).reshape(2, ww, c).sum(axis=1)

    drop = None if keep is None else tcb.HashDropout(seed, keep)
    t = torch.from_numpy
    dd_t, s_t = tcb.conv3x3_dgrad_reduce(
        t(dp), tcb.flip_transpose(t(w)), t(pre), t(a), t(bv), t(m), t(inv),
        out_drop=drop)
    _close(dd_t, np.asarray(dd_j).reshape(b, hh, ww, c))
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=0,
                               atol=GRAD_RTOL * np.abs(s_j).max() + 1e-6)


@pytest.mark.parametrize("ca,cb", [(16, 16), (16, 32), (24, 8)])
def test_pair_wrappers_match_their_halves(ca, cb):
    """K8, K9 and K10 against kernel A and B on each half (the pair forms
    are the single-source kernels over a split channel range), including a
    split that is not a multiple of the 16-channel tile."""
    rng = np.random.default_rng(ca * 100 + cb)
    f = 16
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    xa, xb, dp = t(2, 12, 20, ca), t(2, 12, 20, cb), t(2, 12, 20, f)
    w = t(3, 3, ca + cb, f) * 0.2
    y, st = tcb.conv3x3_pair_nhwc(xa, xb, w, want_stats=True)
    ya, sa = tcb.conv3x3_nhwc(xa, w[:, :, :ca].contiguous(), want_stats=True)
    yb, sb = tcb.conv3x3_nhwc(xb, w[:, :, ca:].contiguous(), want_stats=True)
    _close(y, ya + yb)
    _close(st[0], sa[0] + sb[0], atol=1e-3)
    wf = tcb.flip_transpose(w)
    dxa, dxb = tcb.conv3x3_dgrad_pair(dp, wf, ca)
    _close(dxa, tcb.conv3x3_nhwc(dp, wf[..., :ca].contiguous())[0])
    _close(dxb, tcb.conv3x3_nhwc(dp, wf[..., ca:].contiguous())[0])
    assert dxa.is_contiguous() and dxb.is_contiguous()
    dwa, dwb = tcb.conv3x3_wgrad_pair(xa, xb, dp)
    _close(dwa, tcb.conv3x3_wgrad_nhwc(xa, dp), atol=1e-3)
    _close(dwb, tcb.conv3x3_wgrad_nhwc(xb, dp), atol=1e-3)
