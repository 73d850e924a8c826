"""The port's fused ConvBlock and plain conv (hpfg_tpu_torch.ops.conv_block)
against the JAX package's Pallas kernels in interpret mode and its jnp
reference, on the CPU, where the port's kernel wrappers take their plain
PyTorch versions.

Inputs come from a seeded numpy generator and go to both sides as the same
fp32 arrays. Tolerances (fp32 throughout): the two sides sum the 3x3xC
products and the BN statistics in different orders, so values agree to
ATOL = 1e-4 absolute (activations and statistics are O(1)); gradients are
held to 1e-4 of the largest gradient of the same tensor family plus 1e-6.
The dropout mask is an integer hash and is held bit-exact.
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


def _params(rng, c, f, scale=0.2):
    def g(*s):
        return (rng.normal(size=s) * scale).astype(np.float32)

    return dict(w1=g(3, 3, c, f), b1=g(f), scale1=1.0 + 0.1 * g(f),
                bias1=0.1 * g(f), w2=g(3, 3, f, f), b2=g(f),
                scale2=1.0 + 0.1 * g(f), bias2=0.1 * g(f))


def _jax_params(p):
    return jcb.ConvBlockParams(**{k: jnp.asarray(v) for k, v in p.items()})


def _torch_params(p):
    return {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}


def _port_block(x, tp, train=True, drop=None, run_stats=None):
    return tcb.FusedConvBlock.apply(x, *(tp[k] for k in NAMES), run_stats,
                                    train, drop)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def _grads_close(ref: dict, got: dict):
    scale = max(float(np.max(np.abs(v))) for v in ref.values())
    for k, v in ref.items():
        err = float(np.max(np.abs(np.asarray(v) - np.asarray(got[k]))))
        assert err <= GRAD_RTOL * scale + 1e-6, (k, err, scale)


@pytest.mark.parametrize("c,f", [(1, 16), (16, 32), (32, 16)])
def test_fused_block_matches_pallas_and_reference(c, f):
    """Forward (y, batch statistics) and vjp (dx, every parameter gradient,
    zero conv-bias gradients) with hash dropout, against
    fused_conv_block(interpret=True) and conv_block_reference fed the
    oracle mask."""
    rng = np.random.default_rng(100 + c + f)
    keep, seed = 0.8, 4321
    p = _params(rng, c, f)
    x = rng.normal(size=(2, 16, 16, c)).astype(np.float32)
    dy = rng.normal(size=(2, 16, 16, f)).astype(np.float32)
    jp = _jax_params(p)

    def fused(xx, pp):
        return jcb.fused_conv_block(xx, pp, None, jnp.float32(seed), True,
                                    True, keep, None)

    mask = np.stack([np.asarray(jcb.hash_mask_reference(
        float(seed), i, 16, 16 * f, keep)) for i in range(2)])
    mask4 = jnp.asarray(mask.reshape(2, 16, 16, f))

    def reference(xx, pp):
        return jcb.conv_block_reference(xx, pp, mask4, True)

    @jax.jit
    def fwd_vjp(xx, pp):
        out = {}
        for name, fn in (("fused", fused), ("ref", reference)):
            (y, st), vjp = jax.vjp(fn, xx, pp)
            gx, gp = vjp((jnp.asarray(dy), jax.tree_util.tree_map(
                jnp.zeros_like, st)))
            out[name] = (y, st, gx, gp)
        return out

    res = fwd_vjp(jnp.asarray(x), jp)
    y_j, st_j, gx_j, gp_j = res["fused"]
    y_r, st_r, gx_r, gp_r = res["ref"]

    xt = torch.tensor(x, requires_grad=True)
    tp = _torch_params(p)
    y_t, *st_t = _port_block(xt, tp, drop=tcb.HashDropout(seed, keep))
    (y_t * torch.from_numpy(dy)).sum().backward()

    got = {k: tp[k].grad.numpy() for k in NAMES}
    got["x"] = xt.grad.numpy()
    for y_ref, st_ref, gx_ref, gp_ref in ((y_j, st_j, gx_j, gp_j),
                                          (y_r, st_r, gx_r, gp_r)):
        _close(y_t.detach(), y_ref)
        for a, b in zip(st_t, st_ref):
            _close(a, b)
        ref = {k: np.asarray(getattr(gp_ref, k)) for k in NAMES}
        ref["x"] = np.asarray(gx_ref)
        _grads_close(ref, got)
    assert not tp["b1"].grad.any() and not tp["b2"].grad.any()


def test_fused_block_eval_mode_uses_running_stats():
    rng = np.random.default_rng(7)
    c = f = 16
    p = _params(rng, c, f)
    x = rng.normal(size=(2, 16, 16, c)).astype(np.float32)
    run = [rng.normal(size=f).astype(np.float32) * 0.1,
           rng.uniform(0.5, 1.5, size=f).astype(np.float32),
           rng.normal(size=f).astype(np.float32) * 0.1,
           rng.uniform(0.5, 1.5, size=f).astype(np.float32)]
    y_j, _ = jcb.fused_conv_block(jnp.asarray(x), _jax_params(p), None, None,
                                  False, True, None,
                                  jcb.FusedStats(*map(jnp.asarray, run)))
    with torch.no_grad():
        y_t, *st = _port_block(torch.from_numpy(x), _torch_params(p),
                               train=False,
                               run_stats=tuple(map(torch.from_numpy, run)))
    _close(y_t, y_j)
    for a, b in zip(st, run):
        _close(a, b, atol=0)


def test_fused_block_backward_raises_in_eval_mode():
    rng = np.random.default_rng(8)
    p = _params(rng, 16, 16)
    run = tuple(torch.ones(16) for _ in range(4))
    xt = torch.tensor(rng.normal(size=(1, 8, 8, 16)).astype(np.float32),
                      requires_grad=True)
    y, *_ = _port_block(xt, _torch_params(p), train=False, run_stats=run)
    with pytest.raises(RuntimeError, match="train mode only"):
        y.sum().backward()


@pytest.mark.parametrize("c,f", [(16, 4), (32, 16)])
def test_plain_conv_matches_pallas(c, f):
    rng = np.random.default_rng(200 + c + f)
    x = rng.normal(size=(2, 16, 16, c)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c, f)) * 0.2).astype(np.float32)
    b = rng.normal(size=f).astype(np.float32)
    dy = rng.normal(size=(2, 16, 16, f)).astype(np.float32)

    @jax.jit
    def fwd_vjp(xx, ww, bb):
        y, vjp = jax.vjp(lambda *a: jcb.fused_conv3x3_plain(*a, True),
                         xx, ww, bb)
        return y, vjp(jnp.asarray(dy))

    y_j, g_j = fwd_vjp(*map(jnp.asarray, (x, w, b)))

    xt, wt, bt = (torch.tensor(v, requires_grad=True) for v in (x, w, b))
    y_t = tcb.conv3x3_plain(xt, wt, bt)
    (y_t * torch.from_numpy(dy)).sum().backward()
    _close(y_t.detach(), y_j)
    _grads_close({"x": g_j[0], "w": g_j[1], "b": g_j[2]},
                 {"x": xt.grad, "w": wt.grad, "b": bt.grad})


@pytest.mark.parametrize("seed,keep", [(0, 0.95), (12345, 0.8),
                                       ((1 << 23) - 1, 0.5)])
def test_hash_mask_bit_exact(seed, keep):
    got = tcb.hash_mask(seed, 3, 8, 64, keep).numpy()
    for b in range(3):
        ref = np.asarray(jcb.hash_mask_reference(float(seed), b, 8, 64,
                                                 keep))
        assert ref.dtype == got.dtype
        np.testing.assert_array_equal(got[b], ref)
