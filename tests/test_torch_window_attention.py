"""The port's window attention (K13 forward, K14 backward; on the CPU their
plain versions) against the JAX package's ``window_attention`` run in
interpret mode: the output and all four gradients (q, k, v and the
relative-position bias), with and without the shift mask, at Bn = 6 (one
JAX window block) and 19 (two), L = 9 and 49; the attention-dropout mask
bit for bit against ``attn_drop_mask_reference``; and the forward and
gradients with dropout at keep 0.8 and 0.9.

The port takes the per-image mask [nW, L, L] (window w reads mask[w % nW])
where the JAX entry takes it tiled to [Bn, L, L]; the JAX side gets the
tiled copy. Tolerances are those of ``tests/test_pallas_kernels.py`` for the
Pallas kernel against its oracle (fp32 on both sides, other summation
orders): output rtol 2e-4 / atol 2e-5, gradients 5e-4 / 5e-5, gradients
with dropout 1e-3 / 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.ops.pallas.window_attention import (
    attn_drop_mask_reference,
    window_attention as jax_window_attention,
)
from hpfg_tpu_torch.ops import window_attention as twa
from hpfg_tpu_torch.ops.conv_block import HashDropout

HEADS, HEAD_DIM = 2, 4
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
DROP_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _data(bn, l, n_mask, seed):
    """q, k, v, bias, the per-image mask [n_mask, L, L] (0 / -100) and an
    output cotangent, from numpy."""
    rng = np.random.default_rng(seed)
    c = HEADS * HEAD_DIM
    q, k, v, do = (rng.normal(size=(bn, l, c)).astype(np.float32)
                   for _ in range(4))
    bias = rng.normal(size=(HEADS, l, l)).astype(np.float32)
    mask = np.where(rng.random((n_mask, l, l)) > 0.8, -100.0, 0.0
                    ).astype(np.float32)
    return q, k, v, bias, mask, do


def _jax(q, k, v, bias, mask, do, keep=None, seed=None):
    """JAX output and (dq, dk, dv, dbias) for the cotangent ``do``."""
    kw = {} if keep is None else dict(drop=keep, seed=jnp.float32(seed))

    def f(q, k, v, bias):
        return jax_window_attention(q, k, v, bias, jnp.asarray(mask),
                                    heads=HEADS, interpret=True, **kw)

    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, bias)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(q, k, v, bias, mask, do, drop=None):
    qkv = torch.tensor(np.concatenate([q, k, v], -1), requires_grad=True)
    bias_t = torch.tensor(bias, requires_grad=True)
    out = twa.window_attention(qkv, bias_t, None if mask is None
                               else torch.tensor(mask), HEADS, drop)
    out.backward(torch.tensor(do))
    return out.detach().numpy(), [*(g.numpy() for g in qkv.grad.split(
        q.shape[-1], dim=-1)), bias_t.grad.numpy()]


@pytest.mark.parametrize("masked", [False, True], ids=["unshifted",
                                                        "shifted"])
@pytest.mark.parametrize("l", [9, 49])
@pytest.mark.parametrize("bn,n_mask", [(6, 3), (19, 1)])
def test_forward_and_gradients_match_jax(bn, n_mask, l, masked):
    q, k, v, bias, mask, do = _data(bn, l, n_mask, seed=bn + l)
    tiled = np.tile(mask, (bn // n_mask, 1, 1))
    out_j, grads_j = _jax(q, k, v, bias, tiled if masked
                          else np.zeros_like(tiled), do)
    out_t, grads_t = _port(q, k, v, bias, mask if masked else None, do)
    np.testing.assert_allclose(out_t, out_j, **FWD_TOL)
    for name, g_t, g_j in zip(("dq", "dk", "dv", "dbias"), grads_t, grads_j):
        np.testing.assert_allclose(g_t, g_j, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("seed,bn,heads,l,keep", [
    (1234, 6, 2, 9, 0.9), (4321, 19, 2, 9, 0.8), (77, 19, 3, 49, 0.9)])
def test_attn_drop_mask_bit_exact(seed, bn, heads, l, keep):
    ref = np.asarray(attn_drop_mask_reference(seed, bn, heads, l, keep))
    got = twa.attn_drop_mask(seed, bn, heads, l, keep).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0.5 * (1 - keep) < float((got == 0).mean()) < 2 * (1 - keep)


@pytest.mark.parametrize("keep,seed", [(0.9, 4321), (0.8, 77)])
def test_dropout_forward_and_gradients_match_jax(keep, seed):
    """Bn = 19: the second JAX window block's hash rows are covered."""
    q, k, v, bias, mask, do = _data(19, 9, 1, seed=seed)
    out_j, grads_j = _jax(q, k, v, bias, np.tile(mask, (19, 1, 1)), do, keep,
                          seed)
    out_t, grads_t = _port(q, k, v, bias, mask, do, HashDropout(seed, keep))
    np.testing.assert_allclose(out_t, out_j, **FWD_TOL)
    for name, g_t, g_j in zip(("dq", "dk", "dv", "dbias"), grads_t, grads_j):
        np.testing.assert_allclose(g_t, g_j, err_msg=name, **DROP_GRAD_TOL)
    # the dropout acted: the output differs from the undropped one
    out_nd, _ = _port(q, k, v, bias, mask, do)
    assert np.abs(out_nd - out_t).max() > 1e-3


def test_cpu_wrappers_launch_no_kernel():
    """On CPU tensors the wrappers run their plain versions (the counters
    stay), and the plain backward is the autograd VJP of the plain
    forward."""
    q, k, v, bias, mask, do = _data(6, 9, 3, seed=5)
    qkv = torch.tensor(np.concatenate([q, k, v], -1))
    before = (twa.window_attention_fwd.launches,
              twa.window_attention_bwd.launches)
    drop = HashDropout(9, 0.9)
    dqkv, dbias = twa.window_attention_bwd(
        qkv, torch.tensor(bias), torch.tensor(mask), torch.tensor(do), HEADS,
        drop)
    qa = torch.tensor(q, requires_grad=True)
    ka = torch.tensor(k, requires_grad=True)
    va = torch.tensor(v, requires_grad=True)
    ba = torch.tensor(bias, requires_grad=True)
    twa.window_attention_reference(qa, ka, va, ba, torch.tensor(mask), HEADS,
                                   drop).backward(torch.tensor(do))
    ref = torch.cat([qa.grad, ka.grad, va.grad], -1)
    np.testing.assert_allclose(dqkv.numpy(), ref.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(dbias.numpy(), ba.grad.numpy(), **GRAD_TOL)
    assert (twa.window_attention_fwd.launches,
            twa.window_attention_bwd.launches) == before
