"""Kernels C and D (``hpfg_tpu_torch/ops/bn_act.py``) against the JAX
package's Pallas kernels in interpret mode, and the kernels' walk
(``bn_walk``) against a brute-force count. On the CPU, where the port's
wrappers take their plain PyTorch versions; no card and no flax init.

The same seeded numpy inputs, [2, 6, 6, F] for F = 4, 12, 16 in fp32 and
bf16, go through ``bn_act``, ``bn_act_bwd`` and ``bn_act_dpre`` and through
``_bn_act_apply`` (K3), ``_bwd_reduce`` folded over w as ``_fold_sums``
does (K4) and ``_dpre`` (K5), with the per-channel vectors tiled over w as
``conv_block._bwd`` tiles them. The affine scale ``a`` is a power of two
(with a negative channel), so a*pre is exact, and a few ``pre`` values are
placed where z = a*pre + b is exactly 0 and one bf16 step to either side:
both sides then take the same LeakyReLU branch at every element, and the
branch is compared exactly (dy = 1, zero sums, mean 0, inv 0: dpre = a*dz).
Tolerances, relative to the reference's largest magnitude: fp32 1e-5
(another summation order of the sums), bf16 2e-2 (bf16 rounding of the
inputs to dpre at other points).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.ops.pallas import conv_block as jcb
from hpfg_tpu_torch.ops import bn_act as ba

B, H, W = 2, 6, 6
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(f: int, dname: str, seed: int = 0):
    """(dy, pre, a, b, mean, inv) as float32 numpy, dy and pre already
    rounded to the dtype; z = a*pre + b is exactly 0 at pre[0, 0, 0] and one
    step of the dtype above and below it at pre[0, 0, 1] and pre[0, 0, 2]."""
    tdt = DTYPES[dname][0]
    rng = np.random.default_rng(seed + f)

    def rounded(x):
        return torch.from_numpy(x.astype(np.float32)).to(tdt).float().numpy()

    pre = rounded(rng.normal(size=(B, H, W, f)))
    dy = rounded(rng.normal(size=(B, H, W, f)))
    a = rng.choice([0.5, 1.0, 2.0], size=f).astype(np.float32)
    a[f // 2] = -1.0
    p0 = rounded(rng.normal(size=f) * 0.5)
    b = (-a * p0).astype(np.float32)
    pre[0, 0, 0] = p0
    step = torch.from_numpy(p0).to(tdt)
    up = torch.nextafter(step, torch.full_like(step, math.inf))
    down = torch.nextafter(step, torch.full_like(step, -math.inf))
    pre[0, 0, 1] = up.float().numpy()
    pre[0, 0, 2] = down.float().numpy()
    mean = (rng.normal(size=f) * 0.1).astype(np.float32)
    inv = (1.0 + np.abs(rng.normal(size=f))).astype(np.float32)
    return dy, pre, a, b, mean, inv


def _t(x, dname):
    return torch.from_numpy(np.ascontiguousarray(x)).to(DTYPES[dname][0])


def _j(x, dname):
    return jnp.asarray(x).astype(DTYPES[dname][1])


def _rows(x):  # NHWC -> the Pallas kernels' [B, H, W*F]
    return x.reshape(B, H, -1)


def _tile(v):
    return jnp.tile(jnp.asarray(v, jnp.float32), W)


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _np(t):
    return t.float().numpy()


def _jax_sums(dy, pre, a, b, mean, inv, f, dname):
    s = jcb._bwd_reduce(_rows(_j(dy, dname)), _rows(_j(pre, dname)),
                        _tile(a), _tile(b), _tile(mean), _tile(inv), h=H,
                        w=W, f=f, interpret=True)
    return jcb._fold_sums(s, W, f)


def _jax_dpre(dy, pre, a, b, mean, inv, sums, f, dname):
    n = B * H * W
    out = jcb._dpre(_rows(_j(dy, dname)), _rows(_j(pre, dname)),
                    (_tile(a), _tile(b), _tile(mean), _tile(inv),
                     _tile(sums[0] / n), _tile(sums[1] / n)), h=H, w=W, f=f,
                    dtype=DTYPES[dname][1], interpret=True)
    return np.asarray(out.astype(jnp.float32)).reshape(B, H, W, f)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("f", [4, 12, 16])
def test_bn_act_matches_pallas(f, dname):
    _, g, a, b, _, _ = _inputs(f, dname)
    got = _np(ba.bn_act(_t(g, dname), torch.from_numpy(a),
                        torch.from_numpy(b)))
    ref = jcb._bn_act_apply(_rows(_j(g, dname)), _tile(a), _tile(b), h=H,
                            w=W, f=f, dtype=DTYPES[dname][1], interpret=True)
    ref = np.asarray(ref.astype(jnp.float32)).reshape(B, H, W, f)
    assert _rel(got, ref) <= TOL[dname]
    # the branch: z >= 0 exactly where y >= 0, the same on both sides
    np.testing.assert_array_equal(got >= 0, ref >= 0)
    assert (got[0, 0, 0] == 0).all()


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("f", [4, 12, 16])
def test_bn_act_bwd_matches_pallas(f, dname):
    dy, pre, a, b, mean, inv = _inputs(f, dname)
    vecs = [torch.from_numpy(v) for v in (a, b, mean, inv)]
    sums, dpre = ba.bn_act_bwd(_t(dy, dname), _t(pre, dname), *vecs)
    assert sums.shape == (2, f) and sums.dtype == torch.float32
    assert dpre.dtype == DTYPES[dname][0]
    ref_sums = np.array(_jax_sums(dy, pre, a, b, mean, inv, f, dname))
    assert _rel(sums.numpy(), ref_sums) <= TOL[dname]
    ref = _jax_dpre(dy, pre, a, b, mean, inv, ref_sums, f, dname)
    assert _rel(_np(dpre), ref) <= TOL[dname]
    # dpre alone from the reference's sums
    alone = ba.bn_act_dpre(_t(dy, dname), _t(pre, dname), *vecs,
                           torch.from_numpy(ref_sums))
    assert _rel(_np(alone), ref) <= TOL[dname]


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("f", [4, 12, 16])
def test_dpre_branch_is_exact(f, dname):
    """dy = 1, zero sums, mean 0 and inv 0: dpre = a*dz = a or a*0.01 per
    element, so the two sides must agree bitwise, branch by branch."""
    _, pre, a, b, _, _ = _inputs(f, dname)
    ones = np.ones_like(pre)
    zeros = np.zeros(f, np.float32)
    got = _np(ba.bn_act_dpre(
        _t(ones, dname), _t(pre, dname), torch.from_numpy(a),
        torch.from_numpy(b), torch.from_numpy(zeros),
        torch.from_numpy(zeros), torch.zeros(2, f)))
    ref = _jax_dpre(ones, pre, a, b, zeros, zeros, np.zeros((2, f)), f, dname)
    np.testing.assert_array_equal(got, ref)
    # z = 0 takes the z >= 0 branch, one step below takes the slope
    np.testing.assert_array_equal(got[0, 0, 0], _np(_t(a, dname)))
    neg = a < 0
    np.testing.assert_array_equal(got[0, 0, 2][~neg], _np(_t(
        a * np.float32(0.01), dname))[~neg])


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

# (P, F) of the five main-path conv2 outputs at batch 32 and small shapes
# the GPU tests run (20x20 images at batch 2, ragged F)
MAIN = [(32 * 224 * 224, 16), (32 * 112 * 112, 32), (32 * 56 * 56, 64),
        (32 * 28 * 28, 128), (32 * 14 * 14, 256)]
SMALL = [(800, 4), (800, 12), (800, 16), (800, 20), (800, 48), (800, 256),
         (2 * 7 * 7, 256), (37, 3000), (1, 2056), (333, 8), (0, 16),
         (8 * 6 * 6, 256), (8 * 12 * 12, 128)]
# (P, F) of the ConvBlock outputs at the LIDC stages (96^2 down to 6^2, at
# the batches 8, 24, 32 and 40 the LIDC and ISIC paths give them) and the
# Building stages (512^2 down to 32^2 at batch 12: 3.1 M rows at 512^2)
ROWS_2D = sorted(
    {(b * (96 >> i) ** 2, 16 << i) for b in (8, 24, 32, 40)
     for i in range(5)}
    | {(12 * (512 >> i) ** 2, 16 << i) for i in range(5)})


def _cover(w: ba.BnWalk, p: int, f: int) -> np.ndarray:
    """Simulate bn_act.cu's Walk: how often each (row, channel) is touched
    by a thread of some CTA."""
    hits = np.zeros((p, f), np.int64)
    groups = f // w.vec
    u = ba.TURN_STEPS
    for y in range(w.chunks):
        for t in range(ba.CTA_THREADS):
            rr, c = t // w.cols, y * w.cols + t % w.cols
            if rr >= w.rows_per_step or c >= groups:
                continue
            for x in range(w.ctas):
                for k in range(x, w.turns, w.ctas):
                    for s in range(k * u, k * u + u):
                        row = s * w.rows_per_step + rr
                        if row < p:
                            hits[row, c * w.vec:(c + 1) * w.vec] += 1
    return hits


def _invariants(w: ba.BnWalk, p, f, es, resident, aligned):
    v = 16 // es
    assert w.vec == (v if aligned and f % v == 0 else 1)
    assert w.cols * w.rows_per_step <= ba.CTA_THREADS
    assert (w.chunks - 1) * w.cols < f // w.vec <= w.chunks * w.cols
    assert w.steps == -(-p // w.rows_per_step)
    span = w.rows_per_step * ba.TURN_STEPS
    assert w.turns * span >= p > (w.turns - 1) * span
    # no CTA idle: each walks at least one turn, so it writes its partial
    assert 1 <= w.ctas <= max(w.turns, 1)
    if resident is None:  # C and dpre: one CTA per turn
        assert w.ctas == max(w.turns, 1)
    else:  # the reduce: within the resident CTAs and the sqrt balance
        assert w.ctas * w.chunks <= resident or w.ctas == 1
        assert w.ctas <= max(1, math.isqrt(p * es // 4))
    assert w.part_width >= 2 * f and w.part_width % 4 == 0


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("resident", [None, 264])
@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("p,f", SMALL)
def test_bn_walk_covers_every_element_once(p, f, es, resident, aligned):
    w = ba.bn_walk(p, f, es, aligned, resident)
    _invariants(w, p, f, es, resident, aligned)
    assert (_cover(w, p, f) == 1).all()


@pytest.mark.parametrize("resident", [None, 132, 264, 528])
@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("p,f", MAIN)
def test_bn_walk_main_path_rows(p, f, es, resident):
    """Every row in exactly one CTA's walk, every CTA with rows (a
    partial row each), the reduce's grid within the card's resident CTAs."""
    _check_rows(p, f, es, resident)


@pytest.mark.parametrize("resident", [None, 264])
@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("p,f", ROWS_2D)
def test_bn_walk_2d_dataset_rows(p, f, es, resident):
    """As above, at the 96^2 and 512^2 stages."""
    _check_rows(p, f, es, resident)


def _check_rows(p, f, es, resident):
    w = ba.bn_walk(p, f, es, True, resident)
    _invariants(w, p, f, es, resident, True)
    assert w.vec == 16 // es and w.chunks == 1
    rows = [w.rows(x) for x in range(w.ctas)]
    assert all(rows)
    flat = np.concatenate(rows)
    assert len(flat) == p
    assert (np.bincount(flat, minlength=p) == 1).all()
