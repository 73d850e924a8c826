"""SS-Net's slice of the port against the JAX package on the CPU: VAT
(``ops/vat.py``), the memory bank and its contrastive loss
(``ops/ssnet_memory.py``), the SSNet model and three SS-Net steps, all in
fp32 on a narrow SSNet (feature_chns [8]*5, no dropout) at 32x32, the flax
side built directly (its registry builds the full width) and given the
port's weights. VAT's random direction is the JAX draw, injected.

Tolerances: forwards and losses to 1e-4 of the reference's largest
magnitude, parameter gradients to 1e-4 of the largest over the whole
reference gradient; the memory bank exactly (a gather of the same rows,
ties included); over three steps the step metrics to 1e-4 relative (the
LDS term is a function of a normalized input gradient, which carries the
fp32 rounding of a whole backward) and then parameters to 1e-4
absolute. Also: a train-mode forward without folding
leaves every BN buffer bitwise unchanged, VAT's three passes draw the same
dropout masks, the inner gradient (frozen weights) runs no weight-gradient
kernel, and the decoder's deterministic upsample backward equals torch's
to 1e-6 (fp32, another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.config import Config
from hpfg_tpu.models.ssnet import SSNet as FlaxSSNet
from hpfg_tpu.ops import ssnet_memory as jmem
from hpfg_tpu.ops import vat as jvat
from hpfg_tpu.train.algorithms import build_algorithm as jax_build_algorithm
from hpfg_tpu.train.algorithms.base import ModelState
from hpfg_tpu.train.algorithms.ssnet import SSNetState
from hpfg_tpu_torch.models import layers
from hpfg_tpu_torch.models.ssnet import SSNet
from hpfg_tpu_torch.ops import conv_block as cb
from hpfg_tpu_torch.ops import ssnet_memory as tmem
from hpfg_tpu_torch.ops import vat as tvat
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.utils.jax_weights import (
    flatten_tree,
    load_jax_state,
    module_arrays,
    module_variables,
)
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

REL_TOL = 1e-4
PARAM_ATOL = 1e-4
METRIC_RTOL = 1e-4
HW, LB, UB, FT = 32, 2, 2, 8


def _rel(got, ref, tol=REL_TOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max() / scale
    assert err <= tol, f"{what}: rel err {err:.2e} > {tol}"


def _flax():
    return FlaxSSNet(in_channels=1, num_classes=4, feature_chns=(FT,) * 5,
                     dropout=(0.0,) * 5)


@pytest.fixture(scope="module")
def pair():
    """A narrow port SSNet (weights from seed 3, BN statistics moved off
    their init) and its flax variables."""
    model = SSNet(1, 4, (FT,) * 5, (0.0,) * 5,
                  generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(("mean", "var")):
                buf.copy_(torch.rand(buf.shape) * 0.5 + 0.5 * (
                    name.endswith("var")))
    params, stats = module_variables(model)
    return model, {"params": params, "batch_stats": stats}


def _x(seed, n=LB + UB):
    return np.random.default_rng(seed).normal(size=(n, HW, HW, 1)).astype(
        np.float32)


def test_ssnet_forward_and_heads_match_flax(pair):
    model, variables = pair
    fm = _flax()
    x = _x(0)
    for train in (False, True):
        (lj, fj), _ = fm.apply(variables, x, train=train,
                               mutable=["batch_stats"])
        lt, ft = model(torch.from_numpy(x), train=train, fold=False)
        _rel(lt.detach(), lj, what=f"logits train={train}")
        _rel(ft.detach(), fj, what=f"features train={train}")
    rows = np.array(fj).reshape(-1, FT)
    rt = torch.from_numpy(rows)
    for train in (False, True):
        def heads(method, *a):
            return fm.apply(variables, *a, train=train, method=method,
                            mutable=["batch_stats"])[0]
        pj = heads(FlaxSSNet.project, rows)
        pt = model.project(rt, train=train, fold=False)
        _rel(pt.detach(), pj, what=f"project train={train}")
        qj = heads(FlaxSSNet.predict, pj)
        qt = model.predict(pt, train=train, fold=False)
        _rel(qt.detach(), qj, what=f"predict train={train}")
        for c in range(4):
            _rel(model.select(c, qt, train=train, fold=False).detach(),
                 heads(FlaxSSNet.select, c, qj), what=f"select {c}")
            _rel(model.select_memory(c, qt, train=train,
                                     fold=False).detach(),
                 heads(FlaxSSNet.select_memory, c, qj),
                 what=f"select_memory {c}")
    _rel(model.val(torch.from_numpy(x)).detach(),
         fm.apply(variables, x, method=FlaxSSNet.val), what="val")


def test_forward_without_folding_leaves_bn_buffers(pair):
    model, _ = pair
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.from_numpy(_x(1))
    _, feat = model(x, train=True, fold=False)
    model.project(feat.reshape(-1, FT), train=True, fold=False)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    model(x, train=True)  # folding (the default) moves them
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert moved and all(k.endswith(("mean", "var")) for k in moved)
    model.load_state_dict(before)


def test_vat_loss_and_grads_match_jax(pair, monkeypatch):
    """LDS and its gradients against ``hpfg_tpu.ops.vat.vat_loss`` (frozen
    parameters for the clean and inner passes on both sides), the d
    injected; the inner gradient calls no weight-gradient kernel.

    The inner gradient is the model's gradient with respect to its input,
    through every LeakyReLU and max pool: where the two forwards differ in
    the last bit at an activation within an ulp of a kink, the derivative
    there differs by O(1) (a kink, not an error), and train-mode BN
    spreads that over the batch. The input seed here is one where no such
    activation occurs (the gradients agree to about 1e-5 of their
    magnitude)."""
    model, variables = pair
    fm = _flax()
    x = _x(4)
    rng = jax.random.PRNGKey(7)
    d = np.array(jax.random.uniform(rng, x.shape, jnp.float32) - 0.5)

    def jax_lds(params):
        v = dict(variables, params=params)
        frozen = jax.tree_util.tree_map(jax.lax.stop_gradient, v)

        def apply(vs):
            return lambda xv: fm.apply(vs, xv, train=True,
                                       mutable=["batch_stats"])[0][0]

        return jvat.vat_loss(apply(v), jnp.asarray(x), rng,
                             apply_fn_frozen=apply(frozen))

    lds_j, grads_j = jax.value_and_grad(jax_lds)(variables["params"])

    calls = {"wgrad": 0}
    for name in ("conv3x3_wgrad_nhwc", "conv3x3_wgrad_pair"):
        real = getattr(cb, name)

        def counted(*a, _real=real, **k):
            calls["wgrad"] += 1
            return _real(*a, **k)

        monkeypatch.setattr(cb, name, counted)
    frozen = {k: p.detach() for k, p in model.named_parameters()}
    wgrads_in_inner = []

    def apply_frozen(xv):
        wgrads_in_inner.append(calls["wgrad"])
        return torch.func.functional_call(
            model, frozen, (xv,), dict(train=True, fold=False))[0]

    model.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x)
    lds_t = tvat.vat_loss(lambda xv: model(xv, train=True, fold=False)[0],
                          xt, torch.from_numpy(d),
                          apply_fn_frozen=apply_frozen)
    assert calls["wgrad"] == 0 and wgrads_in_inner == [0, 0]
    lds_t.backward()
    assert calls["wgrad"] > 0  # the outer backward does run them
    _rel(lds_t.item(), float(lds_j), what="lds")
    ref = flatten_tree(grads_j)
    scale = max(np.abs(v).max() for v in ref.values())
    for k, p in model.named_parameters():
        if k.endswith(("conv1.bias", "conv2.bias")):
            # a ConvBlock's conv bias feeds train-mode BN, whose batch mean
            # absorbs it: exactly zero in the port, rounding noise in JAX
            assert torch.equal(p.grad, torch.zeros_like(p.grad)), k
            assert np.abs(ref[k]).max() <= REL_TOL * scale, k
            continue
        g = torch.zeros_like(p) if p.grad is None else p.grad  # heads
        err = np.abs(g.numpy() - ref[k]).max() / scale
        assert err <= REL_TOL, f"grad {k}: rel err {err:.2e}"
    model.zero_grad(set_to_none=True)


def test_vat_passes_share_one_dropout_draw(monkeypatch):
    """The three VAT passes of a step draw the same dropout masks (the
    encoder's five ConvBlocks each: a mask is a hash of its seed and keep
    probability), and the main forward others."""
    seeds = []
    real = layers.HashDropout

    def recording(seed, keep):
        seeds.append((seed, keep))
        return real(seed, keep)

    monkeypatch.setattr(layers, "HashDropout", recording)
    algo = build_algorithm("ssnet", _cfg(dropout=[0.05, 0.1, 0.2, 0.3, 0.5]),
                           device="cpu")
    algo.step(_batch(np.random.default_rng(4)))
    assert len(seeds) == 4 * 5  # main, clean, inner, final
    main, clean, inner, final = (seeds[i:i + 5] for i in range(0, 20, 5))
    assert clean == inner == final and main != clean


@pytest.mark.parametrize("in_hw,out_hw", [((2, 2), (4, 4)),
                                          ((7, 7), (14, 14)),
                                          ((5, 3), (11, 8))])
def test_deterministic_resize_backward_matches_torch(in_hw, out_hw):
    """SSNet's upsample backward (two fp32 matmuls, the same sums every
    run) against the autograd backward of torch's align-corners resize."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, *in_hw, 3), generator=gen, dtype=torch.float64)
    dy = torch.randn((2, *out_hw, 3), generator=gen, dtype=torch.float64)
    grads = []
    for deterministic in (True, False):
        xi = x.float().requires_grad_(True)
        y = layers.resize_bilinear_align_corners(xi, out_hw, deterministic)
        y.backward(dy.float())
        grads.append((y.detach(), xi.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    _rel(grads[0][1], grads[1][1], tol=1e-6, what="dx")


@pytest.mark.parametrize("case", ["fewer", "more", "zero", "ties"])
def test_update_memory_matches_jax(case):
    rng = np.random.default_rng({"fewer": 0, "more": 1, "zero": 2,
                                 "ties": 3}[case])
    c, k, f = 4, 8, 6
    n = {"fewer": 20, "more": 200, "zero": 200, "ties": 300}[case]
    feats = rng.normal(size=(n, f)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    cand = rng.random(n) < 0.7
    if case == "fewer":  # 5 rows of each class, 3 or 4 of them candidates
        labels = np.arange(n, dtype=np.int32) % c
        cand = np.arange(n) % 5 != 0
    if case == "zero":
        cand &= labels != 2
    if case == "ties":
        scores = rng.choice([0.25, 0.5, 0.75], size=(c, n)).astype(
            np.float32)
    else:
        scores = rng.random((c, n)).astype(np.float32)
    mem = rng.normal(size=(c, k, f)).astype(np.float32)
    valid = rng.random((c, k)) < 0.5
    mj, vj = jmem.update_memory(jnp.asarray(feats), jnp.asarray(labels),
                                jnp.asarray(cand), jnp.asarray(scores),
                                jnp.asarray(mem), jnp.asarray(valid), c)
    mt, vt = tmem.update_memory(*(torch.from_numpy(a) for a in (
        feats, labels, cand, scores, mem, valid)), c)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    counts = [(cand & (labels == i)).sum() for i in range(c)]
    if case == "fewer":
        assert 0 < min(counts) and max(counts) < k
    if case in ("more", "ties"):
        assert min(counts) > k
    if case == "zero":
        assert counts[2] == 0
        np.testing.assert_array_equal(mt[2].numpy(), mem[2])


def test_contrastive_loss_matches_jax():
    rng = np.random.default_rng(5)
    c, k, f, n = 4, 8, 6, 120
    feats = rng.normal(size=(n, f)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    labels[labels == 3] = 2  # a class without rows
    mem = rng.normal(size=(c, k, f)).astype(np.float32)
    valid = rng.random((c, k)) < 0.7
    valid[1, 1:] = False  # a class with one valid slot
    ws = rng.normal(size=(2, c, f, 1)).astype(np.float32)

    def jax_loss(fe, w):
        return jmem.contrastive_class_to_class_learned_memory(
            fe, jnp.asarray(labels), c, jnp.asarray(mem), jnp.asarray(valid),
            lambda i, x: x @ w[0, i], lambda i, x: x @ w[1, i])

    val_j, (gf_j, gw_j) = jax.value_and_grad(jax_loss, (0, 1))(
        jnp.asarray(feats), jnp.asarray(ws))
    fe = torch.tensor(feats, requires_grad=True)
    w = torch.tensor(ws, requires_grad=True)
    val_t = tmem.contrastive_class_to_class_learned_memory(
        fe, torch.from_numpy(labels), c, torch.from_numpy(mem),
        torch.from_numpy(valid), lambda i, x: x @ w[0, i],
        lambda i, x: x @ w[1, i])
    val_t.backward()
    _rel(val_t.item(), float(val_j), what="loss")
    _rel(fe.grad, gf_j, what="grad features")
    _rel(w.grad, gw_j, what="grad selectors")


def _cfg(**kw):
    base = dict(algorithm="ssnet", model="ssnet", feature_chns=[FT] * 5,
                dropout=[0.0] * 5, num_classes=4, in_channels=1,
                train_crop_size=[HW, HW], batch_size=LB,
                unlabel_batch_size=UB, consistency=1.0,
                consistency_rampup=4.0, epoch_unit_iters=1, seed=0,
                total_itrs=30, step_size=10, opt="sgd", lr=0.05,
                weight_decay=1e-4, momentum=0.9, sched="medical")
    base.update(kw)
    return Config(base)


def _batch(rng):
    return {
        "label_img": rng.normal(size=(LB, HW, HW, 1)).astype(np.float32),
        "label": rng.integers(0, 4, (LB, HW, HW)).astype(np.int32),
        "unlabel_img": rng.normal(size=(UB, HW, HW, 1)).astype(np.float32),
    }


def test_three_ssnet_steps_match_jax():
    """Three steps against ``jax.jit(SSNetAlgorithm.step)`` (its model the
    narrow flax SSNet), from the variables of a port algorithm built from
    another seed; the memory bank, empty at the start, must come out equal
    too. As in the VAT test, a last-bit difference at an activation within
    an ulp of a LeakyReLU or max-pool kink moves the input gradient, and
    so the LDS term, by O(1) there; the data seed here is one where that
    happens in none of the three steps (seeds 6 and 9 hit one)."""
    jalgo = jax_build_algorithm("ssnet", _cfg(), dtype=jnp.float32)
    jalgo.model = _flax()
    src = build_algorithm("ssnet", _cfg(seed=1), device="cpu")
    params, stats = module_variables(src.model)
    state = SSNetState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        model=ModelState(params=params, batch_stats=stats),
        opt_state=jalgo.tx.init(params),
        memory=jnp.zeros((4, 32, 32), jnp.float32),
        memory_valid=jnp.zeros((4, 32), bool))
    talgo = build_algorithm("ssnet", _cfg(), device="cpu")
    load_jax_state(talgo, jax.device_get(state))

    step = jax.jit(jalgo.step)
    rng = np.random.default_rng(7)
    for _ in range(3):
        batch = _batch(rng)
        v_rng = jax.random.split(state.rng, 4)[2]  # the step's VAT key
        d = np.array(jax.random.uniform(
            v_rng, (LB + UB, HW, HW, 1), jnp.float32) - 0.5)
        state, m_j = step(state, batch)
        m_t = talgo.step(batch, d=torch.from_numpy(d))
        assert set(m_t) == set(m_j)
        for k in m_j:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=k)
    host = jax.device_get(state)
    np.testing.assert_array_equal(talgo.memory_valid.numpy(),
                                  np.asarray(host.memory_valid))
    assert talgo.memory_valid.any()
    np.testing.assert_allclose(talgo.memory.numpy(), np.asarray(host.memory),
                               atol=PARAM_ATOL, rtol=0)
    ref = flatten_tree(host.model.params)
    ref.update(flatten_tree(host.model.batch_stats))
    got = module_arrays(talgo.model)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)
    # the bank is state: it survives state_dict / load_state_dict
    fresh = build_algorithm("ssnet", _cfg(seed=5), device="cpu")
    fresh.load_state_dict(talgo.state_dict())
    assert torch.equal(fresh.memory, talgo.memory)
    assert torch.equal(fresh.memory_valid, talgo.memory_valid)
