"""Three ICT-MedSeg steps of the port against ``jax.jit(ICTMedSeg.step)``
on the CPU: a tiny UNet (feature_chns [8]*5, no dropout, SGD) and its EMA
teacher, 32x32 inputs, 2 labelled + 4 unlabelled images (two mixed
pairs). The mixing factors are the JAX step's own Beta draw, reproduced
from ``jax.random.split(state.rng, 4)`` and injected into the port.

Tolerances (fp32 on both sides): the step metrics to 1e-5 relative (the
same functions of the same values, summed in other orders); after three
steps parameters, EMA parameters and BN statistics, the teacher's folded
twice a step in order, to 1e-4 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hpfg_tpu.config import Config
from hpfg_tpu.train.algorithms import build_algorithm as jax_build_algorithm
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.train.algorithms.ict import sample_beta
from hpfg_tpu_torch.utils.jax_weights import (
    flatten_tree,
    load_jax_state,
    module_arrays,
)
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

PARAM_ATOL = 1e-4
METRIC_RTOL = 1e-5
HW, LB, UB = 32, 2, 4
ALPHA = 0.2


def _cfg(**kw):
    base = dict(algorithm="ict", model="unet", feature_chns=[8] * 5,
                dropout=[0.0] * 5, num_classes=4, in_channels=1,
                train_crop_size=[HW, HW], batch_size=LB,
                unlabel_batch_size=UB, consistency=1.0,
                consistency_rampup=4.0, epoch_unit_iters=1, ema_decay=0.99,
                ict_alpha=ALPHA, seed=0, total_itrs=30, step_size=10,
                opt="sgd", lr=0.05, weight_decay=1e-4, momentum=0.9,
                sched="medical")
    base.update(kw)
    return Config(base)


def _batch(rng):
    return {
        "label_img": rng.normal(size=(LB, HW, HW, 1)).astype(np.float32),
        "label": rng.integers(0, 4, (LB, HW, HW)).astype(np.int32),
        "unlabel_img": rng.normal(size=(UB, HW, HW, 1)).astype(np.float32),
    }


def _assert_models_match(talgo, state, atol):
    host = jax.device_get(state)
    for name in ("model", "ema"):
        mstate = getattr(host, name)
        ref = flatten_tree(mstate.params)
        ref.update(flatten_tree(mstate.batch_stats))
        got = module_arrays(getattr(talgo, name))
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, atol=atol, rtol=0,
                                       err_msg=f"{name}.{k}")


def test_three_ict_steps_match_jax():
    cfg = _cfg()
    jalgo = jax_build_algorithm("ict", cfg, dtype=jnp.float32)
    state = jax.jit(jalgo.init_state)(jax.random.PRNGKey(0))
    talgo = build_algorithm("ict", cfg, dtype=torch.float32, device="cpu")
    load_jax_state(talgo, jax.device_get(state))
    _assert_models_match(talgo, state, 0.0)

    step = jax.jit(jalgo.step)
    rng = np.random.default_rng(11)
    for _ in range(3):
        batch = _batch(rng)
        mix_rng = jax.random.split(state.rng, 4)[3]  # the step's mix key
        factors = np.asarray(jax.random.beta(mix_rng, ALPHA, ALPHA,
                                             (UB // 2, 1, 1, 1)))
        state, m_j = step(state, batch)
        m_t = talgo.step(batch, factors=torch.tensor(factors))
        assert set(m_t) == set(m_j)
        for k in m_j:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=METRIC_RTOL, atol=1e-8,
                                       err_msg=k)
    assert talgo.step_count == int(state.step) == 3
    _assert_models_match(talgo, state, PARAM_ATOL)
    assert set(talgo.eval_models()) == {"model1", "model2"}


def test_beta_draws_and_aliases():
    """The G1/(G1+G2) Beta draw has Beta(a, a)'s mean 1/2 and variance
    1/(4(2a+1)) (to 5 standard errors over 200k draws), lies in [0, 1] and
    is reproducible from the generator; ``ict_medseg`` and ``scc`` name
    the same trainer, and a step draws its own factors."""
    gen = torch.Generator().manual_seed(3)
    f = sample_beta(ALPHA, (200_000,), gen, "cpu").double()
    assert bool(((f >= 0) & (f <= 1)).all())
    var = 1.0 / (4.0 * (2 * ALPHA + 1))
    n = f.numel()
    assert abs(f.mean().item() - 0.5) < 5 * (var / n) ** 0.5
    assert abs(f.var().item() - var) < 5 * 2 * var / n ** 0.5
    again = sample_beta(ALPHA, (200_000,), torch.Generator().manual_seed(3),
                        "cpu").double()
    assert torch.equal(f, again)
    for name in ("ict_medseg", "scc"):
        algo = build_algorithm(name, _cfg(), device="cpu")
        assert type(algo).__name__ == "ICTMedSeg"
    algo = build_algorithm("ict", _cfg(), device="cpu")
    m = algo.step(_batch(np.random.default_rng(0)))
    assert np.isfinite(float(m["loss"]))
