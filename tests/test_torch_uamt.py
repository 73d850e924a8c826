"""UAMT steps of the port against ``jax.jit(UAMT.step)`` on the CPU: a
tiny UNet (feature_chns [8]*5, no dropout, SGD) and its EMA teacher, 32x32
inputs, 2 labelled + 2 unlabelled images. Three steps in ``mc_mode`` map
and one in ``unroll`` with ``mc_chunk`` 2 (the reference's doubled-batch
statistics). The input noise of the target pass and of the eight MC passes
is the JAX step's own draw, reproduced from ``jax.random.split(state.rng,
5)`` and injected into the port.

Tolerances (fp32 on both sides): the step metrics, the threshold among
them, to 1e-5 relative; after the steps parameters, EMA parameters and BN
statistics to 1e-4 absolute. The MC passes must leave the teacher's
statistics as the one target pass folds them, which the statistics'
comparison checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.config import Config
from hpfg_tpu.ops.rampup import sigmoid_rampup as jax_sigmoid_rampup
from hpfg_tpu.train.algorithms import build_algorithm as jax_build_algorithm
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.utils.jax_weights import (
    flatten_tree,
    load_jax_state,
    module_arrays,
)
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

PARAM_ATOL = 1e-4
METRIC_RTOL = 1e-5
HW, LB, UB, T = 32, 2, 2, 8


def _cfg(**kw):
    base = dict(algorithm="uamt", model="unet", feature_chns=[8] * 5,
                dropout=[0.0] * 5, num_classes=4, in_channels=1,
                train_crop_size=[HW, HW], batch_size=LB,
                unlabel_batch_size=UB, consistency=1.0,
                consistency_rampup=4.0, epoch_unit_iters=1, ema_decay=0.99,
                seed=0, total_itrs=6, step_size=10, opt="sgd", lr=0.05,
                weight_decay=1e-4, momentum=0.9, sched="medical")
    base.update(kw)
    return Config(base)


def _noise(key, shape):
    return np.asarray(jnp.clip(jax.random.normal(key, shape) * 0.1,
                               -0.2, 0.2))


def _step_noise(state):
    """The JAX step's target-pass noise and its T MC noises."""
    _, _, _, n_rng, mc_rng = jax.random.split(state.rng, 5)
    shape = (UB, HW, HW, 1)
    keys = jax.random.split(mc_rng, T)
    return [torch.tensor(_noise(n_rng, shape))] + [
        torch.tensor(_noise(k, shape)) for k in keys]


@pytest.mark.parametrize("mode,steps", [("map", 3), ("unroll", 1)])
def test_uamt_steps_match_jax(mode, steps):
    cfg = _cfg(mc_mode=mode, mc_chunk=2)
    jalgo = jax_build_algorithm("uamt", cfg, dtype=jnp.float32)
    state = jax.jit(jalgo.init_state)(jax.random.PRNGKey(0))
    talgo = build_algorithm("uncertainty_aware", cfg, dtype=torch.float32,
                            device="cpu")
    assert talgo.mc_mode == mode
    load_jax_state(talgo, jax.device_get(state))

    step = jax.jit(jalgo.step)
    rng = np.random.default_rng(13)
    for _ in range(steps):
        batch = {
            "label_img": rng.normal(size=(LB, HW, HW, 1)).astype(np.float32),
            "label": rng.integers(0, 4, (LB, HW, HW)).astype(np.int32),
            "unlabel_img": rng.normal(size=(UB, HW, HW, 1)).astype(
                np.float32),
        }
        noise = _step_noise(state)
        state, m_j = step(state, batch)
        m_t = talgo.step(batch, noise=noise)
        assert set(m_t) == set(m_j)
        for k in m_j:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=METRIC_RTOL, atol=1e-8,
                                       err_msg=k)
    assert talgo.step_count == int(state.step) == steps

    host = jax.device_get(state)
    for name in ("model", "ema"):
        mstate = getattr(host, name)
        ref = flatten_tree(mstate.params)
        ref.update(flatten_tree(mstate.batch_stats))
        got = module_arrays(getattr(talgo, name))
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name}.{k}")


def test_threshold_and_own_draws():
    """The threshold (0.75 + 0.25 sigmoid_rampup(it, total)) ln 2 against
    the JAX expression at every iteration, and a step with the port's own
    noise, dropout and injected dropout seeds."""
    cfg = _cfg(total_itrs=10, dropout=[0.1] * 5)
    talgo = build_algorithm("uamt", cfg, dtype=torch.float32, device="cpu")
    for it in range(0, 13):
        ref = (0.75 + 0.25 * jax_sigmoid_rampup(it, 10)) * jnp.log(2.0)
        np.testing.assert_allclose(talgo.threshold(it), float(ref),
                                   rtol=1e-6)
    rng = np.random.default_rng(0)
    batch = {"label_img": rng.normal(size=(LB, HW, HW, 1)).astype(np.float32),
             "label": rng.integers(0, 4, (LB, HW, HW)).astype(np.int32),
             "unlabel_img": rng.normal(size=(UB, HW, HW, 1)).astype(
                 np.float32)}
    m = talgo.step(batch)
    m2 = talgo.step(batch, dropout_seeds=list(range(T + 1)))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m2["loss"]))
    with pytest.raises(ValueError):
        build_algorithm("uamt", _cfg(mc_mode="unroll", mc_chunk=3),
                        device="cpu")
