"""Three S4CVNet steps of the port against ``jax.jit(S4CVNet.step)`` on the
CPU: model1 a tiny UNet (feature_chns [8]*5, no dropout, SGD), model2 a
tiny two-stage SwinUNet (embed 8, depths (2, 2), heads (1, 2), window 2,
drop rates 0, adamW, as the config), the EMA teacher of model2, 32x32
inputs, 2+4 images. Two stages keep every kind of module (shifted windows,
patch merging and expansion, the skip fusion) at half the compile of four;
``test_torch_swinunet.py`` holds the four-stage tiny geometry against
flax.

The JAX side's model2 is that flax SwinUNet set on ``algo.net2`` (the
registry would build the 224² one). Its state is a ``TeacherDualState`` laid
out as ``init_state`` lays it out, with the variables of a second port
algorithm built from another seed: flax's own init would cost a whole
compile of both models on the CPU. The port then loads that state with
``load_jax_state``. The teacher's input noise is the JAX step's own draw,
reproduced from ``jax.random.split(state.rng, 5)`` and injected into the
port. ``mt_gate_iters`` is 0 on both sides, so the MT consistency terms run
from the first step.

Tolerances (fp32 on both sides): the step metrics to 1e-5 relative (the
same functions of the same values, summed in other orders); after three
steps parameters to 1e-4 absolute.

adamW's first updates are nearly +-lr whatever the gradient's size, and
the pseudo-labels are an argmax: a last-bit difference that flips one
pseudo-label, or the sign of a near-zero gradient, moves a parameter by
O(lr) = 8e-4. The weights' seed and the data seed here are ones where
neither happens within three steps (the parameters agree to about 1e-6),
so the comparison measures the arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.config import Config
from hpfg_tpu.models.swinunet import SwinUNet as FlaxSwinUNet
from hpfg_tpu.train.algorithms import build_algorithm as jax_build_algorithm
from hpfg_tpu.train.algorithms.base import ModelState
from hpfg_tpu.train.algorithms.dual import TeacherDualState
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.utils.jax_weights import (
    flatten_tree,
    load_jax_state,
    module_arrays,
    module_variables,
)
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

PARAM_ATOL = 1e-4
METRIC_RTOL = 1e-5
HW, LB, UB = 32, 2, 4
SWIN = dict(embed_dim=8, depths=[2, 2], num_heads=[1, 2],
            window_size=2, drop_rate=0.0, attn_drop_rate=0.0,
            drop_path_rate=0.0)
#: the seed of the weights the JAX state starts from, and of the batches
WEIGHT_SEED, DATA_SEED = 1, 1


def _cfg(seed=0):
    common = dict(in_channels=1, num_classes=4, sched="medical",
                  total_itrs=30, step_size=10)
    return Config(dict(
        algorithm="s4cvnet", num_classes=4, in_channels=1,
        train_crop_size=[HW, HW], batch_size=LB, unlabel_batch_size=UB,
        consistency=0.1, consistency_rampup=4.0, epoch_unit_iters=1,
        ema_decay=0.99, seed=seed,
        model1=dict(model="unet", feature_chns=[8] * 5, dropout=[0.0] * 5,
                    opt="sgd", lr=0.01, weight_decay=5e-4, momentum=0.9,
                    **common),
        model2=dict(model="swinunet", opt="adamW", lr=0.0008,
                    weight_decay=0.05, **SWIN, **common)))


def _model_state(module) -> ModelState:
    """A port module's variables as a flax ModelState: parameters, and the
    BN running statistics (buffers) as ``batch_stats``."""
    params, batch_stats = module_variables(module)
    return ModelState(params=params, batch_stats=batch_stats)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX algorithm (tiny flax SwinUNet as net2) and its start state,
    laid out as ``init_state`` lays it out."""
    jcfg = _cfg()
    jcfg.model2.model = "unet"  # its registry has no 32 px SwinUNet
    jalgo = jax_build_algorithm("s4cvnet", jcfg, dtype=jnp.float32)
    jalgo.net2 = FlaxSwinUNet(
        in_channels=1, num_classes=4, use_pallas=False,
        **{k: tuple(v) if isinstance(v, list) else v
           for k, v in SWIN.items()})
    jalgo.mt_gate_iters = 0
    src = build_algorithm("s4cvnet", _cfg(WEIGHT_SEED), dtype=torch.float32,
                          device="cpu")
    m1, m2 = _model_state(src.model1), _model_state(src.model2)
    state = TeacherDualState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        model1=m1, model2=m2, ema=jax.tree_util.tree_map(jnp.copy, m2),
        opt_state1=jalgo.tx1.init(m1.params),
        opt_state2=jalgo.tx2.init(m2.params))
    assert not state.model2.batch_stats  # a SwinUNet has no BN
    return jalgo, state


def test_three_s4cvnet_steps_match_jax(jax_side):
    jalgo, state = jax_side
    talgo = build_algorithm("s4cvnet", _cfg(), dtype=torch.float32,
                            device="cpu")
    talgo.mt_gate_iters = 0
    own = module_arrays(talgo.model2)["decoder.head.kernel"].copy()
    load_jax_state(talgo, jax.device_get(state))
    for name in ("model1", "model2", "ema"):
        mstate = getattr(state, name)
        ref = flatten_tree(mstate.params)
        ref.update(flatten_tree(mstate.batch_stats))
        got = module_arrays(getattr(talgo, name))
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{name}.{k}")
    assert not np.array_equal(own, module_arrays(talgo.model2)[
        "decoder.head.kernel"])

    step = jax.jit(jalgo.step)
    rng = np.random.default_rng(DATA_SEED)
    for _ in range(3):
        batch = {
            "label_img": rng.normal(size=(LB, HW, HW, 1)).astype(np.float32),
            "label": rng.integers(0, 4, (LB, HW, HW)).astype(np.int32),
            "unlabel_img": rng.normal(size=(UB, HW, HW, 1)).astype(
                np.float32),
        }
        rn = jax.random.split(state.rng, 5)[4]  # the step's noise key
        noise = np.asarray(jnp.clip(
            jax.random.normal(rn, (UB, HW, HW, 1)) * 0.1, -0.2, 0.2))
        state, m_j = step(state, batch)
        m_t = talgo.step(batch, noise=torch.tensor(noise))
        assert set(m_t) == set(m_j)
        for k in m_j:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=METRIC_RTOL, atol=1e-8,
                                       err_msg=k)
    assert talgo.step_count == int(state.step) == 3

    host = jax.device_get(state)
    for name in ("model1", "model2", "ema"):
        mstate = getattr(host, name)
        ref = flatten_tree(mstate.params)
        ref.update(flatten_tree(mstate.batch_stats))
        got = module_arrays(getattr(talgo, name))
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name}.{k}")
    assert type(talgo.model2).__name__ == "SwinUNet"
    assert set(talgo.eval_models()) == {"model1", "model2", "ema"}
