"""Three CTCT steps of the port against ``jax.jit(CTCT.step)`` on the CPU:
model1 a tiny UNet (feature_chns [8]*5, no dropout, SGD), model2 a tiny
SegFormer (the MiT ``T``: widths 8/16/40/64, one block a stage, added to
both packages' ``MIT_SETTINGS`` for this module; adamW, as the config), 32x32
inputs, 2 labelled + 4 unlabelled images, the consistency ramp at 1 from
the first step so that the Dice pseudo-supervision counts.

The JAX side's model2 is that flax SegFormer set on ``algo.net2`` (its
registry builds B0). Its head's Dropout and its DropPaths are made the
identity by tracing the step inside ``flax.linen.intercept_methods`` (the
flax modules hard-code their rates); the port's rates are 0. The JAX state
is a ``DualState`` laid out as ``init_state`` lays it out, with the
variables of a port algorithm built from another seed.

Tolerances (fp32 on both sides): the step metrics to 1e-5 relative; after
three steps parameters and BN statistics to 1e-4 absolute, but for the
five parameters the loss does not depend on and the head's BN running
mean, which are held to what that independence predicts (below).

adamW's first updates are nearly +-lr whatever the gradient's size, and
the pseudo-labels are an argmax: a last-bit difference that flips one
pseudo-label, or the sign of a near-zero gradient, moves a parameter by
O(lr) = 8e-4. The seed pairs (weights, data) here are ones where no
pseudo-label flips within three steps (at (2, 2) one flips: encoder
kernels then differ by 3e-4).

The SegFormer has five parameters whose exact gradient is zero
(``segformer.BN_INVARIANT``): the biases of the head's ``linear_c1..4`` and
of the encoder's last LayerNorm ``norm4`` add a constant to each channel of
the fused features, which the train-mode BatchNorm after ``linear_fuse``
subtracts again. Both sides compute their gradient as rounding noise
(about 1e-9), which adamW turns into steps of up to lr: those parameters
are held to 3 lr (three steps) against each other, and the port's gradient
of each to 1e-4 of the head's largest kernel gradient. The BatchNorm's
running mean does see the constant: each forward adds ``linear_fuse``'s
image of the two sides' difference in those biases to the batch mean, so
the running means differ by 0.1 (0.81 d1 + 0.9 d2 + d3), d_k that image at
step k. The running mean is held to that prediction within 1e-5 (the rest
measured at most 2.2e-6 over the seed pairs (1, 1), (3, 3), (5, 5); the
difference itself reaches 9.6e-5). ``linear_fuse``'s kernel is held to 1e-4
like every other leaf; that holds on the seed pairs here but not on every
pair: at (5, 5), where no pseudo-label flips, two of its elements differ
by 2.8e-4 and 1.5e-4. There one of the head's ReLU inputs lies 9e-7 from
zero at the second step (3e-6 or more at the other pairs), within the two
sides' rounding; ReLU's kink taken on opposite sides moves
``linear_fuse``'s gradient by up to 7e-3 of its largest magnitude (the
SegFormer GPU test in ``tests/test_torch_gpu_kernels.py`` shows it between
the card and the CPU). That is the cause: with ReLU replaced by softplus
in both packages the three steps at (5, 5) hold every leaf, ``linear_fuse``
included (5e-5), to 1e-4 (``tests/test_torch_rounding_truth.py``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.config import Config
from hpfg_tpu.models import segformer as jseg
from hpfg_tpu.train.algorithms import build_algorithm as jax_build_algorithm
from hpfg_tpu.train.algorithms.dual import DualState
from hpfg_tpu_torch.models import segformer as tseg
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.utils.jax_weights import (
    flatten_tree,
    load_jax_state,
    module_arrays,
)
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401
from tests.test_torch_segformer import TINY_MIT, no_dropout
from tests.test_torch_supervised_cps import (
    assert_metrics_match,
    assert_models_match,
    model_state,
)

HW, LB, UB = 32, 2, 4
#: (weight seed, data seed) pairs
SEEDS = [(3, 3), (4, 4)]
#: the SegFormer's parameters off the loss (BatchNorm removes them)
BN_INVARIANT = sorted(tseg.BN_INVARIANT)


def _cfg(seed=0):
    common = dict(in_channels=1, num_classes=4, sched="medical",
                  total_itrs=30, step_size=10)
    return Config(dict(
        algorithm="ctct", num_classes=4, in_channels=1,
        train_crop_size=[HW, HW], batch_size=LB, unlabel_batch_size=UB,
        consistency=1.0, consistency_rampup=0.0, epoch_unit_iters=1,
        seed=seed,
        model1=dict(model="unet", feature_chns=[8] * 5, dropout=[0.0] * 5,
                    opt="sgd", lr=0.01, weight_decay=5e-4, momentum=0.9,
                    **common),
        model2=dict(model="segformer", mit="T", drop_rate=0.0,
                    drop_path_rate=0.0, opt="adamW", lr=0.0008,
                    weight_decay=0.05, **common)))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX algorithm (the tiny flax SegFormer as net2) and its jitted
    step, shared by the seeds, with the tiny MiT in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jseg.MIT_SETTINGS, "T", TINY_MIT)
        mp.setitem(tseg.MIT_SETTINGS, "T", TINY_MIT)
        jcfg = _cfg()
        jcfg.model2.model = "unet"  # its registry builds the B0 SegFormer
        jalgo = jax_build_algorithm("ctct", jcfg, dtype=jnp.float32)
        jalgo.net2 = jseg.SegFormer(image_size=(HW, HW), in_channels=1,
                                    num_classes=4, model_name="T")
        yield jalgo, jax.jit(jalgo.step)


def _start_state(jalgo, seed):
    """A ``DualState`` laid out as ``init_state`` lays it out, with the
    variables of a port algorithm built from ``seed``."""
    src = build_algorithm("ctct", _cfg(seed), dtype=torch.float32,
                          device="cpu")
    m1, m2 = model_state(src.model1), model_state(src.model2)
    state = DualState(step=jnp.zeros((), jnp.int32),
                      rng=jax.random.PRNGKey(0), model1=m1, model2=m2,
                      opt_state1=jalgo.tx1.init(m1.params),
                      opt_state2=jalgo.tx2.init(m2.params))
    assert set(state.model2.batch_stats["decoder"]) == {"bn"}
    return state


def _fused_shift(params):
    """The per-channel constant the BN-invariant biases add to the input of
    ``linear_fuse`` (its channels are c4, c3, c2, c1)."""
    shift = [params[f"decoder.linear_c{i}.bias"] for i in (4, 3, 2, 1)]
    shift[0] = shift[0] + (params["encoder.norm4.bias"]
                           @ params["decoder.linear_c4.kernel"])
    return np.concatenate(shift)


@pytest.mark.parametrize("weight_seed,data_seed", SEEDS)
def test_three_ctct_steps_match_jax(jax_side, weight_seed, data_seed):
    jalgo, step = jax_side
    state = _start_state(jalgo, weight_seed)
    talgo = build_algorithm("ctct", _cfg(), dtype=torch.float32,
                            device="cpu")
    assert type(talgo.model2).__name__ == "SegFormer"
    assert type(talgo.optimizer2).__name__ == "AdamW"
    load_jax_state(talgo, jax.device_get(state))
    assert_models_match(talgo, state, ["model1", "model2"])

    rng = np.random.default_rng(data_seed)
    mean_drift = 0.0  # the BN running means' predicted difference
    for _ in range(3):
        batch = {
            "label_img": rng.normal(size=(LB, HW, HW, 1)).astype(np.float32),
            "label": rng.integers(0, 4, (LB, HW, HW)).astype(np.int32),
            "unlabel_img": rng.normal(size=(UB, HW, HW, 1)).astype(
                np.float32)}
        before = module_arrays(talgo.model2)
        shift = _fused_shift(before) - _fused_shift(flatten_tree(
            jax.device_get(state.model2.params)))
        fuse = before["decoder.linear_fuse.kernel"]
        mean_drift = 0.9 * mean_drift + 0.1 * (
            shift @ fuse.reshape(-1, fuse.shape[-1]))
        with fnn.intercept_methods(no_dropout):
            state, m_j = step(state, batch)
        m_t = talgo.step(batch)
        assert_metrics_match(m_t, m_j)
        assert "lr" not in m_t and float(m_t["consistency_weight"]) == 1.0
        grads = dict(talgo.model2.named_parameters())
        scale = grads["decoder.linear_c1.kernel"].grad.abs().max()
        for k in BN_INVARIANT:
            assert grads[k].grad.abs().max() <= 1e-4 * scale, k
    assert talgo.step_count == int(state.step) == 3
    assert_models_match(talgo, state, ["model1"])
    assert_models_match(talgo, state, ["model2"],
                        skip=BN_INVARIANT + ["decoder.bn.mean"])
    ref = flatten_tree(jax.device_get(state.model2.params))
    got = module_arrays(talgo.model2)
    for k in BN_INVARIANT:
        np.testing.assert_allclose(got[k], ref[k], atol=3 * 0.0008, rtol=0,
                                   err_msg=k)
    ref_mean = np.asarray(jax.device_get(
        state.model2.batch_stats["decoder"]["bn"]["mean"]))
    np.testing.assert_allclose(got["decoder.bn.mean"] - ref_mean, mean_drift,
                               atol=1e-5, rtol=0)
    assert set(talgo.eval_models()) == {"model1", "model2"}
