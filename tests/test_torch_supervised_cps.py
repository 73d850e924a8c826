"""The port's Supervised and CPS steps against ``jax.jit`` of the JAX
package's on the CPU, and the configs these algorithms and the SegFormer
unlock, parsed by the port and built at a reduced size.

Three steps each from the same weights: Supervised on a tiny UNet
(feature_chns [8]*5, no dropout, SGD with the cosine schedule of
configs/unet_30k_224x224_ACDC.yaml, warm-up 0) and on a tiny UNet_Plus
(its necks are off the loss: SGD's weight decay, 0.05 here so that it
shows, and momentum still move them, as optax's do), 6 images a step;
CPS on two tiny UNets (SGD, the medical schedule), 2 labelled + 4
unlabelled images, with the consistency ramp at 1 from the first step so
that the cross pseudo-supervision counts.
32x32 inputs. The JAX states are laid out as ``init_state`` lays them out,
with the variables of a port algorithm built from another seed
(``module_variables``): flax's own init would cost a compile of each model.

Tolerances (fp32 on both sides): the step metrics to 1e-5 relative (the
same functions of the same values, summed in other orders); after three
steps parameters and BN statistics to 1e-4 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.config import Config
from hpfg_tpu.train.algorithms import build_algorithm as jax_build_algorithm
from hpfg_tpu.train.algorithms.base import ModelState
from hpfg_tpu.train.algorithms.dual import DualState
from hpfg_tpu.train.algorithms.supervised import SupervisedState
from hpfg_tpu_torch.config import load_config
from hpfg_tpu_torch.train.algorithms import ALGORITHMS, build_algorithm
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
SUP_BS = LB + UB
TINY_UNET = dict(feature_chns=[8] * 5, dropout=[0.0] * 5)
WEIGHT_SEED, DATA_SEED = 1, 1


def model_state(module) -> ModelState:
    params, batch_stats = module_variables(module)
    return ModelState(params=params, batch_stats=batch_stats)


def assert_models_match(talgo, state, names, skip=()):
    """Every parameter and BN statistic of the named models within
    PARAM_ATOL of the JAX state's, but for the keys in ``skip``."""
    for name in names:
        mstate = jax.device_get(getattr(state, name))
        ref = flatten_tree(mstate.params)
        ref.update(flatten_tree(mstate.batch_stats))
        got = module_arrays(getattr(talgo, name))
        assert set(got) == set(ref)
        for k, v in ref.items():
            if k in skip:
                continue
            np.testing.assert_allclose(got[k], v, atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name}.{k}")


def assert_metrics_match(m_t, m_j):
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                   rtol=METRIC_RTOL, atol=1e-8, err_msg=k)


def _sup_cfg(model, seed=0):
    return Config(dict(
        algorithm="supervised", model=model, num_classes=4, in_channels=1,
        train_crop_size=[HW, HW], batch_size=SUP_BS, seed=seed,
        total_itrs=30, step_size=10, opt="sgd", lr=0.05,
        weight_decay=0.05, momentum=0.9, sched="cosine", warmup_epochs=0,
        warmup_lr=1e-4, min_lr=1e-6, **TINY_UNET))


@pytest.mark.parametrize("model", ["unet", "unet_plus"])
def test_three_supervised_steps_match_jax(model):
    jalgo = jax_build_algorithm("supervised", _sup_cfg(model),
                                dtype=jnp.float32)
    src = build_algorithm("sup", _sup_cfg(model, WEIGHT_SEED),
                          dtype=torch.float32, device="cpu")
    m = model_state(src.model)
    state = SupervisedState(step=jnp.zeros((), jnp.int32),
                            rng=jax.random.PRNGKey(0), model=m,
                            opt_state=jalgo.tx.init(m.params))
    talgo = build_algorithm("supervised", _sup_cfg(model),
                            dtype=torch.float32, device="cpu")
    load_jax_state(talgo, jax.device_get(state))
    start = module_arrays(talgo.model)
    step = jax.jit(jalgo.step)
    rng = np.random.default_rng(DATA_SEED)
    for _ in range(3):
        batch = {
            "image": rng.normal(size=(SUP_BS, HW, HW, 1)).astype(np.float32),
            "label": rng.integers(0, 4, (SUP_BS, HW, HW)).astype(np.int32)}
        state, m_j = step(state, batch)
        assert_metrics_match(talgo.step(batch), m_j)
    assert talgo.step_count == int(state.step) == 3
    assert_models_match(talgo, state, ["model"])
    assert set(talgo.eval_models()) == {"model1"}
    moved = {k.split(".")[0] for k, v in module_arrays(talgo.model).items()
             if np.abs(v - start[k]).max() > 10 * PARAM_ATOL}
    assert moved >= ({"encoder", "decoder", "dense_projection_high",
                      "dense_projection_head"} if model == "unet_plus"
                     else {"encoder", "decoder"})


def _cps_cfg(seed=0):
    common = dict(in_channels=1, num_classes=4, opt="sgd", lr=0.05,
                  weight_decay=5e-4, momentum=0.9, sched="medical",
                  total_itrs=30, step_size=10, **TINY_UNET)
    return Config(dict(
        algorithm="cps", num_classes=4, in_channels=1,
        train_crop_size=[HW, HW], batch_size=LB, unlabel_batch_size=UB,
        consistency=1.0, consistency_rampup=0.0, epoch_unit_iters=1,
        seed=seed, model1=dict(model="unet", **common),
        model2=dict(model="unet", **common)))


def test_three_cps_steps_match_jax():
    jalgo = jax_build_algorithm("cps", _cps_cfg(), dtype=jnp.float32)
    src = build_algorithm("cps", _cps_cfg(WEIGHT_SEED), dtype=torch.float32,
                          device="cpu")
    m1, m2 = model_state(src.model1), model_state(src.model2)
    state = DualState(step=jnp.zeros((), jnp.int32),
                      rng=jax.random.PRNGKey(0), model1=m1, model2=m2,
                      opt_state1=jalgo.tx1.init(m1.params),
                      opt_state2=jalgo.tx2.init(m2.params))
    talgo = build_algorithm("cps", _cps_cfg(), dtype=torch.float32,
                            device="cpu")
    load_jax_state(talgo, jax.device_get(state))
    step = jax.jit(jalgo.step)
    rng = np.random.default_rng(DATA_SEED)
    for _ in range(3):
        batch = {
            "label_img": rng.normal(size=(LB, HW, HW, 1)).astype(np.float32),
            "label": rng.integers(0, 4, (LB, HW, HW)).astype(np.int32),
            "unlabel_img": rng.normal(size=(UB, HW, HW, 1)).astype(
                np.float32)}
        state, m_j = step(state, batch)
        m_t = talgo.step(batch)
        assert_metrics_match(m_t, m_j)
        assert float(m_t["consistency_weight"]) == 1.0
    assert talgo.step_count == int(state.step) == 3
    assert_models_match(talgo, state, ["model1", "model2"])
    assert set(talgo.eval_models()) == {"model1", "model2"}


# the configs that Supervised, CPS, CTCT and the SegFormer let the port
# train: algorithm, the model class of each student, optimizer classes
CONFIGS = {
    "unet_30k_224x224_ACDC": ("supervised", ["UNet"], ["SGD"]),
    "ccnet_unet_30k_100%_224x224_ACDC": ("supervised", ["UNetPlus"],
                                         ["SGD"]),
    "cps_unet_30k_224x224_ACDC": ("cps", ["UNet", "UNet"], ["SGD", "SGD"]),
    "cps_unet_30k_100_224x224_ACDC": ("cps", ["UNet", "UNet"],
                                      ["SGD", "SGD"]),
    "ctct_unet_segformer_30k_224x224_ACDC": ("ctct", ["UNet", "SegFormer"],
                                             ["SGD", "AdamW"]),
    "segformer_30k_224x224_ACDC": ("supervised", ["SegFormer"], ["AdamW"]),
    "ccnet_segformer_30k_224x224_ACDC": (
        "hpfg", ["SegFormerPlus", "SegFormerPlus"], ["AdamW", "AdamW"]),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_parses_and_builds_on_the_cpu(name):
    """Each config as it is in the repo, cut to 32² and (UNets) width 8."""
    algorithm, models, optimizers = CONFIGS[name]
    cfg = load_config(f"configs/{name}.yaml")
    cfg.train_crop_size = [HW, HW]
    for block in (cfg, cfg.get("model1"), cfg.get("model2")):
        if block is not None and str(block.get("model")).startswith("unet"):
            block["feature_chns"] = [8] * 5
    algo = build_algorithm(cfg.algorithm, cfg, dtype=torch.bfloat16,
                           device="cpu")
    assert type(algo) is ALGORITHMS[algorithm]
    fields = (["model"] if algorithm == "supervised"
              else ["model1", "model2"])
    opts = (["optimizer"] if algorithm == "supervised"
            else ["optimizer1", "optimizer2"])
    assert [type(getattr(algo, f)).__name__ for f in fields] == models
    assert [type(getattr(algo, f)).__name__ for f in opts] == optimizers
    assert all(p.dtype == torch.float32 for p in algo.state_dict()[
        "models"][fields[0]].values())
