"""The port's UNet (hpfg_tpu_torch.models) against the flax UNet on the CPU:
the weight mapper, train-mode logits, parameter gradients and the updated
BN running statistics, from the same mapped weights and the same numpy
input, with dropout zeroed.

Tolerance: fp32 on both sides; the convolutions and BN reductions sum in
other orders (XLA vs the port's plain kernels), so logits and statistics
agree to ATOL = 1e-4 and every gradient to 1e-4 of the largest gradient of
the model plus 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.models.unet import UNet as FlaxUNet
from hpfg_tpu.train.algorithms.base import init_model
from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.utils.jax_weights import (
    flatten_tree,
    load_jax_weights,
    module_arrays,
)

ATOL = 1e-4
GRAD_RTOL = 1e-4
FEATURES = (16, 16, 16, 16, 16)
NO_DROPOUT = (0.0,) * 5


@pytest.fixture(scope="module")
def flax_unet():
    model = FlaxUNet(in_channels=1, num_classes=4, feature_chns=FEATURES,
                     dropout=NO_DROPOUT)
    state = jax.jit(lambda key: init_model(model, key, (2, 32, 32, 1)))(
        jax.random.PRNGKey(3))
    return model, jax.device_get(state.params), \
        jax.device_get(state.batch_stats)


def _port_unet(params, batch_stats):
    cfg = {"model": "unet", "in_channels": 1, "num_classes": 4,
           "feature_chns": list(FEATURES), "dropout": list(NO_DROPOUT)}
    model = build_model(cfg)
    load_jax_weights(model, params, batch_stats)
    return model


def test_weight_mapper_covers_every_variable(flax_unet):
    _, params, batch_stats = flax_unet
    model = _port_unet(params, batch_stats)
    got = module_arrays(model)
    ref = flatten_tree(params)
    ref.update(flatten_tree(batch_stats))
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_unet_train_step_matches_flax(flax_unet):
    model_j, params, batch_stats = flax_unet
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    dy = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)

    @jax.jit
    def run(p, s, xx):
        def f(pp):
            out, mut = model_j.apply({"params": pp, "batch_stats": s}, xx,
                                     train=True, mutable=["batch_stats"])
            return jnp.sum(out * dy), (out, mut["batch_stats"])

        (_, (out, stats)), grads = jax.value_and_grad(f, has_aux=True)(p)
        return out, stats, grads

    out_j, stats_j, grads_j = jax.device_get(run(params, batch_stats,
                                                 jnp.asarray(x)))

    model = _port_unet(params, batch_stats)
    out_t = model(torch.from_numpy(x), train=True)
    (out_t * torch.from_numpy(dy)).sum().backward()

    np.testing.assert_allclose(out_t.detach().numpy(), out_j, atol=ATOL,
                               rtol=0)
    buffers = {k: v.numpy() for k, v in model.named_buffers()}
    for k, v in flatten_tree(stats_j).items():
        np.testing.assert_allclose(buffers[k], v, atol=ATOL, rtol=0,
                                   err_msg=k)
    ref = flatten_tree(grads_j)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    port = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(port) == set(ref)
    for k, v in ref.items():
        err = float(np.abs(port[k] - v).max())
        assert err <= GRAD_RTOL * scale + 1e-6, (k, err, scale)


def test_unet_eval_logits_match_flax(flax_unet):
    model_j, params, batch_stats = flax_unet
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.1, 0.5, size=v.shape)
        .astype(np.float32), batch_stats)
    out_j = jax.jit(lambda p, s, xx: model_j.apply(
        {"params": p, "batch_stats": s}, xx, train=False))(
            params, stats, jnp.asarray(x))
    model = _port_unet(params, stats)
    with torch.no_grad():
        out_t = model(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=0)
