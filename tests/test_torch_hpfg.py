"""The port's HPFG slice against the JAX package on the CPU: UNet_Plus
(logits and projection-neck outputs) from mapped weights, the dense
contrastive loss and its gradient, the CutMix rasterisation, the subtree
EMA, and three HPFG steps against ``jax.jit(HPFG.step)``.

Tolerances (fp32 on both sides): model outputs and BN statistics agree to
ATOL = 1e-4 (the convolutions and reductions sum in other orders); losses
and the step metrics to 1e-5 relative (the same functions of the same
values, summed in other orders); after three steps parameters, EMA
parameters and BN statistics to 1e-4 absolute; the CutMix masks and the
subtree EMA (the same fp32 operations on the same inputs) exactly, and the
EMA to 1e-7 where the JAX side multiplies by an fp32 alpha.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.config import Config
from hpfg_tpu.models.unet import UNetPlus as FlaxUNetPlus
from hpfg_tpu.ops import cutmix as jcutmix
from hpfg_tpu.ops import ema as jema
from hpfg_tpu.ops import losses as jlosses
from hpfg_tpu.train.algorithms import build_algorithm as jax_build_algorithm
from hpfg_tpu.train.algorithms.base import init_model
from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.ops import cutmix as tcutmix
from hpfg_tpu_torch.ops import ema as tema
from hpfg_tpu_torch.ops import losses as tlosses
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.utils.jax_weights import (
    flatten_tree,
    load_jax_state,
    load_jax_weights,
    module_arrays,
)
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

ATOL = 1e-4
PARAM_ATOL = 1e-4
METRIC_RTOL = 1e-5
FEATURES = [16] * 5
NO_DROPOUT = [0.0] * 5


@pytest.fixture(scope="module")
def flax_unet_plus():
    model = FlaxUNetPlus(in_channels=1, num_classes=4,
                         feature_chns=tuple(FEATURES),
                         dropout=tuple(NO_DROPOUT))
    state = jax.jit(lambda key: init_model(model, key, (2, 32, 32, 1)))(
        jax.random.PRNGKey(4))
    return model, jax.device_get(state.params), \
        jax.device_get(state.batch_stats)


def _port(params, batch_stats):
    model = build_model({"model": "unet_plus", "feature_chns": FEATURES,
                         "dropout": NO_DROPOUT})
    load_jax_weights(model, params, batch_stats)
    return model


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def test_unet_plus_weight_map_and_outputs_match_flax(flax_unet_plus):
    """Every flax variable maps (Dense kernels [in, out]); train-mode logits,
    both necks' (global, dense) outputs and the updated BN statistics, and
    the eval-mode ``val`` logits and full forward, agree."""
    model_j, params, batch_stats = flax_unet_plus
    model = _port(params, batch_stats)
    ref = flatten_tree(params)
    ref.update(flatten_tree(batch_stats))
    got = module_arrays(model)
    assert set(got) == set(ref)
    assert got["dense_projection_high.mlp1.kernel"].shape == (16, 2048)

    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    (out_j, high_j, head_j), mut = jax.jit(lambda p, s, xx: model_j.apply(
        {"params": p, "batch_stats": s}, xx, train=True,
        mutable=["batch_stats"]))(params, batch_stats, jnp.asarray(x))
    with torch.no_grad():
        out_t, high_t, head_t = model(torch.from_numpy(x), train=True)
    _close(out_t, out_j)
    for t, j in zip((*high_t, *head_t), (*high_j, *head_j)):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
    buffers = {k: v.numpy() for k, v in model.named_buffers()}
    for k, v in flatten_tree(mut["batch_stats"]).items():
        _close(buffers[k], v)

    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.1, 0.5, size=v.shape)
        .astype(np.float32), batch_stats)
    model = _port(params, stats)
    variables = {"params": params, "batch_stats": stats}
    val_j = model_j.apply(variables, jnp.asarray(x), method=model_j.val)
    full_j = model_j.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        val_t = model.val(torch.from_numpy(x))
        full_t = model(torch.from_numpy(x), train=False)
    _close(val_t, val_j)
    _close(full_t[0], full_j[0])
    for t, j in zip((*full_t[1], *full_t[2]), (*full_j[1], *full_j[2])):
        _close(t, j)


def test_dense_contrastive_loss_and_gradient_match_jax():
    rng = np.random.default_rng(17)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((4, 128), (4, 16, 128), (4, 128), (4, 16, 128))]
    val_j, grads_j = jax.jit(jax.value_and_grad(
        lambda g, d: jlosses.dense_contrastive_loss(
            (g, d), (jnp.asarray(arrays[2]), jnp.asarray(arrays[3]))),
        argnums=(0, 1)))(jnp.asarray(arrays[0]), jnp.asarray(arrays[1]))
    g = torch.tensor(arrays[0], requires_grad=True)
    d = torch.tensor(arrays[1], requires_grad=True)
    loss = tlosses.dense_contrastive_loss(
        (g, d), (torch.from_numpy(arrays[2]), torch.from_numpy(arrays[3])))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(val_j), rtol=METRIC_RTOL)
    for t, j in zip((g.grad, d.grad), grads_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_masks_rasterisation_bit_exact(seed):
    """The port's rasterisation of the JAX package's own uniforms gives the
    JAX masks bit for bit; the port's draw gives masks of the same kind."""
    n, shape = 6, (32, 40)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jcutmix.box_masks(key, n, shape))
    k_prop, k_aspect, k_pos = jax.random.split(key, 3)
    ky, kx = jax.random.split(k_pos)
    u = {"props": jax.random.uniform(k_prop, (n, 4), minval=0.25,
                                     maxval=0.5),
         "aspect": jax.random.uniform(k_aspect, (n, 4)),
         "pos_y": jax.random.uniform(ky, (n, 4)),
         "pos_x": jax.random.uniform(kx, (n, 4))}
    got = tcutmix.masks_from_uniforms(
        {k: torch.tensor(np.asarray(v)) for k, v in u.items()}, shape)
    np.testing.assert_array_equal(got.numpy(), ref)
    drawn = tcutmix.box_masks(torch.Generator().manual_seed(seed), n, shape)
    assert drawn.shape == (n, *shape, 1)
    assert set(np.unique(drawn.numpy())) <= {0.0, 1.0}
    assert 0.0 < float(drawn.mean()) < 1.0


def test_ema_update_subtree_matches_jax():
    """Only the named children's parameters move; buffers and the other
    parameters stay."""
    src = build_model({"model": "unet_plus", "feature_chns": [8] * 5},
                      generator=torch.Generator().manual_seed(0))
    dst = build_model({"model": "unet_plus", "feature_chns": [8] * 5},
                      generator=torch.Generator().manual_seed(1))
    for buf in dst.buffers():
        buf.add_(0.5)
    before = module_arrays(dst)
    src_p = {k: v.detach().numpy() for k, v in src.named_parameters()}
    dst_p = {k: before[k] for k, _ in dst.named_parameters()}

    def nest(flat):
        out = {}
        for k, v in flat.items():
            node = out
            *head, last = k.split(".")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = jnp.asarray(v)
        return out

    ref = flatten_tree(jema.ema_update_subtree(
        nest(src_p), nest(dst_p), 0.99, 7, keys=("encoder", "decoder")))
    tema.ema_update_subtree(src, dst, 0.99, 7, ("encoder", "decoder"))
    after = module_arrays(dst)
    for k, v in ref.items():
        np.testing.assert_allclose(after[k], v, rtol=0, atol=1e-7,
                                   err_msg=k)
        if not k.startswith(("encoder.", "decoder.")):
            np.testing.assert_array_equal(after[k], before[k])
    for k, _ in dst.named_buffers():
        np.testing.assert_array_equal(after[k], before[k])


def _hpfg_cfg():
    def block():
        return dict(model="unet_plus", in_channels=1, num_classes=4,
                    feature_chns=FEATURES, dropout=NO_DROPOUT, opt="sgd",
                    lr=0.01, weight_decay=5e-4, momentum=0.9,
                    sched="medical", total_itrs=30, step_size=10)

    return Config(dict(algorithm="hpfg", num_classes=4, in_channels=1,
                       train_crop_size=[32, 32], batch_size=2,
                       unlabel_batch_size=4, consistency=0.1,
                       consistency_rampup=4.0, epoch_unit_iters=1,
                       ema_decay=0.99, seed=0, model1=block(),
                       model2=block()))


def test_three_hpfg_steps_match_jax():
    """Three HPFG steps from mapped weights, with the CutMix masks the JAX
    step draws injected into the port; the MT gate is lowered to step 2 on
    both sides so the consistency term is exercised. lr and consistency are
    the HPFG config's (0.01, 0.1).

    At this size the two sides agree to about 1e-6 after three steps, but
    the necks' 2048-wide ReLUs, the LeakyReLUs and the max-pools are kinks:
    once last-bit differences have grown for a few steps, an element whose
    input lies within them of a kink takes the other derivative on one side
    and moves its gradient by O(1). Whether that happens within three steps
    depends on the draw (it does for some init keys at this size); the key
    and data seed here are one where no kink is crossed, so the comparison
    measures the arithmetic, not the kink."""
    cfg = _hpfg_cfg()
    jalgo = jax_build_algorithm("hpfg", cfg, dtype=jnp.float32)
    jalgo.mt_gate_iters = 2
    state = jax.jit(jalgo.init_state)(jax.random.PRNGKey(1))
    talgo = build_algorithm("hpfg", cfg, dtype=torch.float32, device="cpu")
    talgo.mt_gate_iters = 2
    load_jax_state(talgo, jax.device_get(state))

    step = jax.jit(jalgo.step)
    rng = np.random.default_rng(7)
    for _ in range(3):
        batch = {
            "label_img": rng.normal(size=(2, 32, 32, 1)).astype(np.float32),
            "label": rng.integers(0, 4, (2, 32, 32)).astype(np.int32),
            "label_img1": rng.normal(size=(2, 32, 32, 1)).astype(np.float32),
            "label1": rng.integers(0, 4, (2, 32, 32)).astype(np.int32),
            "unlabel_img": rng.normal(size=(4, 32, 32, 1)).astype(
                np.float32),
        }
        rm = jax.random.split(state.rng, 5)[4]  # the step's CutMix key
        mask = np.asarray(jcutmix.box_masks(rm, 4, (32, 32)))
        state, m_j = step(state, batch)
        m_t = talgo.step(batch, mask=torch.tensor(mask))
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


def test_hpfg_needs_feature_models():
    cfg = _hpfg_cfg()
    cfg.model2.model = "unet"
    with pytest.raises(ValueError, match="_plus"):
        build_algorithm("hpfg", cfg, dtype=torch.float32, device="cpu")


def test_dual_flat_schema_builds_both_students():
    """A flat (ccnet-style) config drives both students and optimizers."""
    cfg = Config(dict(algorithm="hpfg", model="unet_plus", feature_chns=[8] * 5,
                      num_classes=3, in_channels=1, train_crop_size=[32, 32],
                      batch_size=2, unlabel_batch_size=4, opt="sgd", lr=0.02,
                      weight_decay=1e-4, momentum=0.9, sched="medical",
                      total_itrs=10))
    algo = build_algorithm("hpfg", cfg, dtype=torch.float32, device="cpu")
    for model, sched in ((algo.model1, algo.schedule1),
                         (algo.model2, algo.schedule2)):
        assert type(model).__name__ == "UNetPlus"
        assert model.decoder.out_conv.kernel.shape == (3, 3, 8, 3)
        assert sched(0) == 0.02
    assert algo.model1 is not algo.model2
