"""The port's SwinUNet and SwinUNet_Plus against the JAX package's on the
CPU, at a tiny geometry (embed 8, heads (1, 2, 4, 8), window 2, 64x64
input, drop rates 0): every flax variable maps strictly, train-mode and
``val`` logits and the Plus necks' outputs agree, the numpy constants are
equal, and the truncated-normal init has the std flax's has.

The flax variables are numpy draws laid out as ``jax.eval_shape`` of the
flax init gives them (scales 1 + 0.1 N, everything else 0.1 N), loaded into
the port with ``load_jax_weights``: the tree is flax's own, and an init
would cost a whole compile on the CPU. Tolerance: 1e-4 absolute on outputs
of magnitude about 1 (fp32 on both sides; the matmuls, LayerNorms and
softmaxes sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.models import swinunet as jswin
from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.models import swinunet as tswin
from hpfg_tpu_torch.models.layers import trunc_normal
from hpfg_tpu_torch.utils.jax_weights import (
    flatten_tree,
    load_jax_weights,
    module_arrays,
)

ATOL = 1e-4
TINY = dict(embed_dim=8, num_heads=(1, 2, 4, 8), window_size=2,
            drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)


def _flax(cls, depths, seed, val=True):
    """The flax model, numpy draws in its variable tree, and one jitted
    call that returns its train-mode output and (``val``) its ``val``
    logits."""
    model = cls(in_channels=1, num_classes=4, depths=depths, use_pallas=False,
                **TINY)
    tree = jax.eval_shape(
        lambda k: model.init({"params": k}, jnp.zeros((2, 64, 64, 1)),
                             train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: (float(path[-1].key == "scale")
                         + 0.1 * rng.normal(size=s.shape)).astype(np.float32),
        tree["params"])
    apply = jax.jit(lambda p, x: (
        model.apply({"params": p}, x, train=True),
        model.apply({"params": p}, x, method=model.val) if val else None))
    return params, apply


@pytest.fixture(scope="module")
def flax_swinunet():
    return _flax(jswin.SwinUNet, (2, 2, 2, 2), 3)


@pytest.fixture(scope="module")
def flax_swinunet_plus():
    return _flax(jswin.SwinUNetPlus, (2, 2, 6, 2), 5, val=False)


def _port(name, depths, params):
    model = build_model({"model": name, "train_crop_size": [64, 64],
                         "depths": list(depths), **TINY})
    load_jax_weights(model, params)
    return model


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=0)


def _input(seed):
    return np.random.default_rng(seed).normal(size=(2, 64, 64, 1)).astype(
        np.float32)


def test_swinunet_weight_map_and_logits_match_flax(flax_swinunet):
    params, apply = flax_swinunet
    model = _port("swinunet", (2, 2, 2, 2), params)
    got, ref = module_arrays(model), flatten_tree(params)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].shape == v.shape, k
    assert got["encoder.patch_embed.proj.kernel"].shape == (4, 4, 1, 8)
    assert got["decoder.head.kernel"].shape == (1, 1, 8, 4)

    x = _input(11)
    train_j, val_j = apply(params, x)
    with torch.no_grad():
        train_t = model(torch.from_numpy(x), train=True)
        val_t = model.val(torch.from_numpy(x))
    assert train_t.dtype == torch.float32 and train_t.shape == (2, 64, 64, 4)
    _close(train_t, train_j)
    _close(val_t, val_j)


def test_swinunet_plus_outputs_match_flax(flax_swinunet_plus):
    """Depths (2, 2, 6, 2): logits, both necks' (global, dense) outputs in
    train mode, and ``val``. With the drop rates at 0, flax's ``val`` is its
    train-mode logits (``test_swinunet_weight_map_and_logits_match_flax``
    holds the port's ``val`` against flax's own), so one compile serves."""
    params, apply = flax_swinunet_plus
    model = _port("swinunet_plus", (2, 2, 6, 2), params)
    assert set(module_arrays(model)) == set(flatten_tree(params))
    x = _input(12)
    out_j, _ = apply(params, x)
    val_j = out_j[0]
    with torch.no_grad():
        out_t = model(torch.from_numpy(x), train=True)
        val_t = model.val(torch.from_numpy(x))
    _close(out_t[0], out_j[0])
    for t, j in zip((*out_t[1], *out_t[2]), (*out_j[1], *out_j[2])):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
    _close(val_t, val_j)


@pytest.mark.parametrize("ws", [2, 3, 7])
def test_numpy_constants_equal(ws):
    np.testing.assert_array_equal(tswin._relative_position_index(ws),
                                  jswin._relative_position_index(ws))
    for h in (ws, 2 * ws, 8 * ws):
        np.testing.assert_array_equal(
            tswin._shift_attention_mask(h, h, ws, ws // 2),
            jswin._shift_attention_mask(h, h, ws, ws // 2))
    assert tswin._drop_path_rates(0.2, (2, 2, 6, 2)) == \
        jswin._drop_path_rates(0.2, (2, 2, 6, 2))


def test_constants_are_non_persistent_buffers():
    """The relative index and the shift masks move with the module and stay
    out of the state dict; only shifted blocks hold a mask."""
    model = build_model({"model": "swinunet", "train_crop_size": 64,
                         "depths": [2, 2, 2, 2], **TINY})
    attn0 = model.encoder.layer0.block0.attn
    attn1 = model.encoder.layer0.block1.attn
    assert attn0.attn_mask is None
    assert tuple(attn1.attn_mask.shape) == (64, 4, 4)
    assert not any("rel_index" in k or "attn_mask" in k
                   for k in model.state_dict())


def test_trunc_normal_init_std():
    """flax truncated_normal(0.02) (``trunc_normal_init``): a standard normal
    truncated to [-2, 2] times 0.02, so values within +-0.04 and a std of
    0.8796 * 0.02, as the JAX initializer's own draw."""
    draw = trunc_normal((200_000,), 0.02, torch.Generator().manual_seed(0))
    ref = np.asarray(jswin.trunc_normal_init(0.02)(jax.random.PRNGKey(0),
                                                   (200_000,)))
    assert abs(float(draw.std()) - 0.87962566 * 0.02) < 2e-4
    assert abs(float(draw.std()) - float(ref.std())) < 2e-4
    assert float(draw.abs().max()) <= 0.04 and np.abs(ref).max() <= 0.04
    assert float(draw.abs().max()) > 0.039
    assert abs(float(draw.mean())) < 2e-4


@pytest.mark.parametrize("name,size,ws,patch", [
    ("swinunet", 224, 7, 4), ("swinunet_plus", 256, 8, 4),
    ("swinunet_lidc", 96, 3, 2), ("swinunet_lidc", 64, 4, 2)])
def test_build_swinunet_geometry(name, size, ws, patch):
    model = build_model({"model": name, "train_crop_size": [size, size],
                         "embed_dim": 8, "num_heads": [1, 2, 4, 8]})
    assert model.encoder.layer0.block0.attn.ws == ws
    assert model.encoder.patch_embed.p == patch
    assert model.decoder.final_patch_expanding.p == patch
    assert hasattr(model, "dense_projection_high") == name.endswith("plus")


def test_build_swinunet_refuses_unknown_size():
    with pytest.raises(NotImplementedError):
        build_model({"model": "swinunet", "train_crop_size": 100})
