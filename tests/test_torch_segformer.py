"""The port's SegFormer and SegFormer_Plus against the JAX package's on the
CPU, with a tiny MiT (``T``: widths 8/16/40/64, one block a stage, heads
1/2/5/8 of width 8) added to both packages' ``MIT_SETTINGS`` for this
module: every flax variable maps strictly (``batch_stats/decoder/bn``
included), the eval-mode logits, one train-mode forward with the head's
BatchNorm running statistics it folds, and the Plus necks' outputs agree,
and the half-pixel resize equals ``jax.image.resize``.

The flax variables are numpy draws laid out as ``jax.eval_shape`` of the
flax init gives them (scales and running variances 1 + 0.1 |N|, the first
patch embed's conv 0.001 N so that its LayerNorm's epsilon shows,
everything else 0.1 N), loaded into the port with ``load_jax_weights``. Dropout is off
on both sides: the port's rates are 0, and the JAX forward is traced inside
``flax.linen.intercept_methods`` with an interceptor that makes its head
``Dropout`` and its ``DropPath``s the identity (the flax modules hard-code
their rates). The SegFormer runs at 40², where every reduction conv pads
as 'SAME' (stage sizes 10, 5, 3 against sr 8, 4, 2; 5 and 3 asymmetric);
the Plus at 32², where they divide.

Tolerance (fp32 on both sides): outputs within 1e-4 of the reference's
largest magnitude (matmuls, convs, LayerNorms and softmaxes summed in other
orders); BN statistics 1e-5 absolute; the resize 1e-6 absolute.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.models import segformer as jseg
from hpfg_tpu.models.layers import DropPath as FlaxDropPath
from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.models import segformer as tseg
from hpfg_tpu_torch.utils.jax_weights import (
    flatten_tree,
    load_jax_weights,
    module_arrays,
)
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

REL_TOL = 1e-4
STATS_ATOL = 1e-5
RESIZE_ATOL = 1e-6
TINY_MIT = ([8, 16, 40, 64], [1, 1, 1, 1])
NO_DROP = dict(mit="T", drop_rate=0.0, drop_path_rate=0.0)


def no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: the head's Dropout and every DropPath return their
    input."""
    if context.method_name == "__call__" and isinstance(
            context.module, (fnn.Dropout, FlaxDropPath)):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def tiny_mit():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jseg.MIT_SETTINGS, "T", TINY_MIT)
        mp.setitem(tseg.MIT_SETTINGS, "T", TINY_MIT)
        yield


def _flax_variables(model, hw, seed):
    tree = jax.eval_shape(
        lambda k: model.init({"params": k}, jnp.zeros((2, hw, hw, 1)),
                             train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key in ("scale", "var"):
            return (1 + 0.1 * np.abs(rng.normal(size=s.shape))).astype(
                np.float32)
        # the first patch embed 100x smaller: its LayerNorm then sees a
        # variance of about 5e-5, where epsilon 1e-5 against 1e-6 moves
        # the output by 8%
        scale = 1e-3 if path[-3].key == "patch_embed1" else 0.1
        return (scale * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _flax(cls, hw, seed):
    """The flax model's variables (numpy draws) and one jitted call that
    returns its train-mode output with the updated batch_stats, and its
    ``val`` logits."""
    model = cls(image_size=(hw, hw), in_channels=1, num_classes=4,
                model_name="T")
    variables = _flax_variables(model, hw, seed)

    def run(v, x):
        with fnn.intercept_methods(no_dropout):
            train, mut = model.apply(v, x, train=True,
                                     mutable=["batch_stats"])
            val = model.apply(v, x, method=model.val)
        return train, mut["batch_stats"], val

    return variables, jax.jit(run)


@pytest.fixture(scope="module")
def flax_segformer(tiny_mit):
    return _flax(jseg.SegFormer, 40, 3)


@pytest.fixture(scope="module")
def flax_segformer_plus(tiny_mit):
    return _flax(jseg.SegFormerPlus, 32, 5)


def _port(name, hw, variables):
    model = build_model({"model": name, "train_crop_size": [hw, hw],
                         **NO_DROP})
    load_jax_weights(model, variables["params"], variables["batch_stats"])
    return model


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=REL_TOL * scale, rtol=0)


def _input(seed, hw):
    return np.random.default_rng(seed).normal(size=(2, hw, hw, 1)).astype(
        np.float32)


def _check_bn(model, new_stats):
    bn = new_stats["decoder"]["bn"]
    np.testing.assert_allclose(model.decoder.bn.mean.numpy(), bn["mean"],
                               atol=STATS_ATOL, rtol=0)
    np.testing.assert_allclose(model.decoder.bn.var.numpy(), bn["var"],
                               atol=STATS_ATOL, rtol=0)


def test_segformer_weight_map_and_logits_match_flax(flax_segformer):
    variables, run = flax_segformer
    model = _port("segformer", 40, variables)
    ref = flatten_tree(variables["params"])
    ref.update(flatten_tree(variables["batch_stats"]))
    got = module_arrays(model)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].shape == v.shape, k
    assert got["encoder.block1_0.mlp.dwconv.kernel"].shape == (3, 3, 1, 32)
    assert got["encoder.block1_0.attn.sr.kernel"].shape == (8, 8, 8, 8)
    assert "decoder.linear_fuse.bias" not in got
    assert set(flatten_tree(variables["batch_stats"])) == {
        "decoder.bn.mean", "decoder.bn.var"}

    x = _input(11, 40)
    train_j, stats_j, val_j = run(variables, x)
    with torch.no_grad():
        val_t = model.val(torch.from_numpy(x))
        train_t = model(torch.from_numpy(x), train=True)
    assert train_t.dtype == torch.float32 and train_t.shape == (2, 40, 40, 4)
    _close(val_t, val_j)
    _close(train_t, train_j)
    _check_bn(model, stats_j)


def test_segformer_plus_outputs_match_flax(flax_segformer_plus):
    """Train-mode logits, both necks' (global, dense) outputs, the folded
    BN statistics, and ``val``."""
    variables, run = flax_segformer_plus
    model = _port("segformer_plus", 32, variables)
    assert set(module_arrays(model)) == set(
        flatten_tree(variables["params"])) | {"decoder.bn.mean",
                                              "decoder.bn.var"}
    assert model.dense_projection_high.mlp1.kernel.shape == (64, 2048)
    x = _input(12, 32)
    out_j, stats_j, val_j = run(variables, x)
    with torch.no_grad():
        val_t = model.val(torch.from_numpy(x))
        out_t = model(torch.from_numpy(x), train=True)
    _close(val_t, val_j)
    _close(out_t[0], out_j[0])
    for t, j in zip((*out_t[1], *out_t[2]), (*out_j[1], *out_j[2])):
        _close(t, j)
    _check_bn(model, stats_j)


@pytest.mark.parametrize("src,dst", [((7, 7), (28, 28)), ((14, 14), (56, 56)),
                                     ((28, 28), (56, 56)), ((3, 5), (10, 10)),
                                     ((10, 10), (40, 40)), ((5, 5), (5, 5))])
def test_resize_half_pixel_matches_jax(src, dst):
    x = np.random.default_rng(sum(src + dst)).normal(
        size=(2, *src, 3)).astype(np.float32)
    ref = jax.image.resize(x, (2, *dst, 3), method="linear")
    got = tseg.resize_half_pixel(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=RESIZE_ATOL, rtol=0)


def test_resize_half_pixel_refuses_a_downsample():
    with pytest.raises(ValueError, match="upsamples only"):
        tseg.resize_half_pixel(torch.zeros(1, 8, 8, 1), (4, 4))


@pytest.mark.parametrize("n,k,s,pads", [(56, 8, 8, (0, 0)), (10, 8, 8, (3, 3)),
                                        (5, 4, 4, (1, 2)), (3, 2, 2, (0, 1)),
                                        (7, 3, 1, (1, 1))])
def test_same_padding_matches_lax(n, k, s, pads):
    assert tseg.same_padding(n, k, s) == pads
    assert tuple(jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]) == pads


def test_drop_rates_default_to_the_flax_ones():
    model = build_model({"model": "segformer", "train_crop_size": [32, 32]})
    rates = [m.rate for m in model.modules()
             if isinstance(m, tseg.DropPath)]
    np.testing.assert_allclose(rates, np.repeat(np.linspace(0, 0.1, 8), 2))
    assert model.decoder.dropout_rate == 0.1
    assert [len(model.encoder.embed_dims), model.encoder.embed_dims[0]] == [
        4, 32]
    plus = build_model({"model": "segformer_plus",
                        "train_crop_size": [32, 32]})
    assert plus.encoder.embed_dims == [64, 128, 320, 512]


def test_mixffn_matches_flax():
    """One MixFFN (dim 8, hidden 32) at unit-scale activations against
    flax's, to 1e-5 absolute (a Dense of 8 inputs, a 3x3 depthwise conv
    and a GELU in fp32 on both sides). The tanh-approximate GELU would
    differ by up to 5e-4 here, which the model tests' tolerance, relative
    to outputs of larger magnitude, does not resolve."""
    model = jseg.MixFFN(dim=8, hidden=32)
    x = np.random.default_rng(3).normal(size=(2, 5, 5, 8)).astype(np.float32)
    tree = jax.eval_shape(lambda k: model.init(k, x), jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(max(s.shape[0], 9)))
        .astype(np.float32), tree["params"])
    ref = jax.jit(model.apply)({"params": params}, x)
    port = tseg.MixFFN(8, 32)
    load_jax_weights(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert 1.0 < float(np.abs(ref).max()) < 10.0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
