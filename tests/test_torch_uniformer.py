"""The port's UniFormer_Plus against the JAX package's on the CPU, at full
width on 64x64 images (two blocks a stage in both packages: the blocks are
the same code, and each adds to the JAX compile on the CPU; at 32x32 the
last stage is a 1x1 map, whose BatchNorm over a batch of two hangs on two
values' difference), with the harness of ``test_torch_zoo_cnn.py`` (the
strict weight map, ``val``, one train-mode forward with its necks and
folded BN statistics, every parameter's gradient; tolerances there); its
inits (Dense trunc-normal 0.02 with zero bias, convs torch's default);
DropPath on in training at the flax rates; and one HPFG step on
``uniformer_plus`` against ``jax.jit(HPFG.step)``, with the harness and
tolerances of ``test_torch_cmt.py``, its students cut to one block a stage
in both packages.
"""

import functools

import numpy as np
import pytest
import torch

from hpfg_tpu.models import uniformer as jun
from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.models import uniformer as tun
from hpfg_tpu_torch.models.layers import DropPath
from tests.test_torch_cmt import hpfg_step_matches
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401
from tests.test_torch_zoo_cnn import ZooCase

#: the depths in the model test and in the HPFG step (published: 3/4/8/3)
TWO, SHALLOW = (2, 2, 2, 2), (1, 1, 1, 1)


def _depth(mp, depth) -> None:
    """UniFormer with ``depth`` blocks a stage in both packages."""
    mp.setattr(jun, "UniFormer", functools.partial(jun.UniFormer,
                                                   depth=depth))
    mp.setattr(tun, "UniFormer", functools.partial(tun.UniFormer,
                                                   depth=depth))


@pytest.fixture(scope="module")
def case():
    return ZooCase("uniformer_plus", 64, patch=lambda mp: _depth(mp, TWO))


def test_weight_map_is_the_flax_tree(case):
    got = case.check_weight_map()
    assert sum(k.startswith("encoder.block") and k.endswith("pos_embed.bias")
               for k in got) == 8


@pytest.fixture(scope="module")
def published():
    """UniFormer_Plus at 32^2, the published depths 3/4/8/3."""
    return build_model({"model": "uniformer_plus",
                        "train_crop_size": [32, 32]},
                       generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("key,shape", [
    ("encoder.patch_embed1.kernel", (4, 4, 1, 64)),
    ("encoder.patch_embed2.kernel", (2, 2, 64, 128)),
    ("encoder.block1_0.attn.kernel", (5, 5, 1, 64)),
    ("encoder.block1_0.pos_embed.kernel", (3, 3, 1, 64)),
    ("encoder.block2_3.mlp_fc1.kernel", (1, 1, 128, 512)),
    ("encoder.block3_7.qkv.kernel", (320, 960)),
    ("encoder.block4_2.mlp_fc2.kernel", (2048, 512)),
    ("encoder.norm4.var", (512,)),
    ("dense_projection_high.mlp1.kernel", (512, 2048)),
])
def test_published_shapes(published, key, shape):
    """uniformer_small: dims 64/128/320/512, depths 3/4/8/3, the 5x5
    depthwise ``attn`` of the conv blocks, MLP ratio 4, the stage-end
    BatchNorms and the 512-wide high neck."""
    assert tuple(published.state_dict()[key].shape) == shape


def test_forward_backward_match_jax(case):
    zero = case.check_forward_backward()
    assert "encoder.block4_1.mlp_fc2.bias" in zero


def test_dense_trunc_normal_init(published):
    """Dense kernels trunc-normal(0.02): std 0.8796 * 0.02, within +-0.04,
    and zero biases."""
    block = published.encoder.block3_0
    k = block.qkv.kernel.detach().numpy()
    assert abs(k.std() / (0.87962566103423978 * 0.02) - 1) < 0.01
    assert np.abs(k).max() <= 0.04 and abs(k.mean()) < 1e-4
    assert not block.qkv.bias.any() and not block.mlp_fc2.bias.any()


@pytest.mark.parametrize("conv,bound", [("attn", 1 / 5),
                                        ("mlp_fc1", 1 / 8)])
def test_conv_default_init(published, conv, bound):
    """The convs keep torch's default U(+-1/sqrt(fan_in)), kernel and
    bias: the 5x5 depthwise 1/5, the 1x1 MLP conv of 64 inputs 1/8."""
    layer = getattr(published.encoder.block1_0, conv)
    for t in (layer.kernel, layer.bias):
        a = np.abs(t.detach().numpy())
        assert 0.9 * bound < a.max() <= bound


def test_drop_path_rates(published):
    """DropPath rates rise from 0 to 0.1 over the 18 blocks (the JAX
    default; the config sets none); the head's dropout is 0.1."""
    rates = [m.rate for m in published.modules() if isinstance(m, DropPath)]
    np.testing.assert_allclose(rates, np.repeat(np.linspace(0, 0.1, 18), 2))
    assert published.decoder.dropout_rate == 0.1


def test_drop_path_on_in_training(published):
    """Two train-mode forwards with different draws differ; ``val`` does
    not draw."""
    x = torch.randn(4, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        state = {k: v.clone() for k, v in published.state_dict().items()}
        a = published(x, train=True,
                      generator=torch.Generator().manual_seed(1))
        b = published(x, train=True,
                      generator=torch.Generator().manual_seed(2))
        published.load_state_dict(state)  # the folds of the two forwards
        assert (a[0] - b[0]).abs().max() > 1e-3
        assert torch.equal(published.val(x), published.val(x))


@pytest.fixture(scope="module")
def shallow_uniformer():
    with pytest.MonkeyPatch.context() as mp:
        _depth(mp, SHALLOW)
        yield


def test_hpfg_step_on_uniformer_plus_matches_jax(shallow_uniformer):
    hpfg_step_matches("uniformer_plus", 32)
