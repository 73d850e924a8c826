"""The port's TransUNet against the JAX package's on the CPU, at full width
on 32x32 images (a 2x2 token grid; 2 of the ViT's 8 blocks in both
packages, ``VIT_BLOCKS``: the blocks are the same code, and each adds to
the JAX compile on the CPU), with the harness of
``test_torch_zoo_cnn.py`` (the strict weight map, ``val``, one train-mode
forward with its folded BN statistics, every parameter's gradient;
tolerances there); the attention's sqrt(head_dim) multiplier; the ViT
tables' inits; the image-sized positional embedding of ``transunet_lidc``
at 96x96; and the HPFG config on TransUNet, which both packages refuse
at construction.
"""

import jax
import numpy as np
import pytest
import torch

from hpfg_tpu.config import load_config as jax_load_config
from hpfg_tpu.models import transunet as jtu
from hpfg_tpu.train.algorithms import build_algorithm as jax_build_algorithm
from hpfg_tpu_torch.config import load_config
from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.models import transunet as ttu
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.utils.jax_weights import load_jax_weights
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401
from tests.test_torch_zoo_cnn import ZooCase, assert_close, shape_tree

CCNET_TRANSUNET = "configs/ccnet_transunet_30k_224x224_ACDC.yaml"
#: the ViT's blocks in the model tests
VIT_BLOCKS = 2


def _fewer_blocks(mp):
    mp.setattr(jtu, "build_transunet", lambda name, img_size, in_channels,
               num_classes, dtype: jtu.TransUNet(
                   image_size=img_size, num_classes=num_classes,
                   in_channels=in_channels, block_num=VIT_BLOCKS,
                   dtype=dtype))
    mp.setattr(ttu, "BLOCKS", VIT_BLOCKS)


@pytest.fixture(scope="module")
def case():
    return ZooCase("transunet", 32, perturbed_grads=True,
                   patch=_fewer_blocks)


def test_weight_map_is_the_flax_tree(case):
    got = case.check_weight_map()
    assert "vit.block2.attn.qkv.kernel" not in got


@pytest.fixture(scope="module")
def published():
    """``transunet`` at 32^2 with its published 8 ViT blocks."""
    return build_model({"model": "transunet", "train_crop_size": [32, 32]})


@pytest.mark.parametrize("key,shape", [
    ("conv1.kernel", (7, 7, 1, 128)),
    ("encoder1.conv2.kernel", (3, 3, 256, 256)),
    ("encoder3.down_conv.kernel", (1, 1, 512, 1024)),
    ("vit.embedding", (5, 1024)),
    ("vit.cls_token", (1, 1, 1024)),
    ("vit.block7.attn.qkv.kernel", (1024, 3072)),
    ("vit.block7.fc1.kernel", (1024, 512)),
    ("conv2.kernel", (3, 3, 1024, 512)),
    ("decoder1.conv1.kernel", (3, 3, 1024, 256)),
    ("decoder4.conv1.kernel", (3, 3, 64, 16)),
    ("head.kernel", (1, 1, 16, 4)),
])
def test_published_shapes(published, key, shape):
    """The published geometry at 32^2 (a 2x2 grid: 4 tokens and the class
    token): stem 128, bottlenecks to 1024, the ViT's 8 blocks of mlp 512,
    the 512-wide conv, the decoder down to 16 channels."""
    assert tuple(published.state_dict()[key].shape) == shape


def test_attention_has_no_bias(published):
    assert "vit.block0.attn.qkv.bias" not in published.state_dict()
    assert "vit.block0.attn.out.bias" not in published.state_dict()


def test_forward_backward_match_jax(case):
    zero = case.check_forward_backward()
    assert "decoder1.conv1.bias" in zero


def test_transunet_lidc_embedding_follows_the_image():
    """At 96^2 (the LIDC config) the grid is 6x6: ``embedding`` [37, 1024],
    the flax tree's shape; the rest of the tree is the 224^2 one's."""
    model = build_model({"model": "transunet_lidc", "in_channels": 3,
                         "num_classes": 2, "train_crop_size": [96, 96]})
    want = shape_tree(jtu.TransUNet(image_size=96, num_classes=2,
                                    in_channels=3), 96, 3)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert got["vit.embedding"] == (37, 1024)


def test_attention_multiplies_by_sqrt_head_dim():
    """One MultiHeadAttention (dim 64, 4 heads: x4) against flax's, and
    against the port with the logits divided instead, which differs."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    port = ttu.MultiHeadAttention(64, 4, torch.Generator().manual_seed(0))
    flax = jtu.MultiHeadAttention(64, 4)
    params = {k: {"kernel": getattr(port, k).kernel.detach().numpy()}
              for k in ("qkv", "out")}
    want = jax.jit(flax.apply)({"params": params}, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_close(got, want, "attention")
    fresh = ttu.MultiHeadAttention(64, 4)
    load_jax_weights(fresh, params)
    attention = ttu.attention
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttu, "attention",
                   lambda q, k, v, s: attention(q, k, v, 1 / s))
        divided = fresh(torch.from_numpy(x))
    assert np.abs(divided.numpy() - np.asarray(want)).max() > 1e-2


@pytest.fixture(scope="module")
def vit_224():
    """The ViT's tables at 224^2 (196 tokens)."""
    return ttu.ViT(196, 8, 1024, 4, 16, 1,
                   generator=torch.Generator().manual_seed(0))


def test_embedding_init(vit_224):
    """``embedding`` U[0, 1), 197 x 1024."""
    emb = vit_224.embedding.detach().numpy()
    assert emb.shape == (197, 1024)
    assert emb.min() >= 0 and emb.max() < 1
    assert abs(emb.mean() - 0.5) < 0.005 and abs(emb.std() - 12 ** -0.5) \
        < 0.005


def test_cls_token_init(vit_224):
    """``cls_token`` N(0, 1), 1 x 1 x 1024."""
    cls = vit_224.cls_token.detach().numpy()
    assert cls.shape == (1, 1, 1024)
    assert abs(cls.mean()) < 0.1 and abs(cls.std() - 1) < 0.1


def test_rates_default_to_the_flax_ones(published):
    """Dropout 0.1 in the ViT and in each block (flax hard-codes it)."""
    assert published.vit.drop_rate == 0.1
    assert {getattr(published.vit, f"block{i}").drop_rate
            for i in range(8)} == {0.1}


def test_ccnet_transunet_refused_by_both_packages():
    """HPFG needs *_plus students; ``transunet`` is not one. Both packages
    raise the same ValueError at construction, before any model is
    built."""
    with pytest.raises(ValueError, match="_plus"):
        jax_build_algorithm("hpfg", jax_load_config(CCNET_TRANSUNET))
    with pytest.raises(ValueError, match="_plus"):
        build_algorithm("hpfg", load_config(CCNET_TRANSUNET),
                        dtype=torch.float32, device="cpu")
