"""The port's CMT_S (``cmt``) and CMT_Plus (``cmt_plus``) against the JAX
package's on the CPU, at full width on 64x64 images, and one HPFG step on
``cmt_plus`` against ``jax.jit(HPFG.step)``.

The models are compared with the harness of ``test_torch_zoo_cnn.py`` (the
strict weight map, ``val``, one train-mode forward with its necks and
folded BN statistics, every parameter's gradient; tolerances there):
CMT_Plus whole at two blocks a stage in both packages (the blocks are the
same code, and each adds to the JAX compile on the CPU), CMT_S (the xs
encoder, 3/3/12/3 blocks) by its weight map and ``val``. At
32x32 the last stages are 2x2 and 1x1 maps, where a BatchNorm over a batch
of two normalizes two values per channel: its output then hangs on their
difference, which the two sides' rounding moves by up to 20% of the
logits' magnitude in train mode. At 64x64 (stages 16, 8, 4, 2) the two
sides agree to 5e-6.

``relative_pos_{s}`` is one parameter of the encoder per stage, shared by
the stage's blocks, drawn N(0, 1); the depthwise kernels are [k, k, 1, C]
with the torch bound 1/k.

The HPFG step (``hpfg_step_matches``, shared with
``test_torch_uniformer.py``) runs two ``cmt_plus`` students, with one
block a stage (``SHALLOW``, in both packages: the step's compile on the CPU
then takes a third of the time), at 64x64 with 2 labelled and 4
unlabelled images, SGD (lr 0.01: adamW's first step is nearly +-lr
whatever the gradient, so a parameter whose exact gradient is zero, as the
head's ``linear_c*`` biases' are, would move by lr on one side and by
-lr on the other), the consistency ramp at 1/4 and the MT gate lowered to
the first step so that every loss term counts; the port's state is the
JAX state's (``load_jax_state``), the CutMix masks the JAX step's. Dropout
and DropPath are off on both sides (rates 0; the JAX step traced inside
``no_dropout``). Tolerances: each loss term to 1e-5 relative; after the
step every parameter and BN statistic of model1, model2 and the EMA
teacher to 1e-4 absolute.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.config import Config
from hpfg_tpu.models import cmt as jcmt
from hpfg_tpu.ops import cutmix as jcutmix
from hpfg_tpu.train.algorithms import build_algorithm as jax_build_algorithm
from hpfg_tpu.train.algorithms.dual import TeacherDualState
from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.models import cmt as tcmt
from hpfg_tpu_torch.models.layers import DropPath
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.utils.jax_weights import (
    flatten_tree,
    load_jax_state,
    module_arrays,
)
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401
from tests.test_torch_segformer import no_dropout
from tests.test_torch_supervised_cps import model_state
from tests.test_torch_zoo_cnn import ZooCase

PARAM_ATOL = 1e-4
METRIC_RTOL = 1e-5
LB, UB = 2, 4
#: CMT_Plus's depths in the model test (two blocks share each stage's
#: ``relative_pos``) and in the HPFG step (published: 2/2/10/2)
TWO, SHALLOW = (2, 2, 2, 2), (1, 1, 1, 1)


def _cmt_plus_depths(mp, depths) -> None:
    """CMT_Plus with ``depths`` blocks a stage in both packages."""
    tiny = jcmt.cmt_tiny_kwargs()
    mp.setattr(jcmt, "cmt_tiny_kwargs", lambda: {**tiny, "depths": depths})
    mp.setattr(tcmt.CMTPlus, "encoder_kwargs",
               {**tcmt.CMT_TINY, "depths": depths})


@pytest.fixture(scope="module", params=["cmt", "cmt_plus"])
def cmt_case(request):
    return ZooCase(request.param, 64, patch=(
        lambda mp: _cmt_plus_depths(mp, TWO)) if request.param == "cmt_plus"
        else None)


@pytest.fixture(scope="module")
def shallow_cmt_plus():
    with pytest.MonkeyPatch.context() as mp:
        _cmt_plus_depths(mp, SHALLOW)
        yield


def test_weight_map_is_the_flax_tree(cmt_case):
    got = cmt_case.check_weight_map()
    assert not any(k.startswith("encoder.block") and "relative_pos" in k
                   for k in got)


DIMS = {"cmt": (52, 104, 208, 416), "cmt_plus": (46, 92, 184, 368)}


@pytest.mark.parametrize("name", sorted(DIMS))
@pytest.mark.parametrize("stage", range(4))
def test_stage_shapes(name, stage):
    """At 64^2 stage s has (64 / 2^(s+2))^2 tokens, its keys and values
    reduced by sr^2 (8, 4, 2, 1); one ``relative_pos_{s}`` [heads, N,
    N / sr^2] on the encoder; depthwise kernels [k, k, 1, C]."""
    model = build_model({"model": name, "train_crop_size": [64, 64]})
    n, sr, heads = (16, 8, 4, 2)[stage], (8, 4, 2, 1)[stage], \
        (1, 2, 4, 8)[stage]
    dim = DIMS[name][stage]
    enc = model.encoder
    assert tuple(getattr(enc, f"relative_pos_{stage}").shape) == (
        heads, n * n, n * n // sr ** 2)
    block = getattr(enc, f"block{stage}_0")
    assert tuple(block.lpu.kernel.shape) == (3, 3, 1, dim)
    if sr > 1:
        assert tuple(block.attn.sr_conv.kernel.shape) == (sr, sr, 1, dim)
        assert tuple(block.attn.sr_bn.mean.shape) == (dim,)
    else:
        assert not hasattr(block.attn, "sr_conv")
    assert tuple(getattr(model.decoder, f"linear_c{stage + 1}").kernel
                 .shape) == (dim, 256)


def test_forward_backward_match_jax(cmt_case):
    """CMT_Plus whole; CMT_S (the xs encoder, the same blocks) ``val``."""
    if cmt_case.name == "cmt":
        cmt_case.check_val()
        return
    zero = cmt_case.check_forward_backward()
    assert "decoder.linear_c1.bias" in zero


@pytest.fixture(scope="module")
def cmt_plus_224():
    return build_model({"model": "cmt_plus", "train_crop_size": [224, 224]},
                       generator=torch.Generator().manual_seed(0))


def test_relative_pos_init(cmt_plus_224):
    """At 224^2: ``relative_pos_0`` [1, 3136, 49] is N(0, 1); the later
    stages' [2, 784, 49], [4, 196, 49], [8, 49, 49]."""
    rp = cmt_plus_224.encoder.relative_pos_0.detach().numpy()
    assert rp.shape == (1, 3136, 49)
    assert abs(rp.mean()) < 0.01 and abs(rp.std() - 1) < 0.01
    assert [getattr(cmt_plus_224.encoder, f"relative_pos_{s}").shape
            for s in range(1, 4)] == [(2, 784, 49), (4, 196, 49), (8, 49, 49)]


@pytest.mark.parametrize("conv,bound", [("lpu", 1 / 3), ("sr_conv", 1 / 8)])
def test_depthwise_init(cmt_plus_224, conv, bound):
    """The depthwise kernels and biases lie within 1/k: the local
    perception unit's 1/3, the stage-1 reduction conv's 1/8."""
    block = cmt_plus_224.encoder.block0_0
    layer = block.lpu if conv == "lpu" else block.attn.sr_conv
    for t in (layer.kernel, layer.bias):
        a = np.abs(t.detach().numpy())
        assert 0.9 * bound < a.max() <= bound


def test_rates_default_to_the_flax_ones():
    """No DropPath (the flax CMT's rate is 0 wherever it is built), the
    head's dropout 0.1."""
    model = build_model({"model": "cmt", "train_crop_size": [64, 64]})
    assert not any(isinstance(m, DropPath) for m in model.modules())
    assert model.decoder.dropout_rate == 0.1
    assert model.encoder.embed_dims == [52, 104, 208, 416]
    assert model.encoder.depths == [3, 3, 12, 3]


def hpfg_cfg(model: str, hw: int) -> Config:
    """Both students ``model`` with rates 0 (nested blocks: the flat
    schema copies no rate hooks)."""
    def block():
        return dict(model=model, opt="sgd", lr=0.01, weight_decay=5e-4,
                    momentum=0.9, sched="medical", total_itrs=30,
                    step_size=10, drop_rate=0.0, drop_path_rate=0.0)

    return Config(dict(
        algorithm="hpfg", num_classes=4, in_channels=1,
        train_crop_size=[hw, hw], batch_size=LB, unlabel_batch_size=UB,
        consistency=0.1, consistency_rampup=4.0, epoch_unit_iters=1,
        ema_decay=0.99, seed=0, model1=block(), model2=block()))


def hpfg_step_matches(model: str, hw: int, seed: int = 0) -> None:
    """One HPFG step of the port against the JAX step from the same state
    (a port algorithm's variables) on the same batch and CutMix masks."""
    cfg = hpfg_cfg(model, hw)
    jalgo = jax_build_algorithm("hpfg", cfg, dtype=jnp.float32)
    jalgo.mt_gate_iters = 1
    talgo = build_algorithm("hpfg", cfg, dtype=torch.float32, device="cpu")
    talgo.mt_gate_iters = 1
    m1, m2 = model_state(talgo.model1), model_state(talgo.model2)
    state = TeacherDualState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(seed),
        model1=m1, model2=m2, ema=model_state(talgo.ema),
        opt_state1=jalgo.tx1.init(m1.params),
        opt_state2=jalgo.tx2.init(m2.params))
    load_jax_state(talgo, state)

    def step(st, batch):
        with fnn.intercept_methods(no_dropout):
            return jalgo.step(st, batch)

    rng = np.random.default_rng(seed)
    batch = {
        "label_img": rng.normal(size=(LB, hw, hw, 1)).astype(np.float32),
        "label": rng.integers(0, 4, (LB, hw, hw)).astype(np.int32),
        "label_img1": rng.normal(size=(LB, hw, hw, 1)).astype(np.float32),
        "label1": rng.integers(0, 4, (LB, hw, hw)).astype(np.int32),
        "unlabel_img": rng.normal(size=(UB, hw, hw, 1)).astype(np.float32),
    }
    rm = jax.random.split(state.rng, 5)[4]  # the step's CutMix key
    mask = np.asarray(jcutmix.box_masks(rm, UB, (hw, hw)))
    state, m_j = jax.jit(step)(state, batch)
    m_t = talgo.step(batch, mask=torch.tensor(mask))
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                   rtol=METRIC_RTOL, atol=1e-8, err_msg=k)
    assert float(m_j["loss_contrastive"]) > 0 and float(m_j["pseudo_sup1"]) > 0
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


def test_hpfg_step_on_cmt_plus_matches_jax(shallow_cmt_plus):
    hpfg_step_matches("cmt_plus", 64)
