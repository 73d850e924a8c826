"""Two gaps between the port and the JAX package settled on the CPU: are
they rounding, or a fault of the port?

UCTransNet's gradients (``tests/test_torch_zoo_cnn.py``, ``UCT_GRAD_TOL``):
the port's fp32 gradients differ from JAX's fp32 gradients by up to 2.9e-4
of a parameter's magnitude, where the other families differ by about
1.5e-5. The truth here is float64, on the same weights, input and
cotangents, with the kinks smoothed as in that test, on both sides: the
port's model cast to float64 (its fp32 casts made float64 casts,
``float64_grads``) and the flax model in float64 (``jax_grads``:
``jax.enable_x64``, the module's fp32 names made float64). The two float64 gradients agree to
about 4e-13 of a parameter's magnitude: the two packages compute the same
function. Then the port's fp32 gradients lie about 3.7e-5 from that truth
and JAX's about 2.9e-4: the gap is rounding, and JAX's side carries most
of it (the channel attention's sums over 64 x 960 scores). The test holds
the float64 sides to 1e-9 of each other and the port's fp32 distance to
the truth to no more than JAX's.

CTCT's ``linear_fuse`` kernel at seed pair (5, 5) (``tests/test_torch_ctct
.py``): after three steps two of its elements differ from JAX's by 2.8e-4
and 1.5e-4, above the 1e-4 every other leaf meets, where one of the
SegFormer head's ReLU inputs lies 9e-7 from zero. With ReLU replaced by
softplus in both packages (``smooth_kinks``'s stand-in) the three
steps at (5, 5) hold every leaf of both models to the 1e-4 of that test:
the gap was the kink, taken on opposite sides.
"""

import contextlib
import copy
import functools
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hpfg_tpu.config import Config
from hpfg_tpu.models import build_model as jax_build_model
from hpfg_tpu.models import segformer as jseg
from hpfg_tpu.models import uctransnet as juct
from hpfg_tpu.train.algorithms import build_algorithm as jax_build_algorithm
from hpfg_tpu_torch.models import segformer as tseg
from hpfg_tpu_torch.models import uctransnet as tuct
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.utils.jax_weights import flatten_tree, load_jax_state
from tests.test_torch_ctct import HW, LB, UB, _cfg, _start_state
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401
from tests.test_torch_segformer import TINY_MIT
from tests.test_torch_supervised_cps import assert_models_match
from tests.test_torch_zoo_cnn import (
    UCT_LAYERS,
    ZooCase,
    _leaves,
    module_variables,
    no_dropout,
    smooth_kinks,
)


def float64_grads(model, x: np.ndarray, cot: list) -> dict:
    """The gradients of sum(output * cotangent) of a float64 copy of
    ``model`` in train mode, kinks smoothed: the port's modules cast to
    fp32 with ``.float()`` (BatchNorm, LayerNorm, logits), which is made
    a cast to float64 while the copy runs."""
    m = copy.deepcopy(model).double()
    for mod in m.modules():
        if hasattr(mod, "dtype") and mod.dtype == torch.float32:
            mod.dtype = torch.float64
    with pytest.MonkeyPatch.context() as mp, smooth_kinks():
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        out = _leaves(m(torch.from_numpy(x).double(), train=True))
        sum((o * torch.from_numpy(c).double()).sum()
            for o, c in zip(out, cot)).backward()
    return {k: p.grad.numpy() for k, p in m.named_parameters()}


def jax_grads(cfg: dict, params, stats, x: np.ndarray, cot: list,
              float64: bool = False) -> dict:
    """The flax model's gradients of the same loss, kinks smoothed, in
    fp32, or with ``float64`` built with dtype float64 under
    ``jax.enable_x64`` with the UCTransNet module's ``jnp.float32`` (its
    BatchNorm and LayerNorm dtypes, its einsums' accumulation type) made
    float64."""
    dtype = np.float64 if float64 else np.float32
    f64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                   if not k.startswith("__")})
    f64.float32 = jnp.float64

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, dtype)), tree)

    with contextlib.ExitStack() as stack:
        stack.enter_context(smooth_kinks())
        if float64:
            stack.enter_context(jax.enable_x64())
            mp = stack.enter_context(pytest.MonkeyPatch.context())
            mp.setattr(juct, "jnp", f64)
        module = jax_build_model(Config(**cfg), dtype=jnp.dtype(dtype))
        p, s, xs, cs = cast(params), cast(stats), cast(x), cast(cot)

        def loss(p):
            with fnn.intercept_methods(no_dropout):
                out, _ = module.apply({"params": p, "batch_stats": s}, xs,
                                      train=True, mutable=["batch_stats"])
            return sum(jnp.sum(o * c) for o, c in zip(_leaves(out), cs))

        grads = jax.jit(jax.grad(loss))(p)
        return {k: np.asarray(v) for k, v in flatten_tree(grads).items()}


def _distance(got: dict, truth: dict) -> float:
    """The largest difference of a parameter's gradient from the truth
    over that parameter's largest true gradient, over the parameters whose
    gradient is not zero (the BN-invariant biases' is)."""
    top = max(np.abs(v).max() for v in truth.values())
    return max(np.abs(got[k] - v).max() / np.abs(v).max()
               for k, v in truth.items() if np.abs(v).max() > 1e-4 * top)


def test_uctransnet_grad_gap_is_rounding():
    def fewer_layers(mp):
        mp.setattr(juct, "ChannelTransformer", functools.partial(
            juct.ChannelTransformer, num_layers=UCT_LAYERS))
        mp.setattr(tuct, "LAYERS", UCT_LAYERS)

    case = ZooCase("uctransnet", 32, patch=fewer_layers)
    with case.patched():
        params, stats = module_variables(case.port)
        x = case.input(case.rng)
        xt = torch.from_numpy(x)
        with torch.no_grad():
            out = _leaves(case.port(xt, train=True))
        cot = [case.rng.normal(size=o.shape).astype(np.float32)
               for o in out]
        truth = float64_grads(case.port, x, cot)
        cfg = dict(model="uctransnet", in_channels=1, num_classes=4,
                   train_crop_size=[32, 32])
        jax64 = jax_grads(cfg, params, stats, x, cot, float64=True)
        jax32 = jax_grads(cfg, params, stats, x, cot)
        with smooth_kinks():
            sum((o * torch.from_numpy(c)).sum() for o, c in zip(
                _leaves(case.port(xt, train=True)), cot)).backward()
        port = {k: p.grad.numpy() for k, p in case.port.named_parameters()}
    same = _distance(jax64, truth)
    d_port, d_jax = _distance(port, truth), _distance(jax32, truth)
    print(f"uctransnet: float64 port vs float64 JAX {same:.3e}; fp32 "
          f"gradients' largest distance to the float64 truth, relative: "
          f"port {d_port:.3e}, JAX {d_jax:.3e}")
    assert same <= 1e-9
    assert d_port <= d_jax


def test_ctct_linear_fuse_gap_at_seed_pair_5_5_is_the_kink():
    """Three CTCT steps at (weights, data) = (5, 5) with ReLU -> softplus
    in both packages: every leaf within the 1e-4 of
    ``tests/test_torch_ctct.py`` (the BN-invariant parameters and the head's
    running mean aside, as there)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jseg.MIT_SETTINGS, "T", TINY_MIT)
        mp.setitem(tseg.MIT_SETTINGS, "T", TINY_MIT)
        mp.setattr(torch, "relu", F.softplus)
        mp.setattr(jax.nn, "relu", jax.nn.softplus)
        jcfg = _cfg()
        jcfg.model2.model = "unet"  # its registry builds the B0 SegFormer
        jalgo = jax_build_algorithm("ctct", jcfg, dtype=jnp.float32)
        jalgo.net2 = jseg.SegFormer(image_size=(HW, HW), in_channels=1,
                                    num_classes=4, model_name="T")
        step = jax.jit(jalgo.step)
        state = _start_state(jalgo, 5)
        talgo = build_algorithm("ctct", _cfg(), dtype=torch.float32,
                                device="cpu")
        load_jax_state(talgo, jax.device_get(state))
        rng = np.random.default_rng(5)
        for _ in range(3):
            batch = {
                "label_img": rng.normal(size=(LB, HW, HW, 1)).astype(
                    np.float32),
                "label": rng.integers(0, 4, (LB, HW, HW)).astype(np.int32),
                "unlabel_img": rng.normal(size=(UB, HW, HW, 1)).astype(
                    np.float32)}
            with fnn.intercept_methods(no_dropout):
                state, _ = step(state, batch)
            talgo.step(batch)
    ref = flatten_tree(jax.device_get(state.model2.params))
    got = dict(talgo.model2.named_parameters())
    err = float(np.abs(got["decoder.linear_fuse.kernel"].detach().numpy()
                       - ref["decoder.linear_fuse.kernel"]).max())
    print(f"ctct (5, 5), softplus: linear_fuse kernel max abs difference "
          f"{err:.3e} (bound 1e-4)")
    assert_models_match(talgo, state, ["model1"])
    assert_models_match(talgo, state, ["model2"],
                        skip=sorted(tseg.BN_INVARIANT) + ["decoder.bn.mean"])
