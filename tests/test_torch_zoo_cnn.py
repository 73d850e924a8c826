"""The port's UNet_Large, ResUNet, ResUNet++ and UCTransNet against the JAX
package's on the CPU, at full width on 32x32 images (UCTransNet with 2 of
its 4 channel-transformer layers in both packages, ``UCT_LAYERS``: the
layers are the same code, and each adds to the JAX compile on the CPU),
and the inits they and the rest of the zoo use. The harness here (``ZooCase``) also serves
``test_torch_transunet.py``, ``test_torch_cmt.py`` and
``test_torch_uniformer.py``.

For each family: the port's variables (built from a torch seed) map onto
the tree ``jax.eval_shape`` of the flax init lays out, name for name and
shape for shape (``module_variables``, which ``load_jax_weights`` inverts
strictly); the eval-mode output (``val``) agrees; one train-mode forward
agrees (every output: the logits, and the *_plus necks' (global, dense)
pairs), with the BatchNorm statistics it folds; and the gradient of every
parameter of a loss sum(output * cotangent), the cotangents numpy draws,
agrees with ``jax.grad`` of the same loss.

The BN running statistics are calibrated before the comparison (one
train-mode forward of the port with momentum 0 on another input, so that
they are batch statistics of a real activation, then scaled by numpy
draws): at their init values (0, 1) the ReLUs of the eval forward are
nearly all off and the logits nearly constant, which would compare
nothing. Dropout and DropPath are the identity on both sides: the port's
rates are 0 (``drop_rate`` / ``drop_path_rate`` hooks), and the JAX forward
is traced inside ``flax.linen.intercept_methods`` with ``no_dropout``.

The gradients are taken through a second train-mode forward in which
ReLU and the 2x2 max pool are softplus and the 2x2 average pool, on both
sides (``smooth_kinks``; the outputs and statistics above are those of the
models as they are). At a kink two fp32 implementations that agree to
1e-6 take opposite derivatives for an element that lies within their
rounding of it, and one such element moves every gradient upstream of it
by up to several percent. At full width some element always does: with
the kinks in place the gradient comparison failed for every family and
every seed tried (UNet_Large at seeds 0, 1, 2: 2.5e-2, 3e-3, 7e-2 of a
gradient's magnitude), while the same models agreed to about 1e-5 where
no kink was crossed. The smooth functions keep every other operation of
the backward (the convs, BatchNorms, concats, resizes, attention,
squeeze-excitation, necks) and remove that chance.

Tolerances (fp32 on both sides, convs, matmuls and reductions summed in
other orders):
- every output within 1e-4 of the reference tensor's largest magnitude;
  ``val`` within four times the reference's own change when its input
  moves by relative 1e-7 draws, where that is larger (TransUNet: its
  attention multiplies the logits by sqrt(head_dim) = 16 and the softmax
  is nearly one-hot, so with the running statistics of the eval forward a
  perturbation at fp32's rounding moved JAX's own logits by up to 4.5e-4
  of their magnitude with the published 8 ViT blocks; in train mode the
  two sides agreed to 1.6e-5);
- BN statistics within 1e-4 of the largest statistic of their tensor, or
  1e-5, whichever is larger;
- every parameter's gradient within 1e-4 of its own largest magnitude
  plus 2e-6 of the model's largest gradient. The second term is the
  backward's summation noise, which scales with the gradients flowing
  through a layer, not with its parameters' own: the attention and FFN
  weights of UCTransNet's channel transformer, whose gradients are 1e-3
  to 1e-2 of the largest, differ by up to 1.5e-6 of it. UCTransNet's own
  term is 5e-4 (``UCT_GRAD_TOL``): the finest scale's LayerNorm, FFN,
  query and reconstruction gradients differ by up to 2.9e-4 of their
  magnitude (the channel attention's softmax over 960 channels and its
  instance norm over 64 x 960 scores, summed in other orders), where the
  other families differ by about 1.5e-5. That gap is rounding on JAX's
  side (``tests/test_torch_rounding_truth.py``): in float64 the two
  packages' gradients agree to 4e-13, and against that truth the port's
  fp32 gradients lie 3.6e-5 away, JAX's jitted fp32 ones 2.9e-4 (4.1e-4
  run op by op); so the bound stays, for JAX's rounding. For TransUNet
  (``perturbed_grads``) a gradient may also differ by four times JAX's
  own change under that input perturbation: the backward through its
  nearly one-hot softmax amplifies rounding the same way (with 8 blocks
  the stem conv's gradient moved by 1% of its magnitude);
- a parameter that the train-mode forward does not depend on has an exact
  gradient of zero, which both sides compute as rounding noise (up to
  6e-6 of the largest gradient): a bias that only a train-mode BatchNorm
  reads, which subtracts it again. Those among the parameters whose
  reference gradient is below 1e-4 of the largest are found by adding
  N(0, 1) draws to them (``invariant_subset``: no output may move by more
  than 1e-4 of its magnitude, where a parameter the output depends on
  moves it by 1e-3 or more) and held to 1e-4 of the largest gradient on
  the port's side; the others are compared as above.
"""

import contextlib
import functools
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hpfg_tpu.config import Config
from hpfg_tpu.models import build_model as jax_build_model
from hpfg_tpu.models import uctransnet as juct
from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.models import layers as tlayers
from hpfg_tpu_torch.models import uctransnet as tuct
from hpfg_tpu_torch.utils.jax_weights import flatten_tree, module_variables
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401
from tests.test_torch_segformer import no_dropout

REL_TOL = 1e-4
STATS_ATOL = 1e-5
#: the gradients' tolerance beyond REL_TOL of their own magnitude: this
#: share of the model's largest gradient
GRAD_FLOOR = 2e-6
NO_DROP = dict(drop_rate=0.0, drop_path_rate=0.0)
#: UCTransNet's channel-transformer layers in these tests, and its
#: gradients' tolerance relative to their own magnitude (module docstring)
UCT_LAYERS, UCT_GRAD_TOL = 2, 5e-4


@contextlib.contextmanager
def smooth_kinks():
    """ReLU -> softplus and the 2x2 max pool -> the 2x2 average pool, in
    both packages (``torch.relu``, ``F.max_pool2d``, ``jax.nn.relu``,
    ``flax.linen.max_pool``: the modules look them up when they run, or
    when JAX traces them)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "relu", F.softplus)
        mp.setattr(F, "max_pool2d", F.avg_pool2d)
        mp.setattr(jax.nn, "relu", jax.nn.softplus)
        mp.setattr(fnn, "max_pool", fnn.avg_pool)
        yield


def shape_tree(module, hw: int, channels: int = 1) -> dict:
    """{flattened name: shape} of the flax variables (``eval_shape`` of
    the init: traced, not compiled)."""
    tree = jax.eval_shape(
        lambda k: module.init({"params": k},
                              jnp.zeros((2, hw, hw, channels)), train=False),
        jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(p.key) for p in path[1:]): tuple(leaf.shape)
            for path, leaf in leaves}


def calibrate(model, x: np.ndarray, seed: int) -> None:
    """Set the running statistics to one train-mode forward's batch
    statistics on ``x`` (momentum 0), the means shifted by 0.1 N and the
    variances scaled by 1 + 0.2 U: eval then differs from train."""
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(tlayers, "BN_MOMENTUM", 0.0)
        model(torch.from_numpy(x), train=True)
        rng = np.random.default_rng(seed)
        for name, buf in model.named_buffers():
            draw = torch.from_numpy(rng.random(buf.shape).astype(np.float32))
            if name.endswith(".mean"):
                buf.add_(0.1 * (draw - 0.5))
            else:
                buf.mul_(1.0 + 0.2 * draw)


def _leaves(out):
    """The outputs in order: the logits, then (g_high, d_high, g_head,
    d_head) for a *_plus model."""
    if isinstance(out, tuple):
        return [out[0], *out[1], *out[2]]
    return [out]


class ZooCase:
    """One family: the port model (rates 0, seeded init, calibrated BN
    statistics), the flax module of the same registry name, and a jitted
    JAX function that returns, for (params, batch_stats, x, cotangents),
    the train-mode outputs, the updated statistics, the parameter
    gradients of sum(output * cotangent) and the ``val`` logits."""

    def __init__(self, name: str, hw: int, seed: int = 0, channels: int = 1,
                 perturbed_grads: bool = False, patch=None,
                 grad_tol: float = REL_TOL, **cfg):
        self.name, self.hw, self.channels = name, hw, channels
        self.patch, self.grad_tol = patch, grad_tol
        cfg = dict(model=name, in_channels=channels, num_classes=4,
                   train_crop_size=[hw, hw], **cfg)
        with self.patched():
            self.port = build_model(
                {**cfg, **NO_DROP},
                generator=torch.Generator().manual_seed(seed))
            self.flax = jax_build_model(Config(**cfg))
            rng = np.random.default_rng(seed)
            calibrate(self.port, self.input(rng), seed + 1)
        self.rng = rng
        module = self.flax

        def loss(params, stats, x, cot):
            with fnn.intercept_methods(no_dropout):
                out, mut = module.apply(
                    {"params": params, "batch_stats": stats}, x, train=True,
                    mutable=["batch_stats"])
            value = sum(jnp.sum(o * c) for o, c in zip(_leaves(out), cot))
            return value, (out, mut["batch_stats"])

        def run(params, stats, x, cot):
            _, (out, new_stats) = loss(params, stats, x, cot)
            val = self._val(params, stats, x)
            with smooth_kinks():  # while JAX traces the backward
                grad = jax.grad(loss, has_aux=True)
                grads = grad(params, stats, x, cot)[0]
                if perturbed_grads:
                    grads = (grads, grad(params, stats, perturb(x), cot)[0])
            return out, new_stats, grads, val

        self.run = jax.jit(run)

    @contextlib.contextmanager
    def patched(self):
        """``patch(monkeypatch)`` applied (a depth cut in both packages)
        while the models are built and traced, and undone after."""
        with pytest.MonkeyPatch.context() as mp:
            if self.patch is not None:
                self.patch(mp)
            yield

    def _val(self, params, stats, x):
        """The flax ``val`` of x and of x perturbed at fp32's rounding
        (relative 1e-7 draws), in one eval-mode batch."""
        both = self.flax.apply({"params": params, "batch_stats": stats},
                               jnp.concatenate([x, perturb(x)]),
                               method=self.flax.val)
        return both[:len(x)], both[len(x):]

    def _check_val(self) -> None:
        """``val`` alone against JAX (one forward to compile, not three)."""
        params, stats = module_variables(self.port)
        x = self.input(self.rng)
        with torch.no_grad():
            got = self.port.val(torch.from_numpy(x))
        assert_val(got, jax.jit(self._val)(params, stats, x))

    def check_val(self) -> None:
        with self.patched():
            self._check_val()

    def check_weight_map(self) -> dict:
        with self.patched():
            return self._check_weight_map()

    def check_forward_backward(self) -> set[str]:
        with self.patched():
            return self._check_forward_backward()

    def input(self, rng) -> np.ndarray:
        return rng.normal(size=(2, self.hw, self.hw, self.channels)).astype(
            np.float32)

    def _check_weight_map(self) -> dict:
        """The port's variables against the flax tree: the same names and
        shapes. Returns {name: shape}."""
        want = shape_tree(self.flax, self.hw, self.channels)
        got = {k: tuple(v.shape) for k, v in self.port.state_dict().items()}
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert got[k] == s, (k, got[k], s)
        return got

    def _check_forward_backward(self) -> set[str]:
        """``val``, the train-mode outputs, the folded statistics and the
        gradients against JAX. Returns the parameters whose gradient is
        zero."""
        params, stats = module_variables(self.port)
        x = self.input(self.rng)
        xt = torch.from_numpy(x)
        with torch.no_grad():
            val_t = self.port.val(xt)
        with torch.no_grad():
            out_t = _leaves(self.port(xt, train=True))
        buffers = {k: v.numpy().copy() for k, v in self.port.named_buffers()}
        cot = [self.rng.normal(size=o.shape).astype(np.float32)
               for o in out_t]
        with smooth_kinks():
            sum((o * torch.from_numpy(c)).sum() for o, c in zip(
                _leaves(self.port(xt, train=True)), cot)).backward()
        out_j, stats_j, grads_j, val_j = self.run(params, stats, x, cot)
        assert_val(val_t, val_j)
        for i, (t, j) in enumerate(zip(out_t, _leaves(out_j))):
            assert_close(t.detach(), j, f"train output {i}")
        ref = flatten_tree(stats_j)
        assert set(ref) == set(buffers)
        for k, v in ref.items():
            np.testing.assert_allclose(
                buffers[k], v, rtol=0, err_msg=k,
                atol=max(REL_TOL * np.abs(v).max(), STATS_ATOL))
        return assert_grads(self.port, grads_j, x, self.grad_tol)


def assert_close(got, ref, what: str, tol: float = REL_TOL) -> None:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(),
                               rtol=0, err_msg=what)


def invariant_subset(model, names: set[str], x: np.ndarray) -> set[str]:
    """The parameters among ``names`` that the train-mode outputs on ``x``
    do not depend on: adding N(0, 1) draws to a group of them moves no
    output beyond REL_TOL of its largest magnitude. A group that moves one
    is halved until the parameters that move it are found alone (a few
    forwards where nearly all are invariant). The model's state is
    restored."""
    state = {k: v.clone() for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(0)
    xt = torch.from_numpy(x)

    def still(group) -> bool:
        with torch.no_grad():
            for name in group:
                params[name].add_(torch.randn(params[name].shape,
                                              generator=gen))
            moved = _leaves(model(xt, train=True))
        model.load_state_dict(state)
        return all((o - b).abs().max() <= REL_TOL * b.abs().max()
                   for o, b in zip(moved, base))

    def search(group: list[str]) -> list[str]:
        if not group or still(group):
            return group
        if len(group) == 1:
            return []
        half = len(group) // 2
        return search(group[:half]) + search(group[half:])

    with torch.no_grad():
        base = _leaves(model(xt, train=True))
    model.load_state_dict(state)
    return set(search(sorted(names)))


def perturb(x):
    """x moved by relative 1e-7 draws: a perturbation at fp32's rounding."""
    return x * (1 + 1e-7 * jax.random.normal(jax.random.PRNGKey(1),
                                             x.shape))


def assert_val(got, want) -> None:
    """``val`` within REL_TOL of the reference's magnitude, or within four
    times the reference's own change under an input perturbation at fp32's
    rounding, whichever is larger (``want``: the flax ``val`` of x and of
    the perturbed x)."""
    ref, moved = (np.asarray(w) for w in want)
    sensitivity = np.abs(moved - ref).max() / np.abs(ref).max()
    assert_close(got, ref, "val", tol=max(REL_TOL, 4 * sensitivity))


def assert_grads(model, grads_j, x: np.ndarray,
                 tol: float = REL_TOL) -> set[str]:
    """Every parameter's gradient against the JAX one (tolerance: the
    module docstring; ``grads_j`` may be a pair, the gradients at x and at
    the perturbed x). Returns the parameters with a zero gradient."""
    moved = None
    if isinstance(grads_j, tuple):
        grads_j, moved = grads_j[0], flatten_tree(grads_j[1])
    ref = flatten_tree(grads_j)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(ref)
    top = max(np.abs(v).max() for v in ref.values())
    zero = invariant_subset(model, {k for k, v in ref.items()
                                    if np.abs(v).max() <= REL_TOL * top}, x)
    assert all(k.endswith(".bias") for k in zero), sorted(zero)
    for k, v in ref.items():
        if k in zero:
            assert np.abs(got[k]).max() <= REL_TOL * top, k
        else:
            atol = tol * np.abs(v).max() + GRAD_FLOOR * top
            if moved is not None:
                atol = max(atol, 4 * np.abs(moved[k] - v).max())
            np.testing.assert_allclose(got[k], v, rtol=0, err_msg=k,
                                       atol=atol)
    return zero


@pytest.fixture(scope="module", params=["unet_large", "resunet",
                                        "resunet_plusplus", "uctransnet"])
def cnn_case(request):
    def fewer_layers(mp):
        mp.setattr(juct, "ChannelTransformer", functools.partial(
            juct.ChannelTransformer, num_layers=UCT_LAYERS))
        mp.setattr(tuct, "LAYERS", UCT_LAYERS)

    if request.param == "uctransnet":
        return ZooCase("uctransnet", 32, patch=fewer_layers,
                       grad_tol=UCT_GRAD_TOL)
    return ZooCase(request.param, 32)


def test_weight_map_is_the_flax_tree(cnn_case):
    cnn_case.check_weight_map()


@functools.lru_cache(maxsize=None)
def port_shapes(name: str, hw: int, channels: int = 1) -> dict:
    """{state-dict key: shape} of the port's ``name`` at ``hw``^2 (4
    classes; built once per module)."""
    model = build_model({"model": name, "in_channels": channels,
                         "num_classes": 4, "train_crop_size": [hw, hw]})
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name,key,shape", [
    ("unet_large", "up1.conv1.kernel", (3, 3, 512, 256)),
    ("unet_large", "out_conv.kernel", (1, 1, 32, 4)),
    ("resunet", "bridge.skip.kernel", (3, 3, 256, 512)),
    ("resunet", "up_residual_conv1.bn1.mean", (768,)),
    ("resunet_plusplus", "c2.attn.Dense_0.kernel", (32, 4)),
    ("resunet_plusplus", "d1_attn.gc_conv.kernel", (1, 1, 256, 1)),
    ("resunet_plusplus", "b1.c3.kernel", (3, 3, 128, 256)),
    ("uctransnet", "mtc.block3.channel_attn.key_3.kernel", (960, 960)),
    ("uctransnet", "mtc.pos_embed0", (1, 4, 64)),
    ("uctransnet", "up4.coatt.mlp_g.kernel", (512, 512)),
])
def test_published_shapes(name, key, shape):
    """The published widths at 32^2: UNet_Large's concat of 8c + 8c into
    4c, the ResUNets' concats, ResUNet++'s squeeze-excitation (ratio 8)
    and gate, UCTransNet's 960-wide keys (four layers), its 2x2 token grid
    and its CCA gates."""
    assert port_shapes(name, 32)[key] == shape


def test_forward_backward_match_jax(cnn_case):
    zero = cnn_case.check_forward_backward()
    example = {"unet_large": None, "resunet": "input_conv1.bias",
               "resunet_plusplus": "d1_attn.g_conv.bias",
               "uctransnet": "mtc.reconstruct0.bias"}[cnn_case.name]
    assert example in zero if example else not zero


def test_unet_large_base_c_hook():
    """``base_c`` is read from the config (64: the LIDC variant)."""
    model = build_model({"model": "unet_large", "base_c": 64,
                         "in_channels": 3, "num_classes": 2})
    assert model.in_conv.conv1.kernel.shape == (3, 3, 3, 64)
    assert model.up1.conv2.kernel.shape == (3, 3, 512, 256)
    assert model.out_conv.kernel.shape == (1, 1, 64, 2)


def test_unet_large_pads_odd_sizes_as_jax():
    """At 36x44 the up path meets skips one row / column larger than the
    upsampled input (9 -> 4 -> 8 against 9): the zero padding agrees."""
    case = ZooCase("unet_large", 32)
    x = np.random.default_rng(5).normal(size=(2, 36, 44, 1)).astype(
        np.float32)
    params, stats = module_variables(case.port)
    want = case.flax.apply({"params": params, "batch_stats": stats}, x,
                           method=case.flax.val)
    with torch.no_grad():
        got = case.port.val(torch.from_numpy(x))
    assert_close(got, want, "val at 36x44")


def _stats(a: np.ndarray) -> tuple[float, float, float]:
    return float(a.mean()), float(a.std()), float(np.abs(a).max())


def test_lecun_normal_matches_flax_draw():
    """``lecun_normal`` and flax's default kernel init: std sqrt(1/fan_in)
    (truncated at 2 / 0.8796 of it), mean 0."""
    fan_in, n = 288, 200_000
    want = np.asarray(fnn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (fan_in, n // fan_in * 10)))
    got = tlayers.lecun_normal((fan_in, n // fan_in * 10), fan_in,
                               torch.Generator().manual_seed(0)).numpy()
    std = math.sqrt(1.0 / fan_in)
    for a in (want, got):
        mean, s, top = _stats(a)
        assert abs(mean) < 0.01 * std and abs(s / std - 1) < 0.01
        assert top <= 2 * std / 0.87962566103423978 + 1e-7


@pytest.mark.parametrize("layer,fan_in", [
    (lambda g: tlayers.Conv(32, 64, 3, g, init="lecun"), 9 * 32),
    (lambda g: tlayers.Dense(128, 256, g, init="lecun"), 128),
], ids=["conv", "dense"])
def test_lecun_init_layers(layer, fan_in):
    """``init="lecun"``: the kernel's std sqrt(1/fan_in), a zero bias."""
    m = layer(torch.Generator().manual_seed(1))
    assert abs(m.kernel.std().item() * math.sqrt(fan_in) - 1) < 0.03
    assert not m.bias.any()


def test_torch_default_conv_init():
    """torch's default U(+-1/sqrt(fan_in)) for kernel and bias."""
    conv = tlayers.Conv(64, 128, 3, torch.Generator().manual_seed(3))
    bound = 1 / math.sqrt(9 * 64)
    k = conv.kernel.detach().numpy()
    assert np.abs(k).max() <= bound and np.abs(k).max() > 0.99 * bound
    assert abs(k.std() / (bound / math.sqrt(3)) - 1) < 0.02
    assert np.abs(conv.bias.detach().numpy()).max() <= bound


def test_depthwise_layout_and_bound():
    """A depthwise conv ``Conv(1, C, k)`` is [k, k, 1, C] with fan-in k*k
    (flax's ``feature_group_count=C`` layout and ``torch_bias_init(k*k)``)."""
    dw = tlayers.Conv(1, 256, 5, torch.Generator().manual_seed(4))
    assert dw.kernel.shape == (5, 5, 1, 256)
    assert 0.19 < np.abs(dw.kernel.detach().numpy()).max() <= 0.2
    assert 0.19 < np.abs(dw.bias.detach().numpy()).max() <= 0.2


@pytest.mark.parametrize("name", ["resunet", "resunet_plusplus",
                                  "uctransnet"])
def test_flax_default_families_have_zero_biases(name):
    """The families on flax's default init: every conv and Dense bias 0,
    every kernel drawn (lecun_normal)."""
    model = build_model({"model": name, "train_crop_size": [32, 32]})
    layers = [m for m in model.modules()
              if isinstance(m, (tlayers.Conv, tlayers.Dense))]
    assert layers and all(m.bias is None or not m.bias.any()
                          for m in layers)
    assert all(m.kernel.std() > 0 for m in layers)
