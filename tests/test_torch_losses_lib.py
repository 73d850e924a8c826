"""The port's loss library (``ops/losses.py``: the soft-target, binary and
per-sample dice, KL, MSE, entropy, focal and BCE + dice (+ smooth L1)
losses), ``get_current_consistency_weight`` and ``patients_to_slices``
against the JAX package on the CPU.

Inputs are NHWC, made with numpy from a seed: 2 x 16 x 16 x 4 (four
classes) and 2 x 16 x 16 x 1 for the binary losses. Both sides run in
fp32: each value agrees to 1e-6 relative, and the gradient with respect to
the first argument (``jax.grad`` against ``torch.autograd``) to 1e-5 of
its largest magnitude; ``entropy_loss_map`` is compared as a map, its
gradient through a random weighting of the map. A focal loss with a
gradient through pt, or a smooth L1 that switches elsewhere than
|x - t| = 1, moves the gradients far past that.

Then the losses that take a ``mesh`` over 2 gloo ranks (the harness of
``tests/test_torch_parallel.py``), each rank on its half of a batch of 4
whose halves differ in mean and scale: the loss equals the one-process
loss of the whole batch to 1e-6 relative on every rank, and each rank's
gradient of its rows, over W (the step's gradient all-reduce), equals the
one-process gradient of those rows to 1e-6 of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.data.loader import patients_to_slices as jax_patients
from hpfg_tpu.ops import losses as jl
from hpfg_tpu.ops import rampup as jr
from hpfg_tpu_torch.data.loader import patients_to_slices
from hpfg_tpu_torch.ops import contrastive as tc
from hpfg_tpu_torch.ops import losses as tl
from hpfg_tpu_torch.ops import rampup as tr
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401
from tests.test_torch_parallel import WORLD, join_all, spawn

VALUE_RTOL = 1e-6
GRAD_RTOL = 1e-5
DIST_RTOL = 1e-6
SHAPE = (2, 16, 16, 4)
BINARY = (2, 16, 16, 1)
ALPHA = [0.1, 0.2, 0.3, 0.4]
SEED = 3


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def _inputs(seed: int, batch: int = 2, spread: bool = False) -> dict:
    """Every input of the cases, at ``batch`` rows; with ``spread`` the
    second half of the rows has another mean and scale than the first."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        x = rng.normal(size=(batch,) + shape).astype(np.float32) * 2.0
        if spread:
            x[batch // 2:] = x[batch // 2:] * 3.0 + 1.5
        return x

    h, w, c = SHAPE[1:]
    return {"a": normal(h, w, c), "b": normal(h, w, c),
            "pa": _softmax(normal(h, w, c)), "pb": _softmax(normal(h, w, c)),
            "labels": rng.integers(0, c, (batch, h, w)).astype(np.int32),
            "x1": normal(*BINARY[1:]),
            "p1": _sigmoid(normal(*BINARY[1:])),
            "t1": (rng.random((batch, h, w, 1)) < 0.4).astype(np.float32)}


#: name -> (function, first argument, other arguments, keyword arguments)
CASES = {
    "dice_loss_from_probs": ("dice_loss_from_probs", "pa", ("pb",), {}),
    "softmax_dice_loss": ("softmax_dice_loss", "a", ("b",), {}),
    "dice_loss_binary": ("dice_loss_binary", "p1", ("t1",), {}),
    "softmax_kl_loss": ("softmax_kl_loss", "a", ("b",), {}),
    "softmax_kl_loss_sigmoid": ("softmax_kl_loss", "a", ("b",),
                                {"sigmoid": True}),
    "symmetric_mse_loss": ("symmetric_mse_loss", "a", ("b",), {}),
    "entropy_loss": ("entropy_loss", "pa", (), {"num_classes": 4}),
    "entropy_loss_map": ("entropy_loss_map", "pa", (), {"num_classes": 4}),
    "focal_loss": ("focal_loss", "a", ("labels",), {}),
    "focal_loss_alpha_gamma3": ("focal_loss", "a", ("labels",),
                                {"alpha": ALPHA, "gamma": 3.0}),
    "focal_loss_sum": ("focal_loss", "a", ("labels",),
                       {"size_average": False}),
    "focal_loss_alpha_sum": ("focal_loss", "a", ("labels",),
                             {"alpha": ALPHA, "size_average": False}),
    "bce_dice_loss": ("bce_dice_loss", "x1", ("t1",), {}),
    "bce_dice_l1_loss": ("bce_dice_l1_loss", "x1", ("t1",), {}),
}
#: the cases whose function takes a mesh (all but the pointwise map)
MESH_CASES = tuple(k for k, v in CASES.items() if v[0] != "entropy_loss_map")


def _jax_case(name: str, inputs: dict, weight):
    fn, first, rest, kwargs = CASES[name]

    def f(x):
        out = getattr(jl, fn)(x, *(jnp.asarray(inputs[k]) for k in rest),
                              **kwargs)
        return out, (jnp.sum(out * weight) if out.ndim else out)

    value, _ = f(jnp.asarray(inputs[first]))
    grad = jax.grad(lambda x: f(x)[1])(jnp.asarray(inputs[first]))
    return np.asarray(value), np.asarray(grad)


def _torch_case(name: str, inputs: dict, weight):
    """(value, gradient of the first argument) of the port's loss; a map's
    gradient is that of its sum weighted by ``weight``."""
    fn, first, rest, kwargs = CASES[name]
    x = torch.from_numpy(inputs[first].copy()).requires_grad_(True)
    out = getattr(tl, fn)(x, *(torch.from_numpy(inputs[k]) for k in rest),
                          **kwargs)
    scalar = (out * weight).sum() if out.dim() else out
    scalar.backward()
    return out.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_loss_value_and_gradient_match_jax(name):
    inputs = _inputs(SEED)
    weight = np.random.default_rng(SEED + 1).normal(
        size=SHAPE[:3] + (1,)).astype(np.float32)
    want, want_grad = _jax_case(name, inputs, weight)
    got, grad = _torch_case(name, inputs, torch.from_numpy(weight))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= VALUE_RTOL * scale, (got, want)
    assert grad.shape == want_grad.shape
    g_scale = np.abs(want_grad).max()
    assert g_scale > 0
    assert np.abs(grad - want_grad).max() <= GRAD_RTOL * g_scale


def test_softmax_kl_loss_lives_in_losses():
    """contrastive.py's symmetric KL takes softmax_kl_loss from losses.py,
    where the JAX package has it."""
    assert tc.softmax_kl_loss is tl.softmax_kl_loss


@pytest.mark.parametrize("step", [0, 5, 40])
def test_get_current_consistency_weight_matches_jax(step):
    got = tr.get_current_consistency_weight(step, 0.1, 40.0)
    assert isinstance(got, float)
    np.testing.assert_allclose(
        got, float(jr.get_current_consistency_weight(step, 0.1, 40.0)),
        rtol=VALUE_RTOL)


_ACDC = ("3", "7", "14", "21", "28", "35", "140")
_PROSTATE = ("2", "4", "8", "12", "16", "21", "42")


@pytest.mark.parametrize("dataset,count", [("ACDC", int(n)) for n in _ACDC]
                         + [("Prostate", n) for n in _PROSTATE]
                         + [("ACDC_2017", "7"), ("Synapse", 8)])
def test_patients_to_slices_matches_jax(dataset, count):
    assert patients_to_slices(dataset, count) == jax_patients(dataset, count)


@pytest.mark.parametrize("dataset,count", [("ACDC", 5), ("Prostate", 3)])
def test_patients_to_slices_unknown_count_raises(dataset, count):
    with pytest.raises(KeyError):
        jax_patients(dataset, count)
    with pytest.raises(KeyError):
        patients_to_slices(dataset, count)


# ---------------------------------------------------------------------------
# the mesh-taking losses over 2 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_rank_losses(tmp_path_factory):
    """(inputs, the workers' results): every mesh-taking case on each
    rank's rows of one batch of 2 * WORLD rows."""
    out = tmp_path_factory.mktemp("losses")
    inputs = _inputs(7, batch=2 * WORLD, spread=True)
    torch.save({"inputs": {k: torch.from_numpy(v) for k, v in inputs.items()},
                "cases": {k: CASES[k] for k in MESH_CASES}},
               out / "losses.pt")
    outs, codes = join_all(spawn("losses", str(out)), 60)
    assert codes == [0] * WORLD, "\n".join(outs)
    ranks = [torch.load(out / f"losses{r}.pt", weights_only=True)
             for r in range(WORLD)]
    return inputs, ranks


@pytest.mark.parametrize("name", MESH_CASES)
def test_mesh_loss_over_two_ranks_matches_one_process(two_rank_losses,
                                                      name):
    inputs, ranks = two_rank_losses
    want, want_grad = _torch_case(name, inputs, None)
    n = want_grad.shape[0] // WORLD
    scale = np.abs(want_grad).max()
    for r, res in enumerate(ranks):
        value, grad = res[name]
        np.testing.assert_allclose(float(value), float(want),
                                   rtol=DIST_RTOL)
        rows = want_grad[r * n:(r + 1) * n]
        assert np.abs(grad.numpy() / WORLD - rows).max() <= DIST_RTOL * scale
