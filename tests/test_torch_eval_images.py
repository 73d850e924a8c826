"""The port's 2-D evaluation against the JAX package's, on the CPU: the
metrics (``binary_jaccard``, ``binary_asd``, ``calculate_metric_percase_full``,
``MedicalMetric``, ``SegMetrics``, ``AverageMeter``) on random and edge
masks, ``evaluate_images`` in both forms, and the ``unet_lidc`` model
(``UNetLIDC``) against flax.

The metrics are the same numpy / scipy code on both sides and are held
exactly. The model is a width-8 ``unet_lidc`` (3 input channels, 2 classes,
dropout 0) whose flax variables are numpy draws laid out as
``jax.eval_shape`` of the flax init gives them (scales and variances 1 +
0.1 |N|, everything else 0.1 N), loaded into the port with
``load_jax_weights``: the tree is flax's own. Logits and the updated BN
statistics agree to 1e-4 absolute (fp32 on both sides; the convolutions
and BN reductions sum in other orders); the evaluation's predictions are
then equal, so its metrics are held to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.evals import metrics as jm
from hpfg_tpu.evals.volume import SliceForward
from hpfg_tpu.evals.volume import evaluate_images as jax_evaluate_images
from hpfg_tpu.models.unet import UNetLIDC as FlaxUNetLIDC
from hpfg_tpu_torch.evals import metrics as tm
from hpfg_tpu_torch.evals.volume import evaluate_images
from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.models.unet import UNetLIDC
from hpfg_tpu_torch.utils.jax_weights import (
    flatten_tree,
    load_jax_weights,
    module_arrays,
)
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

ATOL = 1e-4
FEATURES = (8,) * 5
NO_DROPOUT = (0.0,) * 5
HW = 32


def _masks():
    """(pred, gt) pairs: overlapping boxes, noise, one side empty, both
    empty, equal, single pixels, a 2-D case."""
    rng = np.random.default_rng(2)
    gt = np.zeros((4, 24, 20), bool)
    gt[1:3, 5:15, 4:12] = True
    pred = gt.copy()
    pred[1, 5:8] = False
    pred[2, 16:20, 3:6] = True
    noisy = rng.random(gt.shape) > 0.7
    empty = np.zeros_like(gt)
    dot_a, dot_b = empty.copy(), empty.copy()
    dot_a[0, 0, 0] = dot_b[3, 23, 19] = True
    flat = rng.random((30, 30)) > 0.5
    return [(pred, gt), (noisy, gt), (pred, empty), (empty, gt),
            (empty, empty), (gt, gt), (dot_a, dot_b), (flat, ~flat)]


@pytest.mark.parametrize("case", range(8))
def test_binary_metrics_match_jax(case):
    pred, gt = _masks()[case]
    assert tm.binary_jaccard(pred, gt) == jm.binary_jaccard(pred, gt)
    assert tm.calculate_metric_percase_full(pred, gt) == \
        jm.calculate_metric_percase_full(pred, gt)
    if pred.any() and gt.any():
        assert tm.binary_asd(pred, gt) == jm.binary_asd(pred, gt)
        assert tm.binary_asd(gt, pred) == jm.binary_asd(gt, pred)
    else:
        for fn in (tm.binary_asd, jm.binary_asd):
            with pytest.raises(ValueError, match="empty"):
                fn(pred, gt)


def test_medical_metric_seg_metrics_average_meter_match_jax():
    rng = np.random.default_rng(4)
    port, ref = tm.MedicalMetric(4), jm.MedicalMetric(4)
    seg_port, seg_ref = tm.SegMetrics(4), jm.SegMetrics(4)
    for i in range(3):
        gt = rng.integers(0, 4, (3, 16, 18))
        pred = np.where(rng.random(gt.shape) < 0.8, gt,
                        rng.integers(0, 4, gt.shape))
        if i == 2:  # a class absent from gt, another from both
            gt[gt == 3] = 0
            pred[pred == 2] = 1
        port.update(pred, gt)
        ref.update(pred, gt)
        seg_port.update(gt, pred)
        seg_ref.update(gt, pred)
    got, want = port.compute(), ref.compute()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(seg_port.confusion, seg_ref.confusion)
    assert seg_port.compute() == seg_ref.compute()
    seg_port.reset()
    assert not seg_port.confusion.any()
    meters = (tm.AverageMeter(), jm.AverageMeter())
    for v, n in ((0.5, 2), (1.5, 1), (-0.25, 4)):
        for m in meters:
            m.update(v, n)
    assert vars(meters[0]) == vars(meters[1])


@pytest.fixture(scope="module")
def flax_lidc():
    """The flax UNetLIDC, numpy draws in its variable tree, and jitted
    train-mode (logits, updated statistics) and ``val`` calls."""
    model = FlaxUNetLIDC(in_channels=3, num_classes=2, feature_chns=FEATURES,
                         dropout=NO_DROPOUT)
    tree = jax.eval_shape(
        lambda k: model.init({"params": k}, jnp.zeros((2, HW, HW, 3)),
                             train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)

    def draw(path, s):
        key = path[-1].key
        if key in ("scale", "var"):
            return (1.0 + 0.1 * np.abs(rng.normal(size=s.shape))).astype(
                np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, dict(tree))

    @jax.jit
    def train(v, x):
        out, mut = model.apply(v, x, train=True, mutable=["batch_stats"])
        return out, mut["batch_stats"]

    return model, variables, train


def _port(variables):
    model = build_model({"model": "unet_lidc", "in_channels": 3,
                         "num_classes": 2, "feature_chns": list(FEATURES),
                         "dropout": list(NO_DROPOUT)})
    load_jax_weights(model, variables["params"], variables["batch_stats"])
    return model


def test_unet_lidc_takes_the_flax_tree_unchanged(flax_lidc):
    """``unet_lidc`` builds the port's UNetLIDC, and every flax variable
    maps onto it by name and shape, as the UNet's do."""
    _, variables, _ = flax_lidc
    model = _port(variables)
    assert type(model) is UNetLIDC
    got = module_arrays(model)
    ref = flatten_tree(variables["params"])
    ref.update(flatten_tree(variables["batch_stats"]))
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_unet_lidc_logits_and_bn_statistics_match_flax(flax_lidc):
    _, variables, train = flax_lidc
    rng = np.random.default_rng(11)
    x = rng.uniform(size=(2, HW, HW, 3)).astype(np.float32)
    out_j, stats_j = jax.device_get(train(variables, jnp.asarray(x)))
    model = _port(variables)
    with torch.no_grad():
        out_t = model(torch.from_numpy(x), train=True)
    assert out_t.shape == (2, HW, HW, 2)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=ATOL, rtol=0)
    buffers = {k: v.numpy() for k, v in model.named_buffers()}
    for k, v in flatten_tree(stats_j).items():
        np.testing.assert_allclose(buffers[k], v, atol=ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("full_metrics", [False, True])
def test_evaluate_images_matches_jax(flax_lidc, full_metrics):
    """Batches of 3, 3 and a last one of 2, as a loader with
    drop_last=False gives them; the JAX side forwards the model's ``val``
    in fp32, as its trainer does."""
    model_j, variables, _ = flax_lidc
    rng = np.random.default_rng(5)
    images = rng.uniform(size=(8, HW, HW, 3)).astype(np.float32)
    labels = np.zeros((8, HW, HW), np.int32)
    labels[:, 8:24, 10:20] = 1
    labels[1] = 0  # one image without foreground
    loader = [(images[i:i + 3], labels[i:i + 3]) for i in range(0, 8, 3)]
    fwd = SliceForward(lambda v, x: model_j.apply(v, x, method=model_j.val),
                       wire_dtype=np.float32)
    want = jax_evaluate_images(fwd, variables, loader, full_metrics)
    got = evaluate_images(_port(variables), loader, torch.device("cpu"),
                          full_metrics)
    assert len(got) == len(want) == (4 if full_metrics else 2)
    assert 0.0 < got[0] < 1.0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
