"""The port's config parser, ACDC loaders and volume metrics against the JAX
package's, on the CPU (the other datasets: ``test_torch_datasets_2d.py``).

All three are the same numpy / scipy / yaml code on both sides, so they are
held exactly: equal configs, bit-equal batches, equal metrics.
"""

import glob
import os

import numpy as np
import pytest

from hpfg_tpu.config import parse_config as jax_parse_config
from hpfg_tpu.data import builder as jbuilder
from hpfg_tpu.evals.metrics import calculate_metric_percase as jax_metric
from hpfg_tpu_torch.config import parse_config
from hpfg_tpu_torch.data import builder
from hpfg_tpu_torch.data.preflight import DataPreflightError, preflight_or_raise
from hpfg_tpu_torch.evals.metrics import calculate_metric_percase

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def test_all_configs_are_listed():
    assert len(CONFIGS) == 39


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_parse_config_matches_jax(path):
    argv = ["--config", path, "--set", "total_itrs=7", "--set",
            "model1.lr=0.5", "--set", "train_crop_size=[32,48]",
            "--set", "device=cpu"]
    got = parse_config("port", "unused.yaml", argv)
    ref = jax_parse_config("jax", "unused.yaml", argv)
    assert got == ref
    assert got.total_itrs == 7 and got.model1.lr == 0.5


def _cfg(root, **kw):
    from hpfg_tpu.config import Config

    base = dict(datasets="acdc", data_path=root, batch_size=2,
                unlabel_batch_size=3, train_crop_size=[32, 32],
                label_num=0.25, seed=5)
    base.update(kw)
    return Config(base)


def test_ssl_acdc_loaders_yield_the_jax_batches(synthetic_acdc):
    cfg = _cfg(synthetic_acdc)
    got, ref = builder.build_loader(cfg), jbuilder.build_loader(cfg)
    assert len(got) == len(ref) == 3
    for g, r in zip(got[:2], ref[:2]):
        assert len(g) == len(r) > 0
        cg, cr = g.cycle(), r.cycle()
        for _ in range(len(r) + 2):  # into the second epoch
            (gi, gl), (ri, rl) = next(cg), next(cr)
            np.testing.assert_array_equal(gi, ri)
            np.testing.assert_array_equal(gl, rl)
            assert gi.dtype == np.float32 and gl.dtype == np.int32
    for (gi, gl), (ri, rl) in zip(got[2], ref[2]):
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)


def test_sup_acdc_loader_yields_the_jax_batches(synthetic_acdc):
    cfg = _cfg(synthetic_acdc, datasets="sup_acdc", batch_size=4)
    (g, _), (r, _) = builder.build_loader(cfg), jbuilder.build_loader(cfg)
    for (gi, gl), (ri, rl) in zip(g, r):
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)


@pytest.mark.parametrize("kw,error,match", [
    ({"datasets": "prostate"}, ValueError, "unknown datasets"),
    ({"device_augment": True}, NotImplementedError, "device_augment"),
])
def test_unported_loaders_raise(synthetic_acdc, kw, error, match):
    """An unknown dataset name raises ValueError, as the JAX builder does;
    the on-device augmentation path is not ported and raises."""
    with pytest.raises(error, match=match):
        builder.build_loader(_cfg(synthetic_acdc, **kw))


def test_preflight_passes_and_fails(synthetic_acdc, tmp_path):
    preflight_or_raise(_cfg(synthetic_acdc))
    with pytest.raises(DataPreflightError, match="train_slices.list"):
        preflight_or_raise(_cfg(str(tmp_path)))


def test_calculate_metric_percase_matches_jax():
    rng = np.random.default_rng(2)
    gt = np.zeros((4, 24, 20), bool)
    gt[1:3, 5:15, 4:12] = True
    pred = gt.copy()
    pred[1, 5:8] = False
    pred[2, 16:20, 3:6] = True
    noisy = rng.random(gt.shape) > 0.7
    empty = np.zeros_like(gt)
    for p, g in ((pred, gt), (noisy, gt), (pred, empty), (empty, gt),
                 (empty, empty), (gt, gt)):
        assert calculate_metric_percase(p, g) == jax_metric(p, g)
