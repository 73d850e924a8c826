"""The trainer's prefetcher, overlapped eval, multi-model volume eval,
TensorBoard writer, rotating log and profiling utilities, and the repaired
registry and ``--validate-data``, on the CPU.

The prefetched and overlapped runs are held bit for bit against the plain
ones (losses, eval history, checkpoints); ``evaluate_volumes`` (the one-model
call of ``evaluate_volumes_multi``) against the JAX package's, and three
models in one ``evaluate_volumes_multi`` call against each model alone; the
metrics, step timer, MFU, registry and ``--validate-data`` against the JAX
package's.
"""

import importlib.util
import logging
import logging.handlers
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from hpfg_tpu import registry as jax_registry
from hpfg_tpu.evals.metrics import binary_hd95 as jax_hd95
from hpfg_tpu.evals.metrics import gt_surface_cache as jax_gt_cache
from hpfg_tpu.utils import profiling as jprof
from hpfg_tpu_torch.config import parse_config
from hpfg_tpu_torch.data.builder import build_loader
from hpfg_tpu_torch.data.prefetch import DevicePrefetcher
from hpfg_tpu_torch.evals import metrics as tmetrics
from hpfg_tpu_torch.evals.volume import (
    evaluate_volumes,
    evaluate_volumes_multi,
)
from hpfg_tpu_torch.models import build_model
from hpfg_tpu_torch.models.layers import ConvBlock, UpBlock
from hpfg_tpu_torch.ops import _cuda
from hpfg_tpu_torch.run import run
from hpfg_tpu_torch.train import algorithms as talgos
from hpfg_tpu_torch.train import trainer as ttrainer
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.train.trainer import Trainer
from hpfg_tpu_torch.utils import profiling as tprof
from hpfg_tpu_torch.utils import tb as ttb
from hpfg_tpu_torch.utils.checkpoint import state_mismatches
from hpfg_tpu_torch.utils.logging import get_logger
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HPFG = os.path.join(REPO, "configs", "hpfg_unet_plus_30k_224x224_ACDC.yaml")
TINY = ["--set", "device=cpu", "--set", "precision=fp32",
        "--set", "label_num=0.25", "--set", "batch_size=2",
        "--set", "unlabel_batch_size=4", "--set", "train_crop_size=[32,32]",
        "--set", "test_crop_size=[32,32]", "--set", "total_itrs=4",
        "--set", "step_size=2", "--set", "model1.feature_chns=[8,8,8,8,8]",
        "--set", "model2.feature_chns=[8,8,8,8,8]"]


# -- prefetcher --------------------------------------------------------------

def _batches(n):
    rng = np.random.default_rng(0)
    return [{"img": rng.normal(size=(2, 4, 4, 1)).astype(np.float32),
             "label": rng.integers(0, 4, (2, 4, 4)).astype(np.int32)}
            for _ in range(n)]


def test_prefetcher_yields_the_batches_in_order():
    src = _batches(7)
    got = list(DevicePrefetcher(iter(src), "cpu", depth=2))
    assert len(got) == 7
    for g, s in zip(got, src):
        assert set(g) == set(s)
        for k in s:
            assert torch.is_tensor(g[k]) and g[k].device.type == "cpu"
            assert g[k].dtype == torch.from_numpy(s[k]).dtype
            np.testing.assert_array_equal(g[k].numpy(), s[k])


def test_prefetcher_reraises_a_worker_error():
    def source():
        yield from _batches(2)
        raise ValueError("loader broke")

    pf = DevicePrefetcher(source(), "cpu")
    next(pf), next(pf)
    with pytest.raises(RuntimeError, match="prefetch worker failed") as info:
        next(pf)
    assert isinstance(info.value.__cause__, ValueError)


def test_prefetcher_close_stops_the_worker():
    def forever():
        while True:
            yield from _batches(1)

    pf = DevicePrefetcher(forever(), "cpu", depth=2)
    next(pf)
    time.sleep(0.3)  # the queue is full: the worker waits to put
    t0 = time.perf_counter()
    pf.close(timeout=5.0)
    assert not pf._thread.is_alive()
    assert time.perf_counter() - t0 < 5.0


def test_prefetcher_takes_no_more_than_its_limit():
    pulled = []

    def source():
        for i, b in enumerate(_batches(9)):
            pulled.append(i)
            yield b

    pf = DevicePrefetcher(source(), "cpu", depth=2, limit=4)
    assert len(list(pf)) == 4
    pf.close()
    assert pulled == [0, 1, 2, 3]


# -- the trainer -------------------------------------------------------------

def _hpfg(root, save, **sets):
    argv = ["--config", HPFG, "--set", f"data_path={root}",
            "--set", f"save_path={save}", *TINY]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    cfg = parse_config("t", "", argv)
    algo = build_algorithm(cfg["algorithm"], cfg, dtype=torch.float32,
                           device="cpu")
    return Trainer(cfg, algo, loaders=build_loader(cfg), workdir=save)


def _losses(trainer):
    return [(i, m["loss"]) for i, m in trainer.metrics_log]


@pytest.fixture(scope="module")
def hpfg_runs(synthetic_acdc, tmp_path_factory):
    """HPFG for 4 iterations (evals at 2 and 4) with the defaults (prefetch
    2, async eval) and with prefetch 0 and async eval off."""
    out = {}
    for name, sets in (("overlapped", {}),
                       ("inline", {"prefetch": 0, "async_eval": "false"})):
        save = str(tmp_path_factory.mktemp(name))
        t = _hpfg(synthetic_acdc, save, **sets)
        t.fit()
        out[name] = t
    return out


def test_prefetched_overlapped_run_equals_the_inline_one(hpfg_runs):
    a, b = hpfg_runs["overlapped"], hpfg_runs["inline"]
    assert (a.prefetch, a.async_eval, b.prefetch, b.async_eval) == (
        2, True, 0, False)
    assert _losses(a) == _losses(b) and len(_losses(a)) == 4
    assert a.history == b.history
    assert [h["iter"] for h in a.history] == [2, 4]
    assert sorted(a.history[-1]["results"]) == ["ema", "model1", "model2"]
    assert a.best_dice == b.best_dice
    tags = sorted(f[:-3] for f in os.listdir(a.ckpt.directory))
    assert tags == sorted(f[:-3] for f in os.listdir(b.ckpt.directory))
    assert {"last", "last_a", "last_b", "best_model1"} <= set(tags)
    for tag in tags:
        assert state_mismatches(a.ckpt.restore(tag), b.ckpt.restore(tag)) \
            == [], tag


def test_prefetch_keeps_the_losses_bitwise(synthetic_acdc, tmp_path):
    runs = []
    for depth in (0, 2):
        t = _hpfg(synthetic_acdc, str(tmp_path / f"p{depth}"),
                  prefetch=depth)
        t.total_itrs = 3
        t.fit(eval_enabled=False)
        runs.append(_losses(t))
    assert runs[0] == runs[1] and len(runs[0]) == 3


def test_consecutive_fits_see_the_batches_of_an_unprefetched_run(
        synthetic_acdc, tmp_path):
    """A fit that ends inside an epoch leaves the loaders where it would
    without prefetching, so the next fit (an in-process resume) starts from
    the same epoch and batches."""
    runs = []
    for depth in (0, 2):
        t = _hpfg(synthetic_acdc, str(tmp_path / f"p{depth}"),
                  prefetch=depth)
        for total in (3, 6):
            t.total_itrs = total
            t.fit(eval_enabled=False)
        runs.append((_losses(t), [ld._epoch for ld in t.loaders[:2]]))
    assert runs[0] == runs[1] and len(runs[0][0]) == 6


@pytest.mark.parametrize("async_eval", ["true", "false"])
def test_an_eval_error_surfaces_from_fit(synthetic_acdc, tmp_path,
                                         monkeypatch, async_eval):
    def broken(*_a, **_k):
        raise FloatingPointError("eval broke")

    monkeypatch.setattr(ttrainer, "evaluate_volumes_multi", broken)
    t = _hpfg(synthetic_acdc, str(tmp_path), async_eval=async_eval)
    with pytest.raises(FloatingPointError, match="eval broke"):
        t.fit()
    assert t._eval_pool is None and t._eval_future is None


def test_a_failing_last_overlapped_eval_still_shuts_the_pool(
        synthetic_acdc, tmp_path, monkeypatch):
    """The first boundary's eval passes; the last one, overlapped and
    joined only in ``fit``'s shutdown, raises on an otherwise clean run: the
    error propagates, and the pool is shut with no worker thread left."""
    real = ttrainer.evaluate_volumes_multi
    pools = []

    def last_breaks(*a, **k):
        pools.append(threading.current_thread().name)
        if len(pools) == 2:
            raise FloatingPointError("last eval broke")
        return real(*a, **k)

    monkeypatch.setattr(ttrainer, "evaluate_volumes_multi", last_breaks)
    t = _hpfg(synthetic_acdc, str(tmp_path))
    t.total_itrs = 4
    with pytest.raises(FloatingPointError, match="last eval broke"):
        t.fit()
    assert len(pools) == 2 and all(p.startswith("hpfg-eval") for p in pools)
    assert t._eval_pool is None and t._eval_future is None
    assert not any(th.name.startswith("hpfg-eval") and th.is_alive()
                   for th in threading.enumerate())
    assert [h["iter"] for h in t.history] == [2]


def test_a_failing_eval_does_not_mask_the_training_error(
        synthetic_acdc, tmp_path, monkeypatch):
    def broken(*_a, **_k):
        raise FloatingPointError("eval broke")

    monkeypatch.setattr(ttrainer, "evaluate_volumes_multi", broken)
    t = _hpfg(synthetic_acdc, str(tmp_path))
    step = t.algorithm.step

    def step3(batch):
        if t.algorithm.step_count == 2:
            raise KeyError("training broke")
        return step(batch)

    t.algorithm.step = step3
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    t.logger.addHandler(handler)
    try:
        with pytest.raises(KeyError, match="training broke"):
            t.fit()
    finally:
        t.logger.removeHandler(handler)
    assert any("overlapped eval also failed" in r.getMessage()
               and r.exc_info[0] is FloatingPointError for r in records)


def test_tensorboard_gets_the_scalars_and_panels(synthetic_acdc, tmp_path):
    t = _hpfg(synthetic_acdc, str(tmp_path))
    assert t.writer.enabled and t.writer.backend == "tensorboardX"
    calls = []

    class Recorder:
        def add_scalar(self, tag, value, step):
            calls.append(("scalar", tag, step))

        def add_image(self, tag, img, step, dataformats):
            assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[-1] \
                in (1, 3) and dataformats == "HWC"
            calls.append(("image", tag, step))

        def flush(self):
            pass

        def close(self):
            calls.append(("close", None, None))

    real = t.writer._writer
    t.writer._writer = Recorder()
    try:
        t.fit()
    finally:
        t.writer._writer = real
        real.close()
    scalars = {(tag, s) for kind, tag, s in calls if kind == "scalar"}
    images = {(tag, s) for kind, tag, s in calls if kind == "image"}
    assert {("hpfg/loss", i) for i in (1, 2, 3, 4)} <= scalars
    for name in ("model1", "model2", "ema"):
        for s in (2, 4):
            assert (f"hpfg/{name}_dice", s) in scalars
            assert (f"hpfg/{name}_hd95", s) in scalars
            for panel in ("Image", "label_pred", "label_true"):
                assert (f"{name}/{panel}", s) in images
    assert calls[-1][0] == "close"  # fit closes its writer
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(tmp_path / "tensorboardX"))


def test_swin_mae_panels_go_to_tensorboard_at_each_boundary(synthetic_acdc,
                                                           tmp_path):
    cfg = parse_config("t", "", [
        "--config", os.path.join(REPO, "configs",
                                 "swinmae_30k_224x224_ACDC.yaml"),
        "--set", f"data_path={synthetic_acdc}", "--set", "device=cpu",
        "--set", "precision=fp32", "--set", "batch_size=2",
        "--set", "train_crop_size=[32,32]", "--set", "test_crop_size=[32,32]",
        "--set", "total_itrs=4", "--set", "step_size=2",
        "--set", "embed_dim=8", "--set", "decoder_embed_dim=16",
        "--set", "depths=[2,2]", "--set", "num_heads=[1,2]",
        "--set", "window_size=2"])
    algo = build_algorithm(cfg["algorithm"], cfg, dtype=torch.float32,
                           device="cpu")
    t = Trainer(cfg, algo, loaders=build_loader(cfg), workdir=str(tmp_path))
    images = []

    class Recorder:
        def add_scalar(self, tag, value, step):
            pass

        def add_image(self, tag, img, step, dataformats):
            images.append((tag, step, img.shape))

        def flush(self):
            pass

        def close(self):
            pass

    real, t.writer._writer = t.writer._writer, Recorder()
    try:
        t.fit()
    finally:
        real.close()
    assert sorted((tag, step) for tag, step, _ in images) == sorted(
        (f"swin_mae/{k}", s) for k in ("image", "masked", "reconstruction")
        for s in (2, 4))
    assert all(shape == (32, 32, 3) for _, _, shape in images)
    assert [h["results"] for h in t.history] == [{}, {}]


def test_tensorboard_is_a_noop_without_either_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    records = []
    logger = logging.getLogger("hpfg_tpu_torch.test_tb")
    handler = logging.Handler()
    handler.emit = records.append
    logger.addHandler(handler)
    try:
        w = ttb.TBWriter(str(tmp_path / "tb"), logger)
    finally:
        logger.removeHandler(handler)
    assert not w.enabled and w.backend is None
    w.add_scalar("a", 1.0, 1)
    w.add_image("b", np.zeros((2, 2, 3), np.uint8), 1)
    w.flush()
    assert [r.getMessage() for r in records] == [
        "TensorBoard: neither tensorboardX nor torch.utils.tensorboard "
        "imports; the writer is a no-op"]
    assert not os.path.exists(tmp_path / "tb")


def test_log_file_rotates_daily(tmp_path):
    path = str(tmp_path / "logs" / "log.log")
    logger = get_logger(path)
    handlers = [h for h in logger.handlers
                if getattr(h, "baseFilename", None) == path]
    assert len(handlers) == 1
    (h,) = handlers
    assert isinstance(h, logging.handlers.TimedRotatingFileHandler)
    assert h.when == "D" and h.interval == 86400
    try:
        logger.info("before")
        h.doRollover()
        logger.info("after")
        h.flush()
        assert sorted(os.listdir(tmp_path / "logs"))[0] == "log.log"
        assert len(os.listdir(tmp_path / "logs")) == 2
    finally:
        logger.removeHandler(h)
        h.close()
    assert get_logger(path) is logger


# -- multi-model volume eval -------------------------------------------------

class _NearestIntensity(torch.nn.Module):
    """A stand-in model whose logits are minus the squared distance of each
    pixel to a class intensity of the synthetic phantom, so that every
    class is predicted and the eval arithmetic alone is compared."""

    CENTERS = np.array([0.2, 0.35, 0.5, 0.65], np.float32)

    def __init__(self):
        super().__init__()
        self.register_buffer("c", torch.from_numpy(self.CENTERS))

    def val(self, x):
        d = x - self.c
        return -(d * d)


@pytest.mark.parametrize("zoom_order", [0, 3])
def test_evaluate_volumes_equals_jax(synthetic_acdc, zoom_order):
    import jax.numpy as jnp
    from hpfg_tpu.evals.volume import SliceForward
    from hpfg_tpu.evals.volume import evaluate_volumes as jax_evaluate_volumes

    from hpfg_tpu_torch.data.acdc import ACDCDataset
    from hpfg_tpu_torch.data.loader import VolumeLoader

    def nearest(v, x):
        d = x - v["c"]
        return -(d * d)

    vols = list(VolumeLoader(ACDCDataset(synthetic_acdc, "test",
                                         cache=False)))
    dice, hd95, per_class = evaluate_volumes(
        _NearestIntensity(), vols, 4, (32, 32), "cpu", zoom_order=zoom_order)
    jdice, jhd95, jper, _ = jax_evaluate_volumes(
        SliceForward(nearest, wire_dtype=np.float32),
        {"c": jnp.asarray(_NearestIntensity.CENTERS)}, vols, 4, (32, 32),
        zoom_order=zoom_order)
    assert (dice, hd95) == (jdice, jhd95)
    np.testing.assert_array_equal(per_class, jper)
    assert (per_class[:, 0] > 0).all() and (per_class[:, 1] > 0).all()


@pytest.mark.parametrize("zoom_order", [0, 3])
def test_evaluate_volumes_multi_equals_the_per_model_path(synthetic_acdc,
                                                          zoom_order):
    from hpfg_tpu_torch.data.acdc import ACDCDataset
    from hpfg_tpu_torch.data.loader import VolumeLoader

    gen = torch.Generator().manual_seed(3)
    cfg = {"model": "unet_plus", "feature_chns": [8] * 5, "num_classes": 4,
           "in_channels": 1}
    models = {n: build_model(cfg, generator=gen) for n in ("a", "b", "c")}
    vols = VolumeLoader(ACDCDataset(synthetic_acdc, "test", cache=False))
    multi = evaluate_volumes_multi(models, vols, 4, (32, 32), "cpu",
                                   zoom_order=zoom_order, want_first=True)
    assert list(multi) == ["a", "b", "c"]
    for n, model in models.items():
        dice, hd95, per_class = evaluate_volumes(
            model, vols, 4, (32, 32), "cpu", zoom_order=zoom_order)
        mdice, mhd95, mper, first = multi[n]
        assert (mdice, mhd95) == (dice, hd95)
        assert mper.dtype == per_class.dtype and mper.shape == (3, 2)
        np.testing.assert_array_equal(mper, per_class)
        image, label = next(iter(vols))
        np.testing.assert_array_equal(first[0], image)
        np.testing.assert_array_equal(first[1], label)
        assert first[2].shape == label.shape
    assert multi["a"][0] != multi["b"][0]  # the models differ


def test_hd95_with_the_gt_cache_equals_jax():
    rng = np.random.default_rng(5)
    for _ in range(6):
        gt = rng.random((4, 24, 20)) > 0.7
        pred = rng.random((4, 24, 20)) > 0.6
        want = jax_hd95(pred, gt)
        assert tmetrics.binary_hd95(pred, gt) == want
        cache = tmetrics.gt_surface_cache(gt)
        assert tmetrics.binary_hd95(pred, gt, gt_cache=cache) == want
        assert jax_hd95(pred, gt, gt_cache=jax_gt_cache(gt)) == want
        for k in ("border", "dt"):
            np.testing.assert_array_equal(cache[k], jax_gt_cache(gt)[k])
    with pytest.raises(ValueError):
        tmetrics.binary_hd95(np.zeros((3, 3)), gt[0, :3, :3],
                             gt_cache=tmetrics.gt_surface_cache(
                                 gt[0, :3, :3]))


# -- profiling ---------------------------------------------------------------

def test_step_timer_and_mfu_agree_with_jax(monkeypatch):
    timers = []
    for mod in (tprof, jprof):
        ticks = iter([1.0, 1.02, 1.05, 1.11, 1.12])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        timer = mod.StepTimer(window=3)
        assert timer.ms_per_step != timer.ms_per_step  # nan before a tick
        for _ in range(5):
            timer.tick()
        timers.append((timer.ms_per_step, timer.images_per_sec(8)))
    assert timers[0] == timers[1]
    assert tprof.chip_peak_flops("cpu") is None
    monkeypatch.setattr(tprof, "chip_peak_flops", lambda device=None: 989e12)
    monkeypatch.setattr(jprof, "chip_peak_flops", lambda device=None: 989e12)
    for args in ((3.2e12, 0.05), (1e15, 2.0), (float("nan"), 1.0),
                 (1e12, 0.0)):
        assert tprof.mfu(*args) == jprof.mfu(*args)


def test_chip_peak_flops_knows_the_h100(monkeypatch):
    assert tprof.chip_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert tprof.chip_peak_flops() == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Other Card")
    assert tprof.chip_peak_flops() is None
    assert tprof.mfu(1e12, 1.0) is None


def test_trace_annotate_and_memory_stats(tmp_path):
    with tprof.trace(str(tmp_path / "trace")) as prof:
        with tprof.annotate("hpfg_span"):
            torch.ones(8, 8).matmul(torch.ones(8, 8))
    assert any(e.name == "hpfg_span" for e in prof.events())
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "hpfg_span" in f.read()
    assert tprof.device_memory_stats() == {"cpu": {}}


def test_visual_helpers_match_jax():
    from hpfg_tpu.utils import visual as jvis
    from hpfg_tpu_torch.data.acdc import label_to_img
    from hpfg_tpu_torch.utils import visual as tvis

    rng = np.random.default_rng(2)
    imgs = rng.normal(size=(5, 6, 7)).astype(np.float32)
    for kw in ({}, {"nrow": 2, "scale_each": False}, {"normalize": False}):
        got, want = tvis.make_grid(imgs, **kw), jvis.make_grid(imgs, **kw)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    feats = [rng.normal(size=(2, 8, 8, c)).astype(np.float32)
             for c in (3, 4, 5)]
    logits = rng.normal(size=(4, 6, 7, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (4, 6, 7))

    def panels(vis):
        calls = {}

        class Writer:
            def add_image(self, tag, img, step):
                assert step == 3
                calls[tag] = np.asarray(img)

        vis.log_feature_grids(Writer(), "f", feats, 3)
        vis.log_train_panels(Writer(), imgs[:4, ..., None], logits, labels, 3,
                             label_to_img)
        return calls

    got, want = panels(tvis), panels(jvis)
    assert sorted(got) == sorted(want) == [
        "f/high_level_features", "f/low_level_features", "train/img",
        "train/label_pred", "train/label_true"]
    for tag in want:
        np.testing.assert_array_equal(got[tag], want[tag])


def _analytic_unet_flops(model, x) -> float:
    """2 x the multiply-adds of every conv of a UNet forward and backward
    from the model's structure: each ConvBlock's two 3x3 convs, each
    UpBlock's 1x1 conv (run as a 3x3 with zero taps) and the 3x3 head;
    the backward's input and weight gradients each cost a forward, except
    the stem's input gradient, which nothing needs."""
    fwd, stem = [], []

    def block(mod, args):
        src = args[0]
        b, h, w = (src[0] if isinstance(src, tuple) else src).shape[:3]
        cin = (sum(t.shape[-1] for t in src) if isinstance(src, tuple)
               else src.shape[-1])
        f = mod.conv2.kernel.shape[-1]
        fwd.append(18 * b * h * w * (cin * f + f * f))
        if cin == x.shape[-1] and h == x.shape[1]:
            stem.append(18 * b * h * w * cin * f)

    def up(mod, args):
        b, h, w, c = args[0].shape
        fwd.append(18 * b * h * w * c * mod.conv1x1.kernel.shape[-1])

    hooks = [m.register_forward_pre_hook(block) for m in model.modules()
             if isinstance(m, ConvBlock)]
    hooks += [m.register_forward_pre_hook(up) for m in model.modules()
              if isinstance(m, UpBlock)]
    try:
        with torch.no_grad():
            out = model(x, train=True)
    finally:
        for h in hooks:
            h.remove()
    logits = out[0] if isinstance(out, tuple) else out
    b, h, w, k = logits.shape
    head = 18 * b * h * w * model.decoder.out_conv.kernel.shape[2] * k
    total = sum(fwd) + head
    return 3 * total - sum(stem)


def test_count_flops_of_a_unet_step_matches_the_analytic_count():
    gen = torch.Generator().manual_seed(0)
    model = build_model({"model": "unet", "feature_chns": [8] * 5,
                         "num_classes": 4, "in_channels": 1}, generator=gen)
    x = torch.randn(2, 32, 32, 1, generator=gen)

    def step():
        model.zero_grad()
        logits = model(x, train=True)
        logits = logits[0] if isinstance(logits, tuple) else logits
        logits.float().square().mean().backward()

    counted = tprof.count_flops(step)
    want = _analytic_unet_flops(model, x)
    assert abs(counted - want) <= 0.01 * want, (counted, want)


def test_kernel_launches_report_their_flops():
    """A kernel wrapper's launch (``_cuda.counted``, reached only on the
    card) adds its operations to ``count_flops``, and counts its launch
    under a lock from many threads."""
    def fake_kernel(t):
        _cuda.counted(fake_kernel, t, 1000)
        return t

    fake_kernel.launches = 0
    assert tprof.count_flops(fake_kernel, torch.ones(2)) == 1000.0
    fake_kernel.launches = 0
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_cuda.counted(fake_kernel, None)
                            for _ in range(2000)]) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    assert fake_kernel.launches == 16 * 2000


# -- repairs -----------------------------------------------------------------

def test_algorithm_registry_raises_keyerror_in_both_packages():
    from hpfg_tpu.train.algorithms import build_algorithm as jax_build

    for build in (build_algorithm, jax_build):
        with pytest.raises(KeyError, match="unknown algorithm 'nope'"):
            build("nope", {})
    with pytest.raises(KeyError, match="registered twice"):
        talgos.register("mean_teacher")(object)
    reg = jax_registry.Registry("algorithm")
    reg.register("x")(object)
    with pytest.raises(KeyError, match="registered twice"):
        reg.register("x")(object)
    assert "mean_teacher" in talgos.ALGORITHMS


def _jax_run():
    spec = importlib.util.spec_from_file_location(
        "jax_scripts_run", os.path.join(REPO, "scripts", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run


@pytest.mark.parametrize("broken", [False, True])
def test_validate_data_matches_scripts_run(synthetic_acdc, tmp_path, capsys,
                                           broken):
    root = synthetic_acdc
    if broken:
        root = str(tmp_path / "acdc")
        shutil.copytree(synthetic_acdc, root)
        with open(os.path.join(root, "test.list")) as f:
            first = f.readline().strip()
        os.remove(os.path.join(root, "data", f"{first}.h5"))
    argv = ["--config", HPFG, "--set", f"data_path={root}",
            "--validate-data"]
    outs = []
    for fn in (lambda: run(list(argv)),
               lambda: _jax_run()(HPFG, argv=list(argv))):
        with pytest.raises(SystemExit) as info:
            fn()
        outs.append((info.value.code, capsys.readouterr().out))
    assert outs[0] == outs[1]
    code, out = outs[0]
    assert code == (1 if broken else 0)
    lines = out.strip().splitlines()
    assert all(line.startswith("[validate-data] ") for line in lines)
    assert lines[-1].startswith("[validate-data] FAIL" if broken
                                else "[validate-data] OK")
    assert len(lines) == (2 if broken else 1)
