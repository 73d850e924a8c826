"""The port's library modules (``ops/contrastive.py``, ``ops/misc.py``,
``ops/freeze.py``) and its ten entry scripts against the JAX package on
the CPU.

Tolerances (fp32 on both sides): the losses agree to 1e-5 relative (the
same sums in other orders; the similarity maps go through exp and log);
the kNN scores to 1e-5 relative; label_onehot, Denormalize and the saliency
boxes (from the JAX package's own uniforms) exactly. The distributed
NT-Xent over 2 gloo ranks equals the one-process loss to 1e-6 relative and
its gradients (the ranks' average, as the step's gradient all-reduce takes
it) to 1e-6 of their largest magnitude. The freezing wrappers follow optax
over 4 SGD-momentum and 4 AdamW steps to the 1e-5 of
``tests/test_torch_mean_teacher.py`` (optax takes Adam's bias correction in
fp32).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hpfg_tpu.config import Config
from hpfg_tpu.ops import contrastive as jc
from hpfg_tpu.ops import freeze as jfreeze
from hpfg_tpu.ops import misc as jm
from hpfg_tpu.train import optim as joptim
from hpfg_tpu_torch.ops import contrastive as tc
from hpfg_tpu_torch.ops import freeze as tfreeze
from hpfg_tpu_torch.ops import misc as tm
from hpfg_tpu_torch.train import optim as toptim
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401
from tests.test_torch_parallel import WORLD, join_all, spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
OPT_ATOL = 1e-5
DIST_RTOL = 1e-6
SCRIPTS = ("train_cps", "train_ctct", "train_hpfg", "train_ict",
           "train_mean_teacher", "train_s4cvnet", "train_ssnet",
           "train_supervised", "train_swin_mae", "train_uamt")


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


# ---------------------------------------------------------------------------
# ops/contrastive.py
# ---------------------------------------------------------------------------

def _pair(seed, *shape):
    rng = _rng(seed)
    return _normal(rng, *shape), _normal(rng, *shape)


@pytest.mark.parametrize("fn", ["simclr_loss", "contrastive_loss",
                                "nt_xent_distributed"])
def test_simclr_family_matches_jax(fn):
    a, b = _pair(1, 6, 16)
    _close(float(getattr(tc, fn)(_t(a), _t(b), 0.5)),
           float(getattr(jc, fn)(jnp.asarray(a), jnp.asarray(b), 0.5)))


def test_simsiam_and_info_nce_match_jax():
    rng = _rng(2)
    z1, z2, p1, p2 = (_normal(rng, 5, 12) for _ in range(4))
    _close(float(tc.simsiam_loss(*map(_t, (z1, z2, p1, p2)))),
           float(jc.simsiam_loss(*map(jnp.asarray, (z1, z2, p1, p2)))))
    f = _normal(rng, 10, 12)
    _close(float(tc.info_nce_loss(_t(f), 5, 0.7)),
           float(jc.info_nce_loss(jnp.asarray(f), 5, 0.7)))


def test_kd_losses_match_jax():
    s, t = _pair(3, 2, 16, 16, 6)
    _close(float(tc.structural_kd_loss(_t(s), _t(t))),
           float(jc.structural_kd_loss(jnp.asarray(s), jnp.asarray(t))))
    _close(float(tc.cross_image_pair_kd(_t(s), _t(t), 0.7, pooling=8)),
           float(jc.cross_image_pair_kd(jnp.asarray(s), jnp.asarray(t), 0.7,
                                        pooling=8)))
    _close(float(tc.cross_image_pair_kd(_t(s), _t(t), 0.7, pooling=None)),
           float(jc.cross_image_pair_kd(jnp.asarray(s), jnp.asarray(t), 0.7,
                                        pooling=None)))
    x, y = _pair(4, 3, 8, 8, 4)
    _close(float(tc.kld_loss(_t(x), _t(y))),
           float(jc.kld_loss(jnp.asarray(x), jnp.asarray(y))))
    _close(float(tc.compute_kl_loss(_t(x), _t(y))),
           float(jc.compute_kl_loss(jnp.asarray(x), jnp.asarray(y))))
    p = np.asarray(jax.nn.softmax(jnp.asarray(x), -1))
    _close(float(tc.entropy_minimization(_t(p))),
           float(jc.entropy_minimization(jnp.asarray(p))))


@pytest.mark.parametrize("length", [16, 512])
def test_pixel_class_contrastive_matches_jax(length):
    """length 16: every class has enough pixels; 512: none has (0)."""
    rng = _rng(5)
    b, h, w, c = 2, 8, 8, 6
    labels = rng.integers(0, 4, (b, h, w)).astype(np.int32)
    logits = _normal(rng, b, h, w, 4)
    for k in range(4):  # most pixels predicted right
        logits[..., k] += (labels == k) * 3.0
    feats, mem = _normal(rng, b, h, w, c), _normal(rng, b, h, w, c)
    args = (feats, mem, labels, logits, logits * 0.9)
    got = float(tc.pixel_class_contrastive_loss(*map(_t, args), 4, length))
    want = float(jc.pixel_class_contrastive_loss(*map(jnp.asarray, args), 4,
                                                 length))
    _close(got, want)
    assert (got > 0) == (length == 16)


# ---------------------------------------------------------------------------
# ops/misc.py
# ---------------------------------------------------------------------------

def test_label_onehot_and_denormalize_match_jax():
    labels = np.array([[[-1, 0], [3, 5]]], np.int32)
    np.testing.assert_array_equal(
        tm.label_onehot(_t(labels), 4).numpy(),
        np.asarray(jm.label_onehot(jnp.asarray(labels), 4)))
    x = _normal(_rng(6), 4, 4, 3)
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    np.testing.assert_array_equal(tm.Denormalize(mean, std)(x),
                                  jm.Denormalize(mean, std)(x))


def test_knn_predict_and_monitor_match_jax():
    rng = _rng(7)
    bank = _normal(rng, 16, 40)
    bank /= np.linalg.norm(bank, axis=0, keepdims=True)
    feat = _normal(rng, 5, 16)
    feat /= np.linalg.norm(feat, axis=1, keepdims=True)
    labels = rng.integers(0, 3, 40).astype(np.int32)
    _close(tm.knn_predict(_t(feat), _t(bank), _t(labels), 3, 7).numpy(),
           jm.knn_predict(jnp.asarray(feat), jnp.asarray(bank),
                          jnp.asarray(labels), 3, 7))
    proj = _normal(rng, 12, 16)
    mem = [(_normal(rng, 10, 12), rng.integers(0, 3, 10)) for _ in range(3)]
    test = [(_normal(rng, 6, 12), rng.integers(0, 3, 6)) for _ in range(2)]
    want = jm.knn_monitor(lambda x: x @ jnp.asarray(proj), mem, test, 3,
                          knn_k=5)
    got = tm.knn_monitor(lambda x: x @ _t(proj), mem, test, 3, knn_k=5,
                         device="cpu")
    assert got == want


def test_saliency_box_masks_match_jax_from_its_draws():
    """The JAX function's own uniforms (its key split) through the port's
    rasterisation: the same boxes."""
    images = _normal(_rng(8), 4, 24, 20, 3)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jm.saliency_box_masks(key, jnp.asarray(images)))
    k_area, k_aspect = jax.random.split(key)
    u = {"area": _t(np.asarray(jax.random.uniform(
            k_area, (4,), minval=0.25, maxval=0.5))),
         "log_aspect": _t(np.asarray(jax.random.uniform(
             k_aspect, (4,), minval=-0.5, maxval=0.5)))}
    got = tm.saliency_masks_from_uniforms(_t(images), u).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1
    drawn = tm.saliency_box_masks(torch.Generator().manual_seed(0),
                                  _t(images))
    assert drawn.shape == (4, 24, 20, 1)
    assert set(drawn.unique().tolist()) <= {0.0, 1.0}


# ---------------------------------------------------------------------------
# nt_xent_distributed over 2 ranks
# ---------------------------------------------------------------------------

def test_nt_xent_distributed_over_two_ranks(tmp_path):
    a, b = _pair(9, 8, 16)
    torch.save([_t(a), _t(b)], tmp_path / "views.pt")
    procs = spawn("nt_xent", str(tmp_path), "0.5")
    z = [_t(v).clone().requires_grad_(True) for v in (a, b)]
    loss = tc.nt_xent_distributed(z[0], z[1], 0.5)
    loss.backward()
    loss = loss.detach()
    outs, codes = join_all(procs, 60)
    assert codes == [0] * WORLD, "\n".join(outs)
    ranks = [torch.load(tmp_path / f"nt_xent{r}.pt", weights_only=True)
             for r in range(WORLD)]
    for r in ranks:
        _close(float(r["loss"]), float(loss), DIST_RTOL)
    for v in range(2):
        # each rank holds W times its rows' share; the step averages
        grad = torch.cat([r["grads"][v] for r in ranks]) / WORLD
        scale = float(z[v].grad.abs().max())
        assert float((grad - z[v].grad).abs().max()) <= DIST_RTOL * scale


# ---------------------------------------------------------------------------
# ops/freeze.py against the optax wrappers
# ---------------------------------------------------------------------------

class _Net(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for top, sub in params.items():
            mod = torch.nn.Module()
            for k, v in sub.items():
                setattr(mod, k, torch.nn.Parameter(_t(v.copy())))
            setattr(self, top, mod)


@pytest.mark.parametrize("wrapper", ["freeze_subtrees", "unfreeze_after"])
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_freezing_matches_optax(wrapper, opt):
    cfg = dict(opt=opt, lr=0.1, weight_decay=1e-2, momentum=0.9,
               sched="medical", total_itrs=30)
    rng = _rng(10)
    p0 = {"encoder": {"w": _normal(rng, 3, 4), "b": _normal(rng, 4)},
          "decoder": {"w": _normal(rng, 4, 2)}}
    grads = [jax.tree_util.tree_map(lambda v: _normal(rng, *v.shape), p0)
             for _ in range(4)]
    tx, _ = joptim.build_optimizer(Config(cfg))
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    if wrapper == "freeze_subtrees":
        tx = jfreeze.freeze_subtrees(tx, pj, ["encoder"])
    else:
        tx = jfreeze.unfreeze_after(tx, pj, ["encoder"], 2)
    state = tx.init(pj)

    net = _Net(p0)

    def make(params):
        return toptim.build_optimizer(cfg, params)[0]

    schedule = toptim.build_lr_schedule(cfg)
    if wrapper == "freeze_subtrees":
        optimizer = tfreeze.freeze_subtrees(make, net, ["encoder"])
    else:
        optimizer = tfreeze.unfreeze_after(make, net, ["encoder"], 2)
    named = dict(net.named_parameters())
    for i, g in enumerate(grads):
        updates, state = tx.update(g, state, pj)
        pj = optax.apply_updates(pj, updates)
        before = named["encoder.w"].detach().clone()
        for k, p in named.items():
            top, leaf = k.split(".")
            p.grad = _t(g[top][leaf])
        toptim.set_lr(optimizer, schedule(i))
        optimizer.step()
        for k, p in named.items():
            top, leaf = k.split(".")
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(pj[top][leaf]), rtol=0,
                                       atol=OPT_ATOL, err_msg=f"{k} step {i}")
        moved = not torch.equal(named["encoder.w"], before)
        assert moved == (wrapper == "unfreeze_after" and i >= 2), i
    if wrapper == "unfreeze_after":
        state_dict = optimizer.state_dict()
        assert state_dict["count"] == 4
        optimizer.load_state_dict(state_dict)


# ---------------------------------------------------------------------------
# the entry scripts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SCRIPTS)
def test_entry_script_names_its_jax_twins_config(name):
    import importlib

    from hpfg_tpu_torch.config import load_config
    from hpfg_tpu_torch.train.algorithms import build_algorithm

    module = importlib.import_module(f"hpfg_tpu_torch.scripts.{name}")
    with open(os.path.join(REPO, "scripts", f"{name}.py"),
              encoding="utf-8") as f:
        twin = re.search(r'run\("([^"]+)"\)', f.read()).group(1)
    assert module.CONFIG == twin
    cfg = load_config(os.path.join(REPO, module.CONFIG))
    algo = build_algorithm(cfg.get("algorithm"), cfg, device="cpu")
    assert algo.name in name or name == "train_ict"
    assert algo.state_dict()["models"]


def test_run_takes_the_algorithm_override(synthetic_acdc, tmp_path):
    """``run(..., algorithm=...)`` trains the named algorithm on a config
    written for another (the Mean-Teacher config, flat, drives CPS)."""
    from hpfg_tpu_torch.run import run

    trainer = run([
        "--config", os.path.join(REPO, "configs",
                                 "mean_teacher_unet_30k_224x224_ACDC.yaml"),
        "--set", f"data_path={synthetic_acdc}",
        "--set", f"save_path={tmp_path / 'run'}", "--set", "device=cpu",
        "--set", "precision=fp32", "--set", "label_num=0.25",
        "--set", "batch_size=2", "--set", "unlabel_batch_size=2",
        "--set", "train_crop_size=[32,32]", "--set", "test_crop_size=[32,32]",
        "--set", "feature_chns=[4,4,4,4,4]", "--set", "total_itrs=2",
        "--set", "step_size=2", "--set", "prefetch=0",
        "--set", "async_eval=false"], algorithm="cps")
    assert trainer.algorithm.name == "cps"
    assert trainer.algorithm.step_count == 2
    assert (tmp_path / "run" / "model" / "last.pt").exists()
