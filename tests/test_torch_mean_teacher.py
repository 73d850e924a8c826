"""The port's Mean-Teacher slice against the JAX package on the CPU:
three training steps from mapped weights, the optimizers and schedules, the
losses, and the port's CLI entry point on the synthetic ACDC tree.

Tolerances (fp32 on both sides): the step metrics agree to 1e-5 relative
(the same losses over the same logits, summed in other orders); after three
SGD steps parameters, EMA parameters and BN statistics agree to 1e-4
absolute; the schedules agree to 1e-6 relative or 2e-9 absolute, one fp32
ulp of the base lr 0.02 (optax computes in fp32, the port in Python
doubles); two optimizer updates of size lr = 0.1 agree to
1e-5 absolute, because optax takes Adam's bias correction 1 - 0.999^t in
fp32, where the subtraction alone carries a 1.3e-5 relative error.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hpfg_tpu.config import Config
from hpfg_tpu.ops import losses as jlosses
from hpfg_tpu.train import optim as joptim
from hpfg_tpu.train.algorithms import build_algorithm as jax_build_algorithm
from hpfg_tpu_torch.ops import losses as tlosses
from hpfg_tpu_torch.train import optim as toptim
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.utils.jax_weights import flatten_tree, load_jax_weights

PARAM_ATOL = 1e-4
METRIC_RTOL = 1e-5
SCHED_RTOL = 1e-6
SCHED_ATOL = 2e-9
OPT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs
    several workers on a few cores, where torch's default of a thread per
    core oversubscribes them many times over. The port's other CPU test
    modules import it, which makes it autouse there too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mt_cfg(**kw):
    base = dict(model="unet", feature_chns=[16] * 5, dropout=[0.0] * 5,
                num_classes=4, in_channels=1, train_crop_size=[32, 32],
                batch_size=2, unlabel_batch_size=2, consistency=1.0,
                consistency_rampup=4.0, epoch_unit_iters=1, ema_decay=0.99,
                seed=0, total_itrs=30, step_size=10, opt="sgd", lr=0.05,
                weight_decay=1e-4, momentum=0.9, sched="medical")
    base.update(kw)
    return Config(base)


def test_three_mean_teacher_steps_match_jax():
    cfg = _mt_cfg()
    jalgo = jax_build_algorithm("mean_teacher", cfg, dtype=jnp.float32)
    state = jax.jit(jalgo.init_state)(jax.random.PRNGKey(0))
    talgo = build_algorithm("mean_teacher", cfg, dtype=torch.float32,
                            device="cpu")
    host = jax.device_get(state)
    load_jax_weights(talgo.model, host.model.params, host.model.batch_stats)
    load_jax_weights(talgo.ema, host.ema.params, host.ema.batch_stats)

    step = jax.jit(jalgo.step)
    rng = np.random.default_rng(5)
    for _ in range(3):
        batch = {
            "label_img": rng.normal(size=(2, 32, 32, 1)).astype(np.float32),
            "label": rng.integers(0, 4, (2, 32, 32)).astype(np.int32),
            "unlabel_img": rng.normal(size=(2, 32, 32, 1)).astype(
                np.float32),
        }
        state, m_j = step(state, batch)
        m_t = talgo.step(batch)
        assert set(m_t) == set(m_j)
        for k in m_j:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=METRIC_RTOL, atol=1e-8,
                                       err_msg=k)
    assert talgo.step_count == int(state.step) == 3

    host = jax.device_get(state)
    for module, mstate in ((talgo.model, host.model), (talgo.ema, host.ema)):
        ref = flatten_tree(mstate.params)
        ref.update(flatten_tree(mstate.batch_stats))
        got = {k: v.detach().numpy() for k, v in module.state_dict().items()}
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
def test_optimizer_update_matches_optax(opt):
    cfg = _mt_cfg(opt=opt, weight_decay=1e-2, lr=0.1)
    rng = np.random.default_rng(9)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(2)]

    tx, _ = joptim.build_optimizer(cfg)
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = tx.init(pj)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, pj)
        pj = optax.apply_updates(pj, updates)

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    optimizer, schedule = toptim.build_optimizer(cfg, params.values())
    for i, g in enumerate(grads):
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        toptim.set_lr(optimizer, schedule(i))
        optimizer.step()
    for k in p0:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(pj[k]), rtol=0,
                                   atol=OPT_ATOL, err_msg=k)


@pytest.mark.parametrize("sched,extra", [
    ("medical", {}), ("poly", {"min_lr": 1e-3}),
    ("cosine", {"warmup_epochs": 1, "warmup_lr": 1e-4, "min_lr": 1e-5}),
    ("constant", {})])
def test_schedules_match_at_every_step(sched, extra):
    cfg = _mt_cfg(sched=sched, total_itrs=20, step_size=5, lr=0.02, **extra)
    js = joptim.build_lr_schedule(cfg)
    ts = toptim.build_lr_schedule(cfg)
    for step in range(23):
        np.testing.assert_allclose(ts(step), float(js(step)),
                                   rtol=SCHED_RTOL, atol=SCHED_ATOL,
                                   err_msg=str(step))


def test_losses_and_gradients_match_jax():
    rng = np.random.default_rng(21)
    logits = rng.normal(size=(2, 8, 8, 4)).astype(np.float32) * 2
    target = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (2, 8, 8)).astype(np.int32)
    labels[0, :2] = 255  # ignored pixels

    def jax_terms(lg):
        return (jlosses.med_sup_loss(lg, labels, 4),
                jnp.mean(jlosses.softmax_mse_loss(lg, target)))

    for i in range(2):
        val_j, grad_j = jax.jit(jax.value_and_grad(
            lambda lg: jax_terms(lg)[i]))(jnp.asarray(logits))
        lt = torch.tensor(logits, requires_grad=True)
        terms = (tlosses.med_sup_loss(lt, torch.from_numpy(labels), 4),
                 tlosses.softmax_mse_loss(lt, torch.from_numpy(target))
                 .mean())
        terms[i].backward()
        np.testing.assert_allclose(terms[i].item(), float(val_j), rtol=1e-5)
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(grad_j),
                                   rtol=1e-4, atol=1e-7)


def test_run_entry_point_trains_and_evaluates(synthetic_acdc, tmp_path):
    from hpfg_tpu_torch.run import run

    save = tmp_path / "run"
    trainer = run([
        "--config", "configs/mean_teacher_unet_30k_224x224_ACDC.yaml",
        "--set", f"data_path={synthetic_acdc}", "--set", f"save_path={save}",
        "--set", "device=cpu", "--set", "precision=fp32",
        "--set", "label_num=0.25", "--set", "batch_size=2",
        "--set", "unlabel_batch_size=2", "--set", "train_crop_size=[32,32]",
        "--set", "test_crop_size=[32,32]", "--set", "feature_chns=[8,8,8,8,8]",
        "--set", "total_itrs=4", "--set", "step_size=2"])
    assert trainer.algorithm.step_count == 4
    assert [h["iter"] for h in trainer.history] == [2, 4]
    for h in trainer.history:
        for dice, hd95 in h["results"].values():
            assert 0.0 <= dice <= 1.0 and math.isfinite(hd95)
    assert all(math.isfinite(m["loss"]) for _, m in trainer.metrics_log)
    with open(os.path.join(save, "log.log"), encoding="utf-8") as f:
        assert "done: 4 iters" in f.read()
