"""Checkpoints and exact resume of the port, on the CPU.

Three straight steps equal two steps, a save, a restore into a fresh
algorithm (built from another seed) and one step, bitwise: every
parameter, BN statistic, optimizer state and generator state, and the
third step's metrics. For CPS (two tiny UNets with their hash dropout on:
the dropout generator) and HPFG (tiny UNet_Plus students, an EMA teacher,
SGD and adamW, the CutMix generator). Then the checkpoint files: the
``last_a`` / ``last_b`` rotation, ``latest_resume_tag`` passing over a
stray temporary file, a failed save leaving the old tag whole; the CLI's
``ckpt=<missing>`` raising ``FileNotFoundError``, and ``auto_resume``
through ``python -m hpfg_tpu_torch.run`` continuing a finished run.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpfg_tpu_torch.run import run
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.train.trainer import Trainer
from hpfg_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    state_mismatches,
)
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, LB, UB = 32, 2, 4


def _cfg(name, seed=0):
    unet = "unet_plus" if name == "hpfg" else "unet"
    common = dict(model=unet, feature_chns=[8] * 5, in_channels=1,
                  num_classes=4, sched="medical", total_itrs=30,
                  step_size=10)
    return dict(
        algorithm=name, num_classes=4, in_channels=1,
        train_crop_size=[HW, HW], batch_size=LB, unlabel_batch_size=UB,
        consistency=1.0, consistency_rampup=0.0, epoch_unit_iters=1,
        seed=seed, total_itrs=30, step_size=10,
        model1=dict(opt="sgd", lr=0.01, weight_decay=5e-4, momentum=0.9,
                    **common),
        model2=dict(opt="adamW" if name == "hpfg" else "sgd", lr=0.001,
                    weight_decay=0.05, momentum=0.9, **common))


def _batches(name, n):
    rng = np.random.default_rng(7)

    def img(b):
        return rng.normal(size=(b, HW, HW, 1)).astype(np.float32)

    def lab(b):
        return rng.integers(0, 4, (b, HW, HW)).astype(np.int32)

    out = []
    for _ in range(n):
        batch = {"label_img": img(LB), "label": lab(LB),
                 "unlabel_img": img(UB)}
        if name == "hpfg":
            batch.update(label_img1=img(LB), label1=lab(LB))
        out.append(batch)
    return out


def _build(name, seed=0):
    return build_algorithm(name, _cfg(name, seed), dtype=torch.float32,
                           device="cpu")


def _trainer(algo, workdir):
    return Trainer(algo.cfg, algo, loaders=([], [], []), workdir=workdir)


@pytest.mark.parametrize("name", ["cps", "hpfg"])
def test_resume_continues_bitwise(name, tmp_path):
    batches = _batches(name, 3)
    straight = _build(name)
    for batch in batches:
        m_straight = straight.step(batch)

    first = _build(name)
    for batch in batches[:2]:
        first.step(batch)
    trainer = _trainer(first, str(tmp_path))
    trainer.best_dice = {"model1": 0.25}
    trainer.save("last")
    saved = trainer.ckpt.restore("last")
    assert set(saved["algorithm"]["generators"]) >= {
        "init_generator", "dropout_generator"} | (
        {"cutmix_generator"} if name == "hpfg" else set())

    fresh = _build(name, seed=5)
    assert state_mismatches(fresh.state_dict(), saved["algorithm"])
    resumed = _trainer(fresh, str(tmp_path))
    assert resumed.resume("last", strict=True)
    assert state_mismatches(fresh.state_dict(), saved["algorithm"]) == []
    assert resumed.best_dice == {"model1": 0.25}
    assert fresh.step_count == 2
    m_resumed = fresh.step(batches[2])
    assert state_mismatches(fresh.state_dict(), straight.state_dict()) == []
    assert set(m_resumed) == set(m_straight)
    for k in m_straight:
        assert float(m_resumed[k]) == float(m_straight[k]), k


def test_rotation_and_atomic_saves(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.latest_resume_tag() is None
    assert [ckpt.save_rotating({"i": i}) for i in range(3)] == [
        "last_a", "last_b", "last_a"]
    assert ckpt.latest_resume_tag() == "last_a"
    assert ckpt.restore("last_a") == {"i": 2}
    ckpt.save("last", {"i": 3})
    assert ckpt.latest_resume_tag() == "last"
    # a fresh manager overwrites the older slot first
    again = CheckpointManager(str(tmp_path))
    assert again.save_rotating({"i": 4}) == "last_b"
    assert again.latest_resume_tag() == "last_b"
    # a temporary file left by a crashed save is no resume point
    (tmp_path / ".last.crashed.tmp").write_bytes(b"half a checkpoint")
    assert again.latest_resume_tag() == "last_b"
    # a save that fails keeps the old tag and leaves no temporary file
    with pytest.raises(Exception):
        again.save("last_b", {"i": lambda: 5})
    assert again.restore("last_b") == {"i": 4}
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        ".last.crashed.tmp", "last.pt", "last_a.pt", "last_b.pt"]


def test_state_mismatches_is_bitwise():
    a = {"w": torch.tensor([0.0, 1.0]), "n": 3, "l": [torch.tensor(2)]}
    assert state_mismatches(a, {"w": torch.tensor([0.0, 1.0]), "n": 3,
                                "l": [torch.tensor(2)]}) == []
    assert state_mismatches(a, {"w": torch.tensor([-0.0, 1.0]), "n": 3,
                                "l": [torch.tensor(2)]}) == ["/w"]
    assert state_mismatches(a, {"w": torch.tensor([0.0, 1.0],
                                                  dtype=torch.float64),
                                "n": 4, "l": [torch.tensor(2)]}) == [
        "/w", "/n"]
    assert state_mismatches(a, {"w": a["w"], "n": 3}) == ["<root>"]


def _cli_args(root, save, itrs):
    return ["--config", "configs/unet_30k_224x224_ACDC.yaml",
            "--set", f"data_path={root}", "--set", f"save_path={save}",
            "--set", "device=cpu", "--set", "precision=fp32",
            "--set", "batch_size=2", "--set", "feature_chns=[8,8,8,8,8]",
            "--set", "train_crop_size=[32,32]",
            "--set", "test_crop_size=[32,32]",
            "--set", f"total_itrs={itrs}", "--set", "step_size=2"]


def test_missing_ckpt_raises(synthetic_acdc, tmp_path):
    with pytest.raises(FileNotFoundError, match="best_model9"):
        run(_cli_args(synthetic_acdc, str(tmp_path), 2)
            + ["--set", "ckpt=best_model9"])


def test_cli_auto_resume_continues_a_run(synthetic_acdc, tmp_path):
    """Two iterations, then the same run asked for four with
    ``auto_resume``: it restores ``last`` and trains iterations 3 and 4."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    save = tmp_path / "run"
    for itrs, extra in ((2, []), (4, ["--set", "auto_resume=true"])):
        proc = subprocess.run(
            [sys.executable, "-m", "hpfg_tpu_torch.run",
             *_cli_args(synthetic_acdc, str(save), itrs), *extra],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
    with open(save / "log.log", encoding="utf-8") as f:
        log = f.read()
    assert log.count("resuming from checkpoint 'last'") == 1
    assert "done: 2 iters" in log and "done: 4 iters" in log
    assert log.count("iter 2 model1 dice") == 1
    assert log.count("iter 4 model1 dice") == 1
    ckpt = CheckpointManager(str(save / "model"))
    assert all(ckpt.exists(t) for t in ("last", "last_a", "last_b",
                                        "best_model1"))
    last = ckpt.restore("last")
    assert last["algorithm"]["step_count"] == 4
    assert set(last["best_dice"]) == {"model1"}
