"""Data parallelism of UAMT, ICT, SS-Net, S4CVNet and Swin-MAE on the CPU.

Two gloo ranks (this file run as a script, one process each, one torch
thread) against one process over the same global batches at 32^2 with
every dropout on, two steps each, as ``tests/test_torch_parallel.py`` holds
the five BASELINE algorithms: each step's loss to 1e-5 relative, and after
each step every parameter gradient (the ranks' average), parameter and BN
running statistic to 1e-5 of its model's largest magnitude, the ranks'
second step from the one-process state after the first. What each
algorithm adds: UAMT's Monte-Carlo passes (the noise of the global batch,
in ``map`` and in ``unroll``, whose chunk input is two global segments) and
its masked consistency sums; ICT's pairs, which cross the ranks (at W = 2
rank 0 holds u0 and rank 1 u1); SS-Net's memory bank (top-k over the
global labelled rows: bitwise equal on the two ranks, its validity equal to
one process), its heads' BatchNorm over every rank's pixel rows, its
contrastive terms and VAT; S4CVNet's SwinUNet (the attention dropout of
K13 / K14 hashing the global window) and teacher noise; Swin-MAE's mask
noise and global loss.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

if __name__ != "__main__":
    from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401
    from tests.test_torch_parallel import (
        LOSS_RTOL,
        _close,
        _free_port,
        join_all,
    )

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
ALGOS = ("uamt", "uamt_unroll", "ict", "ssnet", "s4cvnet", "swin_mae")
STEPS = 2
HW = 32
LB, UB = 2, 4  # global labelled / unlabelled batch
MAE_BATCH = 4
#: the tiny SwinUNet / Swin-MAE geometry of tests/test_torch_s4cvnet.py
SWIN = dict(embed_dim=8, depths=[2, 2], num_heads=[1, 2], window_size=2)


def _cfg(name: str) -> dict:
    # SGD throughout: adamW would turn the rounding noise of a zero
    # gradient into steps of lr (tests/test_torch_parallel.py)
    opt = dict(opt="sgd", lr=0.05, weight_decay=1e-4, momentum=0.9,
               sched="medical", total_itrs=30)
    unet = dict(feature_chns=[8, 8, 16, 16, 16], **opt)
    cfg = dict(num_classes=4, in_channels=1, train_crop_size=[HW, HW],
               batch_size=LB, unlabel_batch_size=UB, consistency=1.0,
               consistency_rampup=4.0, epoch_unit_iters=1, ema_decay=0.99,
               seed=0, step_size=10, **opt)
    if name.startswith("uamt"):
        cfg.update(model="unet", **unet)
        if name == "uamt_unroll":
            cfg.update(mc_mode="unroll", mc_chunk=2)
    elif name == "ict":
        cfg.update(model="unet", **unet)
    elif name == "ssnet":
        cfg.update(model="ssnet", **unet)
    elif name == "s4cvnet":
        cfg.update(model1=dict(model="unet", **unet),
                   model2=dict(model="swinunet", **SWIN, **opt))
    elif name == "swin_mae":
        cfg.update(model="swinmae", batch_size=MAE_BATCH,
                   decoder_embed_dim=16, **SWIN)
    return cfg


def _algorithm(name: str) -> str:
    return "uamt" if name.startswith("uamt") else name


def _batch(name: str, step: int) -> dict:
    """The global batch of ``name``'s ``step``, from a seed; row i's mean
    and scale grow with i, so the ranks' shares differ in distribution."""
    rng = np.random.default_rng((ALGOS.index(name), step))

    def img(n):
        r = (np.arange(n, dtype=np.float32) / (n - 1)).reshape(n, 1, 1, 1)
        return (rng.normal(size=(n, HW, HW, 1)) * (0.5 + r)
                + r).astype(np.float32)

    def lab(n):
        return rng.integers(0, 4, (n, HW, HW)).astype(np.int32)

    if name == "swin_mae":
        return {"image": img(MAE_BATCH), "label": lab(MAE_BATCH)}
    return {"label_img": img(LB), "label": lab(LB), "unlabel_img": img(UB)}


def _record(algo, loss: float) -> dict:
    """A step's loss and, after it, each model's gradients, parameters and
    buffers ("<field>.<name>"), and SS-Net's bank."""
    from hpfg_tpu_torch.utils.checkpoint import MODEL_FIELDS

    out = {"loss": loss, "grad": {}, "param": {}, "buffer": {}}
    for field in MODEL_FIELDS:
        model = getattr(algo, field, None)
        if model is None:
            continue
        for k, p in model.named_parameters():
            out["param"][f"{field}.{k}"] = p.detach().clone()
            if p.grad is not None:
                out["grad"][f"{field}.{k}"] = p.grad.clone()
        for k, b in model.named_buffers():
            out["buffer"][f"{field}.{k}"] = b.clone()
    if hasattr(algo, "memory"):
        out["memory"] = algo.memory.clone()
        out["memory_valid"] = algo.memory_valid.clone()
    return out


def _run(name: str, state_dir: str, publish: bool) -> list:
    """STEPS steps of ``name`` on this process's mesh, each recorded;
    ``publish`` (the one process) saves the state before each later step,
    which the ranks load (tests/test_torch_parallel.py ``_run``)."""
    from hpfg_tpu_torch.parallel.mesh import get_mesh, shard_batch
    from hpfg_tpu_torch.train.algorithms import build_algorithm

    algo = build_algorithm(_algorithm(name), _cfg(name), dtype=torch.float32,
                           device="cpu")
    mesh = get_mesh()
    steps = []
    for s in range(STEPS):
        path = os.path.join(state_dir, f"{name}_{s}.pt")
        if s and publish:
            torch.save(algo.state_dict(), path + ".tmp")
            os.replace(path + ".tmp", path)
        elif s:
            end = time.monotonic() + 120
            while not os.path.exists(path) and time.monotonic() < end:
                time.sleep(0.05)
            algo.load_state_dict(torch.load(path, weights_only=False))
        loss = algo.step(shard_batch(mesh, _batch(name, s)))["loss"]
        steps.append(_record(algo, float(loss)))
    return steps


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two workers' results and the one process's (computed here while
    the workers run)."""
    import subprocess

    out = tmp_path_factory.mktemp("dp_ssl")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(WORLD),
         str(port), str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(WORLD)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = {name: _run(name, str(out), True) for name in ALGOS}
    finally:
        torch.set_num_threads(threads)
        outs, codes = join_all(procs, 150)
    assert codes == [0] * WORLD, "\n".join(outs)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "single": single}


@pytest.mark.parametrize("name", ALGOS)
def test_two_ranks_match_one_process(two_ranks, name):
    for step, single in enumerate(two_ranks["single"][name]):
        for rank, res in enumerate(two_ranks["ranks"]):
            got, what = res[name][step], f"step {step} rank {rank}"
            np.testing.assert_allclose(got["loss"], single["loss"],
                                       rtol=LOSS_RTOL, err_msg=what)
            _close(got["grad"], single["grad"], f"{what} gradient")
            _close(got["param"], single["param"], f"{what} parameter")
            _close(got["buffer"], single["buffer"], f"{what} buffer")
        ranks = [r[name][step] for r in two_ranks["ranks"]]
        for kind in ("param", "buffer"):
            for k, v in ranks[0][kind].items():
                assert torch.equal(v, ranks[1][kind][k]), (step, k)


def test_ssnet_bank_is_the_same_on_every_rank(two_ranks):
    """The bank is bitwise equal across the ranks, its validity equal to
    one process's and its rows within the state bound of it; the first
    step fills slots (the check would hold vacuously on an empty bank)."""
    for step, single in enumerate(two_ranks["single"]["ssnet"]):
        ranks = [r["ssnet"][step] for r in two_ranks["ranks"]]
        assert torch.equal(ranks[0]["memory"], ranks[1]["memory"]), step
        assert torch.equal(ranks[0]["memory_valid"],
                           ranks[1]["memory_valid"]), step
        assert torch.equal(ranks[0]["memory_valid"],
                           single["memory_valid"]), step
        _close({"memory": ranks[0]["memory"]}, {"memory": single["memory"]},
               f"step {step} memory")
    assert bool(two_ranks["single"]["ssnet"][0]["memory_valid"].any())


def test_workers_load_no_jax(two_ranks):
    assert [r["modules"] for r in two_ranks["ranks"]] == [[], []]


def _worker(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    from hpfg_tpu_torch.parallel.distributed import init_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                     timeout_s=60)
    res = {name: _run(name, out, False) for name in ALGOS}
    res["modules"] = sorted(k for k in sys.modules
                            if k.split(".")[0] in ("jax", "hpfg_tpu"))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
