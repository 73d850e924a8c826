"""The port's data parallelism over processes on the CPU (gloo).

Two ranks (this file run as a script, one process each, one torch thread)
against one process over the same global batches: Supervised,
Mean-Teacher, CPS, CTCT and HPFG at 32^2 with dropout on, two steps each.
Each step's loss agrees to 1e-5 relative, and after each step every
parameter gradient (the ranks' average), every parameter and every BN
running statistic agree to 1e-5 times the largest magnitude of that
quantity in the model: the same sums in other orders. A missing factor of
W in a loss term, a local BN statistic or a dropout draw of the local
batch moves them far more. (Per model, not per tensor: a gradient that
cancels to a small value, such as a neck's bias or the SegFormer's
BN-invariant biases, whose exact gradient is 0, carries the rounding of
the larger terms it sums.)

The ranks' second step starts from the one-process state after the first
(``load_state_dict``, which broadcasts rank 0's models). Two fp32 runs
that differ in rounding part at any activation that sits within rounding
of a kink (a LeakyReLU's zero, where the backward's slope jumps from 1 to
0.01): in one process alone, a change of the parameters or of the BN sums
at the rounding level can move a gradient by far more than the rounding
of its sums, where one activation lies that close to the kink. So each
step, not the run, is held to the rounding of its sums; at these batches
no activation of either step lies that close.
The 2-rank Mean-Teacher loss also matches the JAX step on the 8-device
mesh (``tests/test_sharding.py``) from the same weights, to the 1e-5 of
``tests/test_torch_mean_teacher.py``.

Then the pieces on their own: the hash dropout with a two-segment image-id
map, ``shard_batch`` / ``pad_and_shard``, the rank-sharded ``BatchLoader``
and ``coordination_barrier`` against a dead and a hung peer (it raises
within its timeout plus 5 s; the harness kills every worker it started).
The other five algorithms and the models without kernels are held the
same way in ``tests/test_torch_parallel_ssl.py`` and
``tests/test_torch_parallel_zoo.py``.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

if __name__ != "__main__":
    from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
ALGOS = ("supervised", "mean_teacher", "cps", "ctct", "hpfg")
STEPS = 2
HW = 32
LB, UB = 2, 4  # global labelled / unlabelled batch
LOSS_RTOL = 1e-5
TENSOR_RTOL = 1e-5  # times the tensor's largest magnitude
#: the tiny MiT of tests/test_torch_segformer.py
TINY_MIT = ([8, 16, 40, 64], [1, 1, 1, 1])
#: the Mean-Teacher config compared with the JAX step (batches the
#: 8-device mesh divides; no dropout, whose draws differ between packages)
MT_JAX_CFG = dict(model="unet", feature_chns=[16] * 5, dropout=[0.0] * 5,
                  num_classes=4, in_channels=1, train_crop_size=[HW, HW],
                  batch_size=8, unlabel_batch_size=8, consistency=1.0,
                  consistency_rampup=4.0, epoch_unit_iters=1, ema_decay=0.99,
                  seed=0, total_itrs=30, step_size=10, opt="sgd", lr=0.05,
                  weight_decay=1e-4, momentum=0.9, sched="medical")
#: a barrier's deadline in the failure-mode runs, and the slack allowed
BARRIER_S, SLACK_S = 3.0, 5.0


def _cfg(name: str) -> dict:
    opt = dict(opt="sgd", lr=0.05, weight_decay=1e-4, momentum=0.9,
               sched="medical", total_itrs=30)
    unet = dict(feature_chns=[8, 8, 16, 16, 16], **opt)
    cfg = dict(num_classes=4, in_channels=1, train_crop_size=[HW, HW],
               batch_size=LB, unlabel_batch_size=UB, consistency=1.0,
               consistency_rampup=4.0, epoch_unit_iters=1, ema_decay=0.99,
               seed=0, step_size=10, **opt)
    if name == "supervised":
        cfg.update(model="unet", batch_size=LB + UB, **unet)
    elif name in ("mean_teacher", "cps"):
        cfg.update(model="unet", **unet)
    elif name == "hpfg":
        cfg.update(model="unet_plus", **unet)
    elif name == "ctct":
        cfg.update(model1=dict(model="unet", **unet),
                   # SGD: adamW would turn the rounding noise of the
                   # BN-invariant biases' zero gradient into steps of lr
                   # (tests/test_torch_ctct.py)
                   model2=dict(model="segformer", mit="T", drop_rate=0.1,
                               drop_path_rate=0.1, **opt))
    return cfg


def _batch(name: str, step: int) -> dict:
    """The global batch of ``name``'s ``step``, from a seed."""
    rng = np.random.default_rng((ALGOS.index(name), step))

    def img(n):
        return rng.normal(size=(n, HW, HW, 1)).astype(np.float32)

    def lab(n):
        return rng.integers(0, 4, (n, HW, HW)).astype(np.int32)

    if name == "supervised":
        return {"image": img(LB + UB), "label": lab(LB + UB)}
    batch = {"label_img": img(LB), "label": lab(LB), "unlabel_img": img(UB)}
    if name == "hpfg":
        batch.update(label_img1=img(LB), label1=lab(LB))
    return batch


def _record(algo, loss: float) -> dict:
    """A step's loss and, after it, each model's gradients, parameters and
    buffers ("<field>.<name>")."""
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
    return out


def _run(name: str, state_dir: str, publish: bool) -> list:
    """STEPS steps of ``name`` on this process's mesh (this rank's rows of
    each global batch), each recorded. ``publish`` (the one process) saves
    the state before each later step to ``state_dir``; otherwise (a rank)
    each later step starts from that state, once it is there."""
    from hpfg_tpu_torch.models import segformer
    from hpfg_tpu_torch.parallel.mesh import get_mesh, shard_batch
    from hpfg_tpu_torch.train.algorithms import build_algorithm

    segformer.MIT_SETTINGS.setdefault("T", TINY_MIT)
    algo = build_algorithm(name, _cfg(name), dtype=torch.float32,
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


def _run_mt_jax_weights(state_path: str) -> float:
    """One Mean-Teacher step of MT_JAX_CFG from the JAX weights saved at
    ``state_path``, on this rank's rows."""
    from hpfg_tpu_torch.parallel.mesh import get_mesh, shard_batch
    from hpfg_tpu_torch.train.algorithms import build_algorithm

    algo = build_algorithm("mean_teacher", MT_JAX_CFG, dtype=torch.float32,
                           device="cpu")
    state = torch.load(state_path, weights_only=True)
    algo.model.load_state_dict(state, strict=True)
    algo.ema.load_state_dict(state, strict=True)
    return float(algo.step(shard_batch(get_mesh(), _mt_batch()))["loss"])


def _mt_batch() -> dict:
    rng = np.random.default_rng(11)
    return {"label_img": rng.normal(size=(8, HW, HW, 1)).astype(np.float32),
            "label": rng.integers(0, 4, (8, HW, HW)).astype(np.int32),
            "unlabel_img": rng.normal(size=(8, HW, HW, 1)).astype(
                np.float32)}


# ---------------------------------------------------------------------------
# the harness: spawn W workers, kill every one that outlives the deadline
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(mode: str, out_dir: str, extra: str = "") -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(rank),
         str(WORLD), str(port), out_dir, extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(WORLD)]


def join_all(procs: list, deadline_s: float,
             wait_for: int | None = None) -> tuple[list, list]:
    """(outputs, return codes) of every worker. The first ``wait_for``
    workers (default: all) are waited for until the deadline; then every
    worker still running is killed (its code is then None)."""
    outs = [""] * len(procs)

    def drain(i, p):
        outs[i] = p.stdout.read()

    threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    end = time.monotonic() + deadline_s
    for p in procs[:wait_for]:
        try:
            p.wait(timeout=max(0.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    codes = [p.poll() for p in procs]
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for t in threads:
        t.join(timeout=5)
    return outs, codes


# ---------------------------------------------------------------------------
# 2 ranks against 1 process (one spawn for every algorithm)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The workers' results, the one-process results (computed here while
    the workers run) and the JAX Mean-Teacher loss on the 8-device mesh."""
    import jax

    from hpfg_tpu.config import Config
    from hpfg_tpu.parallel.mesh import make_mesh, shard_batch
    from hpfg_tpu.train.algorithms import build_algorithm
    from hpfg_tpu_torch.utils.jax_weights import jax_to_torch_state

    out = tmp_path_factory.mktemp("dp")
    jalgo = build_algorithm("mean_teacher", Config(MT_JAX_CFG),
                            dtype=jax.numpy.float32)
    state = jax.jit(jalgo.init_state)(jax.random.PRNGKey(0))
    host = jax.device_get(state)
    torch.save(jax_to_torch_state(host.model.params, host.model.batch_stats),
               out / "mt_state.pt")
    procs = spawn("compare", str(out))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = {name: _run(name, str(out), True) for name in ALGOS}
        _, metrics = jax.jit(jalgo.step)(
            state, shard_batch(make_mesh(), _mt_batch()))
        jax_loss = float(metrics["loss"])
    finally:
        torch.set_num_threads(threads)
        outs, codes = join_all(procs, 150)
    assert codes == [0] * WORLD, "\n".join(outs)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "single": single, "jax_loss": jax_loss,
            "mesh": len(make_mesh().devices.flat)}


def _close(got: dict, want: dict, what: str) -> None:
    """Every tensor within TENSOR_RTOL times the largest magnitude of its
    model's tensors (the key's first part)."""
    assert set(got) == set(want), what
    scale: dict = {}
    for k, v in want.items():
        model = k.split(".")[0]
        scale[model] = max(scale.get(model, 1e-30), float(v.abs().max()))
    for k in want:
        err = float((got[k] - want[k]).abs().max())
        bound = TENSOR_RTOL * scale[k.split(".")[0]]
        assert err <= bound, f"{what} {k}: {err} > {bound}"


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
        # the replicas are equal, bit for bit
        ranks = [r[name][step] for r in two_ranks["ranks"]]
        for kind in ("param", "buffer"):
            for k, v in ranks[0][kind].items():
                assert torch.equal(v, ranks[1][kind][k]), (step, k)


def test_workers_load_no_jax(two_ranks):
    assert [r["modules"] for r in two_ranks["ranks"]] == [[], []]


def test_two_rank_mean_teacher_matches_the_jax_mesh_step(two_ranks):
    assert two_ranks["mesh"] == 8
    losses = [r["mt_jax"] for r in two_ranks["ranks"]]
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], two_ranks["jax_loss"],
                               rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_hash_mask_with_global_ids_is_the_full_batch_mask():
    """A rank's two-segment id map (labelled then unlabelled rows) picks
    the rows of the full batch's mask, bit for bit; None is arange."""
    from hpfg_tpu_torch.ops.conv_block import hash_mask
    from hpfg_tpu_torch.parallel.mesh import Mesh

    lb, ub, h, lanes = 4, 8, 5, 24
    full = hash_mask(1234, lb + ub, h, lanes, 0.7)
    assert torch.equal(hash_mask(1234, lb + ub, h, lanes, 0.7, None,
                                 torch.arange(lb + ub)), full)
    for rank in range(WORLD):
        rows = Mesh(WORLD, rank, torch.device("cpu")).rows(lb, ub)
        local = hash_mask(1234, len(rows.ids), h, lanes, 0.7, None,
                          rows.ids)
        assert rows.total == lb + ub
        assert torch.equal(local, full[rows.index])
        want = np.r_[np.arange(2) + 2 * rank, lb + np.arange(4) + 4 * rank]
        assert rows.index.tolist() == want.tolist()


def test_shard_batch_and_pad_and_shard():
    from hpfg_tpu_torch.parallel.mesh import (
        Mesh,
        pad_and_shard,
        pad_to_multiple,
        shard_batch,
    )

    cpu = torch.device("cpu")
    batch = {"x": np.arange(8 * 3).reshape(8, 3), "t": torch.arange(8),
             "s": np.float32(2.0)}
    parts = [shard_batch(Mesh(WORLD, r, cpu), batch) for r in range(WORLD)]
    np.testing.assert_array_equal(np.concatenate([p["x"] for p in parts]),
                                  batch["x"])
    assert torch.equal(torch.cat([p["t"] for p in parts]), batch["t"])
    assert parts[1]["s"] == 2.0
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(Mesh(3, 0, cpu), batch)
    rows, n = pad_and_shard(Mesh(WORLD, 1, cpu), np.ones((5, 2)))
    assert n == 5 and rows.shape == (3, 2) and rows[2].sum() == 0
    assert pad_to_multiple(5, 4) == 8
    one = Mesh(1, 0, cpu)
    assert shard_batch(one, batch)["x"] is not None and one.rows(3) is None


def test_rank_sharded_loader_visits_the_one_process_indices():
    from hpfg_tpu_torch.data.loader import BatchLoader

    class Source:
        def __len__(self):
            return 21

        def load(self, idx):
            return np.full((2, 2, 1), idx, np.float32), np.zeros((2, 2))

    def epoch(loader):
        return [b[0][:, 0, 0, 0].astype(int).tolist() for b in loader]

    whole = epoch(BatchLoader(Source(), 6, seed=3, num_threads=1))
    ranks = [epoch(BatchLoader(Source(), 6, seed=3, num_threads=1)
                   .shard(r, 3)) for r in range(3)]
    assert len(whole) == 3 and all(len(r) == 3 for r in ranks)
    for i, batch in enumerate(whole):
        assert sum((r[i] for r in ranks), []) == batch
    with pytest.raises(ValueError, match="does not divide"):
        BatchLoader(Source(), 6).shard(0, 4)


def test_init_distributed_without_a_group_is_one_process(monkeypatch):
    from hpfg_tpu_torch.parallel import distributed as d

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert d.init_distributed() is False
    assert d.process_count() == 1 and d.is_main_process()
    d.coordination_barrier("alone", 0.1)
    x = torch.ones(3, requires_grad=True)
    assert d.all_reduce_sum(x, None) is x
    assert d.all_gather_rows(x, None) is x
    with pytest.raises(ValueError, match="coordinator"):
        d.init_distributed(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        d.init_distributed("127.0.0.1:1", 2, 0, device="cpu",
                           backend="nccl")


@pytest.mark.parametrize("mode", ["dead", "hung"])
def test_barrier_raises_on_a_dead_or_hung_peer(mode, tmp_path):
    procs = spawn(mode, str(tmp_path))
    t0 = time.monotonic()
    outs, codes = join_all(procs, 60, wait_for=1)
    assert time.monotonic() - t0 < 60
    assert codes[0] == 0, outs[0]
    line = [ln for ln in outs[0].splitlines() if ln.startswith("{")][-1]
    got = json.loads(line)
    assert got["raised"] == "RuntimeError", got
    assert got["seconds"] <= BARRIER_S + SLACK_S, got
    if mode == "hung":
        assert codes[1] is None  # killed by the harness


def test_cli_refuses_distributed_without_a_group(synthetic_acdc, tmp_path,
                                                 monkeypatch):
    """``distributed=true`` with nothing to join stops; it never trains
    alone in place of the ranks asked for."""
    from hpfg_tpu_torch.run import run

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="no process group"):
        run(["--config", os.path.join(REPO, "configs",
                                      "unet_30k_224x224_ACDC.yaml"), "--set",
             f"data_path={synthetic_acdc}", "--set",
             f"save_path={tmp_path / 'run'}", "--set", "device=cpu",
             "--set", "distributed=true"])


def test_cli_under_two_ranks_writes_from_rank_0(synthetic_acdc, tmp_path):
    """``torch.distributed.run`` of the CLI (HPFG, 4 steps, eval at 2 and
    4) over 2 gloo ranks: every rank trains and evaluates its share of the
    test volumes, rank 0 alone logs and writes the checkpoints."""
    run = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(WORLD), "--master-port", str(_free_port()), "-m",
           "hpfg_tpu_torch.run", "--config",
           "configs/hpfg_unet_plus_30k_224x224_ACDC.yaml"]
    for kv in (f"data_path={synthetic_acdc}", f"save_path={run}",
               "device=cpu", "precision=fp32", "label_num=0.25",
               "batch_size=2", "unlabel_batch_size=4",
               "train_crop_size=[32,32]", "test_crop_size=[32,32]",
               "total_itrs=4", "step_size=2", "distributed=true",
               "model1.feature_chns=[8,8,8,8,8]",
               "model2.feature_chns=[8,8,8,8,8]"):
        cmd += ["--set", kv]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out = proc.communicate(timeout=240)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    assert proc.returncode == 0, out
    log = (run / "log.log").read_text()
    for line in ("iter 2 model1 dice", "iter 4 ema dice", "done: 4 iters",
                 "iter 2 eval over 2 rank(s)", "iter 4 eval over 2 rank(s)"):
        assert log.count(line) == 1, line
    assert {"last.pt", "last_a.pt", "last_b.pt", "best_model1.pt"} <= set(
        os.listdir(run / "model"))


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _worker(mode: str, rank: int, world: int, port: int, out: str,
            extra: str) -> None:
    torch.set_num_threads(1)
    from hpfg_tpu_torch.parallel.distributed import (
        coordination_barrier,
        init_distributed,
    )

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                     timeout_s=60)
    if mode == "compare":
        res = {name: _run(name, out, False) for name in ALGOS}
        res["mt_jax"] = _run_mt_jax_weights(os.path.join(out,
                                                         "mt_state.pt"))
        res["modules"] = sorted(k for k in sys.modules
                                if k.split(".")[0] in ("jax", "hpfg_tpu"))
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    elif mode in ("dead", "hung"):
        coordination_barrier("start", 30)
        if rank == 1:
            if mode == "hung":
                time.sleep(600)
            os._exit(0)
        t0 = time.monotonic()
        try:
            coordination_barrier("peer", BARRIER_S)
            raised = None
        except Exception as exc:  # noqa: BLE001 - reported to the test
            raised = type(exc).__name__
        print(json.dumps({"raised": raised,
                          "seconds": time.monotonic() - t0}), flush=True)
    elif mode == "nt_xent":
        # the library's distributed NT-Xent on this rank's rows of the
        # views saved by the test, with its gradient
        from hpfg_tpu_torch.ops.contrastive import nt_xent_distributed
        from hpfg_tpu_torch.parallel.mesh import get_mesh, shard_batch

        mesh = get_mesh()
        views = torch.load(os.path.join(out, "views.pt"), weights_only=True)
        z = [shard_batch(mesh, v).clone().requires_grad_(True)
             for v in views]
        loss = nt_xent_distributed(z[0], z[1], float(extra), mesh)
        loss.backward()
        torch.save({"loss": loss.detach(), "grads": [t.grad for t in z]},
                   os.path.join(out, f"nt_xent{rank}.pt"))
    elif mode == "losses":
        # the mesh-taking losses of ops/losses.py on this rank's rows of
        # the inputs saved by tests/test_torch_losses_lib.py, with the
        # gradient of each one's first argument
        from hpfg_tpu_torch.ops import losses
        from hpfg_tpu_torch.parallel.mesh import get_mesh, shard_batch

        mesh = get_mesh()
        saved = torch.load(os.path.join(out, "losses.pt"), weights_only=True)
        rows = shard_batch(mesh, saved["inputs"])
        res = {}
        for name, (fn, first, rest, kwargs) in saved["cases"].items():
            x = rows[first].clone().requires_grad_(True)
            loss = getattr(losses, fn)(x, *(rows[k] for k in rest),
                                       mesh=mesh, **kwargs)
            loss.backward()
            res[name] = (loss.detach(), x.grad)
        torch.save(res, os.path.join(out, f"losses{rank}.pt"))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    sys.stdout.flush()
    # no process-group teardown: a dead peer must not hold this one
    os._exit(0)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), sys.argv[5], sys.argv[6])
