"""The port's eval over every rank, on the CPU (gloo).

Two ranks (this file run as a script, one process each, one torch thread)
split the volumes, or the test batches, by index modulo 2, exchange their
float64 rows through the rendezvous store and sum them in index order:
``evaluate_volumes_multi`` (two models, 5 volumes: an uneven split; and 1
volume: a rank with none) and ``evaluate_images`` (5 batches, with and
without the full metrics) give every rank one process's result bit for
bit, and each rank loads only its own volumes. Then a 2-rank Mean-Teacher
``fit`` whose eval at iteration 2 runs on the worker thread beside steps 3
and 4, whose collectives run on the training group: every rank's
``history`` equals one process's eval of the states rank 0 saved at those
boundaries. ``gather_objects`` alone: the identity in one process, one
round a tag left in the store, and a ``RuntimeError`` within its timeout
where a peer is dead. An eval over ranks refuses an iterable without
``share``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

if __name__ != "__main__":
    from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MT = os.path.join(REPO, "configs", "mean_teacher_unet_30k_224x224_ACDC.yaml")
WORLD = 2
HW = 32
#: the gather's deadline in the dead-peer run, and the slack allowed
GATHER_S, SLACK_S = 3.0, 5.0


class Volumes:
    """``n`` seeded (image [D, H, W], label [D, H, W]) volumes of native
    size 40 x 36 (zoomed to the 32^2 patch and back), recording which
    indices were loaded."""

    def __init__(self, n: int):
        self.n = n
        self.loaded: list[int] = []

    def __len__(self) -> int:
        return self.n

    def load(self, idx: int):
        self.loaded.append(int(idx))
        rng = np.random.default_rng(100 + idx)
        image = rng.normal(size=(3, 40, 36)).astype(np.float32)
        label = np.zeros((3, 40, 36), np.uint8)
        label[:, 8:30, 6:20] = 1 + idx % 3
        label[:, 12:20, 20:30] = 3
        return image, label


class Listed(list):
    """Loaded volumes in a list, with the loaders' ``share``."""

    def share(self, rank: int, world: int):
        return ((i, self[i]) for i in range(rank, len(self), world))


class Images:
    """Eleven seeded 2-D (image [H, W, 1], binary label [H, W]) samples."""

    def __len__(self) -> int:
        return 11

    def load(self, idx: int):
        rng = np.random.default_rng(200 + idx)
        image = rng.normal(size=(HW, HW, 1)).astype(np.float32)
        label = (rng.random((HW, HW)) > 0.6).astype(np.uint8)
        return image, label


def _models() -> dict:
    from hpfg_tpu_torch.models import build_model

    out = {}
    for name, seed in (("a", 0), ("b", 1)):
        model = build_model({"model": "unet", "feature_chns": [8] * 5,
                             "num_classes": 4, "in_channels": 1},
                            dtype=torch.float32,
                            generator=torch.Generator().manual_seed(seed))
        out[name] = model.eval()
    return out


def _binary_model():
    from hpfg_tpu_torch.models import build_model

    return build_model({"model": "unet", "feature_chns": [8] * 5,
                        "num_classes": 2, "in_channels": 1},
                       dtype=torch.float32,
                       generator=torch.Generator().manual_seed(2)).eval()


def _evals(mesh=None) -> dict:
    """Every eval of the comparison, on ``mesh`` (None: one process)."""
    from hpfg_tpu_torch.data.loader import BatchLoader, VolumeLoader
    from hpfg_tpu_torch.evals.volume import (
        evaluate_images,
        evaluate_volumes_multi,
    )

    cpu = torch.device("cpu")
    out, loaded = {}, {}
    for n in (5, 1):
        source = Volumes(n)
        res = evaluate_volumes_multi(_models(), VolumeLoader(source), 4,
                                     (HW, HW), cpu, want_first=True,
                                     mesh=mesh)
        out[f"volumes{n}"] = {k: (d, h, pc, first is not None)
                              for k, (d, h, pc, first) in res.items()}
        loaded[n] = sorted(source.loaded)
    model = _binary_model()
    for full in (False, True):
        loader = BatchLoader(Images(), 2, shuffle=False, drop_last=False,
                             num_threads=1)
        out[f"images{int(full)}"] = evaluate_images(model, loader, cpu,
                                                    full_metrics=full,
                                                    mesh=mesh)
    # volumes already loaded, in a list with a share of its own
    vols = Listed(Volumes(5).load(i) for i in range(5))
    out["list"] = {k: v[:3] for k, v in evaluate_volumes_multi(
        _models(), vols, 4, (HW, HW), cpu, mesh=mesh).items()}
    return {"results": out, "loaded": loaded}


def _fit_cfg(root, save):
    from hpfg_tpu_torch.config import parse_config

    argv = ["--config", MT]
    for kv in (f"data_path={root}", f"save_path={save}", "device=cpu",
               "precision=fp32", "label_num=0.25", "batch_size=2",
               "unlabel_batch_size=4", "train_crop_size=[32,32]",
               "test_crop_size=[32,32]", "total_itrs=4", "step_size=2",
               "feature_chns=[8,8,8,8,8]"):
        argv += ["--set", kv]
    return parse_config("t", "", argv)


def _fit(root, save) -> list:
    """The 2-rank Mean-Teacher fit (this rank's part); its history."""
    from hpfg_tpu_torch.train.algorithms import build_algorithm
    from hpfg_tpu_torch.train.trainer import Trainer

    cfg = _fit_cfg(root, save)
    algo = build_algorithm(cfg["algorithm"], cfg, dtype=torch.float32,
                           device="cpu")
    trainer = Trainer(cfg, algo, workdir=save, enable_tb=False)
    assert trainer.async_eval
    trainer.fit()
    return trainer.history


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

def _spawn(mode: str, out: str, extra: str = "") -> list:
    from tests.test_torch_parallel import _free_port

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(rank),
         str(WORLD), str(port), out, extra], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(WORLD)]


@pytest.fixture(scope="module")
def two_ranks(synthetic_acdc, tmp_path_factory):
    """The workers' evals and fit histories, and the one-process evals
    (computed here while the workers run)."""
    from tests.test_torch_parallel import join_all

    out = tmp_path_factory.mktemp("eval_ranks")
    procs = _spawn("compare", str(out), synthetic_acdc)
    try:
        single = _evals()
    finally:
        outs, codes = join_all(procs, 180)
    assert codes == [0] * WORLD, "\n".join(outs)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "single": single, "save": out / "fit",
            "root": synthetic_acdc}


def _assert_same(got, want, what: str) -> None:
    """Equal, bit for bit (arrays by their bytes)."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert g_bytes(got) == g_bytes(want), what
    else:
        assert got == want and type(got) is type(want), (what, got, want)


def g_bytes(x: np.ndarray) -> tuple:
    return (x.dtype.str, x.shape, x.tobytes())


@pytest.mark.parametrize("which", ["volumes5", "volumes1", "images0",
                                   "images1", "list"])
def test_two_ranks_evaluate_as_one_process(two_ranks, which):
    want = two_ranks["single"]["results"][which]
    for rank, res in enumerate(two_ranks["ranks"]):
        got = res["evals"]["results"][which]
        if which.startswith("volumes"):
            # volume 0's panels are on rank 0 alone
            got = {k: v[:3] + (v[3] or rank != 0,) for k, v in got.items()}
        _assert_same(got, want, f"rank {rank}")


def test_each_rank_loads_only_its_volumes(two_ranks):
    assert two_ranks["single"]["loaded"] == {5: [0, 1, 2, 3, 4], 1: [0]}
    loaded = [r["evals"]["loaded"] for r in two_ranks["ranks"]]
    assert loaded == [{5: [0, 2, 4], 1: [0]}, {5: [1, 3], 1: []}]


def test_two_rank_fit_history_is_the_one_process_eval(two_ranks):
    """Each boundary's results on every rank equal one process's eval of
    the state rank 0 saved there (``last_a`` at 2, ``last_b`` at 4)."""
    from hpfg_tpu_torch.data.builder import build_loader
    from hpfg_tpu_torch.train.algorithms import build_algorithm
    from hpfg_tpu_torch.train.trainer import Trainer
    from hpfg_tpu_torch.utils.checkpoint import CheckpointManager

    histories = [r["history"] for r in two_ranks["ranks"]]
    assert histories[0] == histories[1]
    assert [h["iter"] for h in histories[0]] == [2, 4]
    save = two_ranks["save"]
    assert {"last.pt", "last_a.pt", "last_b.pt"} <= set(
        os.listdir(save / "model"))
    ckpt = CheckpointManager(str(save / "model"), create=False)
    cfg = _fit_cfg(two_ranks["root"], str(save / "single"))
    for tag, entry in zip(("last_a", "last_b"), histories[0]):
        state = ckpt.restore(tag)["algorithm"]
        assert state["step_count"] == entry["iter"]
        algo = build_algorithm(cfg["algorithm"], cfg, dtype=torch.float32,
                               device="cpu")
        algo.load_state_dict(state)
        single = Trainer(cfg, algo, loaders=build_loader(cfg),
                         workdir=str(save / "single"), enable_tb=False)
        assert single.evaluate(entry["iter"]) == entry["results"]


def test_gather_keeps_one_round_a_tag(two_ranks):
    """After the evals' gathers (3 rounds of ``volumes``, 2 of
    ``images``) rank 0 has deleted every round but each tag's last."""
    assert two_ranks["ranks"][0]["rounds"] == {
        "volumes": [False, False, True], "images": [False, True]}


def test_eval_over_ranks_needs_share():
    from hpfg_tpu_torch.evals.volume import evaluate_images
    from hpfg_tpu_torch.parallel.mesh import Mesh

    batches = [(np.zeros((1, HW, HW, 1), np.float32),
                np.zeros((1, HW, HW), np.uint8))]
    cpu = torch.device("cpu")
    with pytest.raises(TypeError, match="share"):
        evaluate_images(_binary_model(), batches, cpu,
                        mesh=Mesh(world=2, rank=0, device=cpu))


def test_gather_objects_is_the_identity_in_one_process(monkeypatch):
    from hpfg_tpu_torch.parallel import distributed as d

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    obj = {"rows": np.arange(3.0)}
    got = d.gather_objects("alone", obj)
    assert got == [obj] and got[0] is obj


def test_gather_raises_on_a_dead_peer(tmp_path):
    from tests.test_torch_parallel import join_all

    procs = _spawn("dead", str(tmp_path))
    t0 = time.monotonic()
    outs, codes = join_all(procs, 60, wait_for=1)
    assert time.monotonic() - t0 < 60
    assert codes[0] == 0, outs[0]
    line = [ln for ln in outs[0].splitlines() if ln.startswith("{")][-1]
    got = json.loads(line)
    assert got["raised"] == "RuntimeError", got
    assert got["seconds"] <= GATHER_S + SLACK_S, got


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _worker(mode: str, rank: int, world: int, port: int, out: str,
            extra: str) -> None:
    torch.set_num_threads(1)
    from hpfg_tpu_torch.parallel.distributed import (
        _STATE,
        coordination_barrier,
        gather_objects,
        init_distributed,
    )
    from hpfg_tpu_torch.parallel.mesh import get_mesh

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                     timeout_s=60)
    if mode == "compare":
        res = {"evals": _evals(get_mesh())}
        coordination_barrier("evals", 60)
        if rank == 0:
            store = _STATE["eval_store"]
            res["rounds"] = {tag: [store.check([f"gather/{tag}/{n}/{r}"
                                                for r in range(world)])
                                   for n in range(rounds)]
                             for tag, rounds in (("volumes", 3),
                                                 ("images", 2))}
        res["history"] = _fit(extra, os.path.join(out, "fit"))
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    elif mode == "dead":
        assert gather_objects("start", rank, 30) == [0, 1]
        coordination_barrier("start", 30)
        if rank == 1:
            os._exit(0)
        t0 = time.monotonic()
        try:
            gather_objects("rows", {"rank": rank}, GATHER_S)
            raised = None
        except Exception as exc:  # noqa: BLE001 - reported to the test
            raised = type(exc).__name__
        print(json.dumps({"raised": raised,
                          "seconds": time.monotonic() - t0}), flush=True)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), sys.argv[5], sys.argv[6])
