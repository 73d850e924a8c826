"""Data parallelism of the models without hand-written kernels on the CPU.

Two gloo ranks (this file run as a script) against one process: one
Supervised step (dropouts and drop paths on) on CMT_Plus, UniFormer_Plus,
TransUNet, ResUNet, ResUNet++, UCTransNet, UNet_Large and SwinUNet at 32^2,
each on a global batch of four images whose rows differ in distribution,
held to the bounds of ``tests/test_torch_parallel.py``: the loss to 1e-5
relative, every gradient (the ranks' average), parameter and BN running
statistic to 1e-5 of its model's largest magnitude. The repeated blocks
are cut to one a stage (CMT, UniFormer), one ViT block (TransUNet) and
one channel-transformer layer (UCTransNet); widths are the published
ones, and the SwinUNet is the tiny one of ``tests/test_torch_s4cvnet.py``.
ReLU runs as softplus and the 2x2 max pool as the average pool on both
sides, as ``tests/test_torch_zoo_cnn.py`` runs them against JAX: with the
kinks, an activation within rounding of ReLU's zero or a near-tie in a
pool routes the stem's gradient differently in two fp32 runs whose sums
differ only in order (TransUNet, ResUNet, ResUNet++ and UCTransNet read
2e-5 to 3e-4 of the largest gradient at their first conv), far above the
rounding of the sums, which is what this test holds.

Also: every registry model's forward takes ``rows``, and the attention
dropout's mask with a two-segment image-id map is the full batch's mask at
those windows, bit for bit, with the global window count under and over
the hash's window block of 16.
"""

import functools
import inspect
import os
import sys

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
HW, BATCH = 32, 4
#: model -> its config hooks
MODELS = {
    "cmt_plus": {}, "uniformer_plus": {}, "transunet": {}, "resunet": {},
    "resunet_plusplus": {}, "uctransnet": {},
    "unet_large": {"base_c": 8},
    "swinunet": dict(embed_dim=8, depths=[2, 2], num_heads=[1, 2],
                     window_size=2),
}


def _cut_depths(setattr_) -> None:
    """One block a stage (CMT, UniFormer), one ViT block (TransUNet), one
    channel-transformer layer (UCTransNet); ReLU -> softplus and the 2x2
    max pool -> the average pool (``tests/test_torch_zoo_cnn.py``
    ``smooth_kinks``)."""
    import torch.nn.functional as F

    from hpfg_tpu_torch.models import cmt, transunet, uctransnet, uniformer

    setattr_(torch, "relu", F.softplus)
    setattr_(F, "max_pool2d", F.avg_pool2d)
    setattr_(cmt.CMTPlus, "encoder_kwargs",
             {**cmt.CMT_TINY, "depths": (1, 1, 1, 1)})
    setattr_(uniformer, "UniFormer",
             functools.partial(uniformer.UniFormer, depth=(1, 1, 1, 1)))
    setattr_(transunet, "BLOCKS", 1)
    setattr_(uctransnet, "LAYERS", 1)


def _cfg(name: str) -> dict:
    return dict(model=name, num_classes=4, in_channels=1,
                train_crop_size=[HW, HW], batch_size=BATCH, seed=0,
                opt="sgd", lr=0.05, weight_decay=1e-4, momentum=0.9,
                sched="medical", total_itrs=30, **MODELS[name])


def _batch(name: str) -> dict:
    rng = np.random.default_rng(list(MODELS).index(name))
    r = (np.arange(BATCH, dtype=np.float32) / (BATCH - 1)).reshape(
        BATCH, 1, 1, 1)
    img = rng.normal(size=(BATCH, HW, HW, 1)) * (0.5 + r) + r
    return {"image": img.astype(np.float32),
            "label": rng.integers(0, 4, (BATCH, HW, HW)).astype(np.int32)}


def _step(name: str) -> dict:
    """One Supervised step on this process's rows: the loss and, after it,
    the gradients, parameters and buffers."""
    from hpfg_tpu_torch.parallel.mesh import get_mesh, shard_batch
    from hpfg_tpu_torch.train.algorithms import build_algorithm

    algo = build_algorithm("supervised", _cfg(name), dtype=torch.float32,
                           device="cpu")
    loss = algo.step(shard_batch(get_mesh(), _batch(name)))["loss"]
    model = algo.model
    return {"loss": float(loss),
            "grad": {f"model.{k}": p.grad.clone()
                     for k, p in model.named_parameters()},
            "param": {f"model.{k}": p.detach().clone()
                      for k, p in model.named_parameters()},
            "buffer": {f"model.{k}": b.clone()
                       for k, b in model.named_buffers()}}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    import subprocess

    out = tmp_path_factory.mktemp("dp_zoo")
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
        with pytest.MonkeyPatch.context() as mp:
            _cut_depths(mp.setattr)
            single = {name: _step(name) for name in MODELS}
    finally:
        torch.set_num_threads(threads)
        outs, codes = join_all(procs, 150)
    assert codes == [0] * WORLD, "\n".join(outs)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "single": single}


@pytest.mark.parametrize("name", list(MODELS))
def test_two_ranks_match_one_process(two_ranks, name):
    single = two_ranks["single"][name]
    for rank, res in enumerate(two_ranks["ranks"]):
        got, what = res[name], f"{name} rank {rank}"
        np.testing.assert_allclose(got["loss"], single["loss"],
                                   rtol=LOSS_RTOL, err_msg=what)
        _close(got["grad"], single["grad"], f"{what} gradient")
        _close(got["param"], single["param"], f"{what} parameter")
        _close(got["buffer"], single["buffer"], f"{what} buffer")
    ranks = [r[name] for r in two_ranks["ranks"]]
    for kind in ("param", "buffer"):
        for k, v in ranks[0][kind].items():
            assert torch.equal(v, ranks[1][kind][k]), k


def _registry_cfg(name: str) -> dict:
    """A registry name at its smallest build: 32^2, the tiny Swin hooks."""
    cfg = {"model": name, "train_crop_size": [HW, HW], "in_channels": 1,
           "feature_chns": [8, 8, 8, 8, 8], "base_c": 8}
    if "swin" in name:
        cfg.update(MODELS["swinunet"], decoder_embed_dim=16)
    if name.startswith("segformer"):
        cfg["mit"] = "B0"
    return cfg


@pytest.mark.parametrize("name", sorted(__import__(
    "hpfg_tpu_torch.models", fromlist=["MODELS"]).MODELS))
def test_every_registry_model_takes_rows(name):
    from hpfg_tpu_torch.models import build_model

    with pytest.MonkeyPatch.context() as mp:
        _cut_depths(mp.setattr)
        model = build_model(_registry_cfg(name))
    assert "rows" in inspect.signature(model.forward).parameters


@pytest.mark.parametrize("lb,ub,nw", [(2, 4, 2), (4, 8, 4), (2, 2, 9)])
def test_attn_drop_mask_with_global_ids_is_the_full_batch_mask(lb, ub, nw):
    """Each rank's windows (nw an image; the global count 12, 48 and 36,
    so the first lies under the window block of 16) get the full batch's
    masks."""
    from hpfg_tpu_torch.ops.window_attention import attn_drop_mask
    from hpfg_tpu_torch.parallel.mesh import Mesh

    heads, l, keep = 2, 9, 0.6
    full = attn_drop_mask(4321, (lb + ub) * nw, heads, l, keep)
    for rank in range(WORLD):
        rows = Mesh(WORLD, rank, torch.device("cpu")).rows(lb, ub)
        local = attn_drop_mask(4321, len(rows.ids) * nw, heads, l, keep,
                               image_ids=rows.ids, total=rows.total)
        assert torch.equal(local, full[rows.expand(nw).index])
    # rank 1's local hash (the fault the ids repair) is another mask
    alone = attn_drop_mask(4321, len(rows.ids) * nw, heads, l, keep)
    assert not torch.equal(alone, local)


def test_attention_ids_without_the_global_count_raise():
    """An image-id map without ``total`` has no global window count to set
    the hash's block from: the mask and both wrappers refuse it."""
    from hpfg_tpu_torch.ops.conv_block import HashDropout
    from hpfg_tpu_torch.ops.window_attention import (
        attn_drop_mask,
        window_attention_bwd,
        window_attention_fwd,
    )
    from hpfg_tpu_torch.parallel.mesh import Mesh

    rows = Mesh(WORLD, 1, torch.device("cpu")).rows(2, 2)
    heads, l, c, nw = 1, 4, 8, 2
    bn = len(rows.ids) * nw
    with pytest.raises(ValueError, match="total"):
        attn_drop_mask(5, bn, heads, l, 0.9, image_ids=rows.ids)
    qkv = torch.zeros((bn, l, 3 * c))
    bias = torch.zeros((heads, l, l))
    drop = HashDropout(5, 0.9, rows.ids)
    with pytest.raises(ValueError, match="total"):
        window_attention_fwd(qkv, bias, None, heads, drop)
    with pytest.raises(ValueError, match="total"):
        window_attention_bwd(qkv, bias, None, torch.zeros((bn, l, c)), heads,
                             drop)


def _worker(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    from hpfg_tpu_torch.parallel.distributed import init_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                     timeout_s=60)
    _cut_depths(setattr)
    res = {name: _step(name) for name in MODELS}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
