"""The port stands apart from JAX: importing ``hpfg_tpu_torch`` and running
one tiny Mean-Teacher step on the CPU, or its CLI's training and evaluation
of Supervised, Mean-Teacher, CPS, CTCT, HPFG, S4CVNet, UAMT, ICT-MedSeg,
SS-Net and Swin-MAE on a synthetic ACDC tree, or parsing and building the
full-width algorithms of the six configs of the UAMT / ICT / SS-Net /
Swin-MAE slice, loads neither ``jax`` nor the JAX package; the kernel wrappers take their plain versions
for CPU tensors (their launch counters stay 0), and a tensor on neither the
CPU nor a CUDA device is refused instead of falling back. The algorithms
run on the card unless the caller asks for the CPU: without a card their
default raises.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from hpfg_tpu_torch.ops import bn_act as tba
from hpfg_tpu_torch.ops import conv_block as tcb
from hpfg_tpu_torch.ops import window_attention as twa
from hpfg_tpu_torch.train import algorithms as talgos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STEP = r"""
import json, sys
import numpy as np
import torch
import hpfg_tpu_torch
import hpfg_tpu_torch.evals.volume, hpfg_tpu_torch.run
import hpfg_tpu_torch.train.trainer, hpfg_tpu_torch.utils.jax_weights
from hpfg_tpu_torch.ops import bn_act, conv_block
from hpfg_tpu_torch.train.algorithms import build_algorithm

cfg = dict(model="unet", feature_chns=[8] * 5, num_classes=4, in_channels=1,
           train_crop_size=[16, 16], batch_size=1, unlabel_batch_size=1,
           seed=0, total_itrs=10, step_size=5, opt="sgd", lr=0.01,
           weight_decay=1e-4, momentum=0.9, sched="medical")
algo = build_algorithm("mean_teacher", cfg, dtype=torch.float32,
                       device="cpu")
rng = np.random.default_rng(0)
m = algo.step({
    "label_img": rng.normal(size=(1, 16, 16, 1)).astype(np.float32),
    "label": rng.integers(0, 4, (1, 16, 16)).astype(np.int32),
    "unlabel_img": rng.normal(size=(1, 16, 16, 1)).astype(np.float32)})
print(json.dumps({
    "loss": float(m["loss"]),
    "jax": sorted(k for k in sys.modules
                  if k == "jax" or k.startswith(("jax.", "jaxlib", "flax"))),
    "hpfg_tpu": sorted(k for k in sys.modules
                       if k == "hpfg_tpu" or k.startswith("hpfg_tpu.")),
    "launches": [conv_block.conv3x3_nhwc.launches,
                 conv_block.conv3x3_wgrad_nhwc.launches,
                 bn_act.bn_act.launches, bn_act.bn_act_bwd.launches,
                 bn_act.bn_act_dpre.launches,
                 conv_block.conv3x3_pair_nhwc.launches,
                 conv_block.conv3x3_dgrad_pair.launches,
                 conv_block.conv3x3_wgrad_pair.launches,
                 conv_block.conv3x3_dgrad_reduce.launches]}))
"""


def test_port_step_imports_no_jax_and_launches_no_kernel():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _STEP], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] == [] and out["hpfg_tpu"] == []
    assert out["loss"] == out["loss"] and out["loss"] > 0
    assert out["launches"] == [0] * 9


_CLI = r"""
import json, sys
from hpfg_tpu_torch.run import run

root, save = sys.argv[1], sys.argv[2]
common = ["--set", f"data_path={root}", "--set", "device=cpu",
          "--set", "precision=fp32", "--set", "label_num=0.25",
          "--set", "batch_size=2", "--set", "unlabel_batch_size=4",
          "--set", "train_crop_size=[32,32]", "--set", "test_crop_size=[32,32]",
          "--set", "total_itrs=4", "--set", "step_size=2"]
runs = {}
for name, cfg, extra in (
        ("supervised", "configs/unet_30k_224x224_ACDC.yaml",
         ["--set", "feature_chns=[8,8,8,8,8]"]),
        ("mean_teacher", "configs/mean_teacher_unet_30k_224x224_ACDC.yaml",
         ["--set", "feature_chns=[8,8,8,8,8]"]),
        ("cps", "configs/cps_unet_30k_224x224_ACDC.yaml",
         ["--set", "model1.feature_chns=[8,8,8,8,8]",
          "--set", "model2.feature_chns=[8,8,8,8,8]"]),
        ("ctct", "configs/ctct_unet_segformer_30k_224x224_ACDC.yaml",
         ["--set", "model1.feature_chns=[8,8,8,8,8]"]),
        ("hpfg", "configs/hpfg_unet_plus_30k_224x224_ACDC.yaml",
         ["--set", "model1.feature_chns=[8,8,8,8,8]",
          "--set", "model2.feature_chns=[8,8,8,8,8]"]),
        ("s4cvnet", "configs/s4cvnet_unet_30k_224x224_ACDC.yaml",
         ["--set", "model1.feature_chns=[8,8,8,8,8]",
          "--set", "model2.embed_dim=8", "--set", "model2.depths=[2,2]",
          "--set", "model2.num_heads=[1,2]",
          "--set", "model2.window_size=2"])):
    t = run(["--config", cfg, "--set", f"save_path={save}/{name}", *common,
             *extra])
    runs[name] = {"steps": t.algorithm.step_count,
                  "evals": [h["iter"] for h in t.history],
                  "models": sorted(t.history[-1]["results"]),
                  "losses": [m["loss"] for _, m in t.metrics_log]}
print(json.dumps({
    "runs": runs,
    "jax_side": sorted(k for k in sys.modules
                       if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                              "hpfg_tpu"))}))
"""


def test_port_cli_trains_and_evaluates_without_jax(synthetic_acdc, tmp_path):
    """The CLI trains and evaluates 4 iterations of Supervised, of
    Mean-Teacher, of CPS, of CTCT (a B0 SegFormer as model2), of HPFG and of
    S4CVNet (a two-stage SwinUNet of width 8 as model2) in a fresh process;
    no jax, flax or hpfg_tpu module loads."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _CLI, synthetic_acdc, str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax_side"] == []
    assert out["runs"]["supervised"]["models"] == ["model1"]
    assert out["runs"]["mean_teacher"]["models"] == ["model1", "model2"]
    assert out["runs"]["cps"]["models"] == ["model1", "model2"]
    assert out["runs"]["ctct"]["models"] == ["model1", "model2"]
    assert out["runs"]["hpfg"]["models"] == ["ema", "model1", "model2"]
    assert out["runs"]["s4cvnet"]["models"] == ["ema", "model1", "model2"]
    for r in out["runs"].values():
        assert r["steps"] == 4 and r["evals"] == [2, 4]
        assert all(v == v and v > 0 for v in r["losses"])
    with open(tmp_path / "hpfg" / "log.log", encoding="utf-8") as f:
        log = f.read()
    assert "img/s" in log and "done: 4 iters" in log


_CLI_NEW = r"""
import json, sys
import torch
from hpfg_tpu_torch.config import parse_config
from hpfg_tpu_torch.run import run
from hpfg_tpu_torch.train.algorithms import build_algorithm

root, save = sys.argv[1], sys.argv[2]
common = ["--set", f"data_path={root}", "--set", "device=cpu",
          "--set", "precision=fp32", "--set", "label_num=0.25",
          "--set", "batch_size=2", "--set", "unlabel_batch_size=4",
          "--set", "train_crop_size=[32,32]", "--set", "test_crop_size=[32,32]",
          "--set", "total_itrs=4", "--set", "step_size=2"]
unet = ["--set", "feature_chns=[8,8,8,8,8]"]
runs = {}
for name, cfg, extra in (
        ("uamt", "configs/uncertainty_aware_unet_30k_224x224_ACDC.yaml",
         unet),
        ("ict", "configs/ict-medseg_unet_30k_224x224_ACDC.yaml", unet),
        ("ssnet", "configs/ssnet_unet_30k_224x224_ACDC.yaml", unet),
        ("swin_mae", "configs/swinmae_30k_224x224_ACDC.yaml",
         ["--set", "embed_dim=8", "--set", "decoder_embed_dim=16",
          "--set", "depths=[2,2]", "--set", "num_heads=[1,2]",
          "--set", "window_size=2"])):
    t = run(["--config", cfg, "--set", f"save_path={save}/{name}", *common,
             *extra])
    runs[name] = {"steps": t.algorithm.step_count,
                  "evals": [h["iter"] for h in t.history],
                  "models": sorted(t.history[-1]["results"]),
                  "losses": [m["loss"] for _, m in t.metrics_log]}
built = {}
for cfg in ("uncertainty_aware_unet_30k", "ict-medseg_unet_30k",
            "ict-medseg_unet_100_30k", "scs_unet_30k", "ssnet_unet_30k",
            "swinmae_30k"):
    c = parse_config("t", "", ["--config",
                               f"configs/{cfg}_224x224_ACDC.yaml"])
    algo = build_algorithm(c["algorithm"], c, dtype=torch.bfloat16,
                           device="cpu")
    built[cfg] = [type(algo).__name__, type(algo.model).__name__,
                  sum(p.numel() for p in algo.model.parameters())]
print(json.dumps({
    "runs": runs, "built": built,
    "jax_side": sorted(k for k in sys.modules
                       if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                              "hpfg_tpu"))}))
"""


def test_port_cli_trains_uamt_ict_ssnet_swin_mae_without_jax(
        synthetic_acdc, tmp_path):
    """The CLI trains and evaluates 4 iterations of UAMT, ICT-MedSeg and
    SS-Net (UNets of width 8) and of Swin-MAE (two stages of width 8, no
    dice evaluation), and the six configs' full-width algorithms parse and
    build, in a fresh process; no jax, flax or hpfg_tpu module loads."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_NEW, synthetic_acdc, str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax_side"] == []
    assert out["runs"]["uamt"]["models"] == ["model1", "model2"]
    assert out["runs"]["ict"]["models"] == ["model1", "model2"]
    assert out["runs"]["ssnet"]["models"] == ["model1"]
    assert out["runs"]["swin_mae"]["models"] == []
    for r in out["runs"].values():
        assert r["steps"] == 4 and r["evals"] == [2, 4]
        assert all(v == v and v > 0 for v in r["losses"])
    built = out["built"]
    assert built["uncertainty_aware_unet_30k"][:2] == ["UAMT", "UNet"]
    for cfg in ("ict-medseg_unet_30k", "ict-medseg_unet_100_30k",
                "scs_unet_30k"):
        assert built[cfg][:2] == ["ICTMedSeg", "UNet"]
    assert built["ssnet_unet_30k"][:2] == ["SSNetAlgorithm", "SSNet"]
    assert built["swinmae_30k"][:2] == ["SwinMAEPretrain", "SwinMAE"]
    assert built["uncertainty_aware_unet_30k"][2] == \
        built["scs_unet_30k"][2] < built["ssnet_unet_30k"][2]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


_WRAPPERS = (tcb.conv3x3_nhwc, tcb.conv3x3_wgrad_nhwc, tba.bn_act,
             tba.bn_act_bwd, tba.bn_act_dpre, tcb.conv3x3_pair_nhwc,
             tcb.conv3x3_dgrad_pair, tcb.conv3x3_wgrad_pair,
             tcb.conv3x3_dgrad_reduce, twa.window_attention_fwd,
             twa.window_attention_bwd)


@pytest.mark.parametrize("call", [
    lambda: tcb.conv3x3_nhwc(_meta(1, 8, 8, 4), _meta(3, 3, 4, 8)),
    lambda: tcb.conv3x3_wgrad_nhwc(_meta(1, 8, 8, 4), _meta(1, 8, 8, 8)),
    lambda: tba.bn_act(_meta(1, 8, 8, 8), _meta(8), _meta(8)),
    lambda: tba.bn_act_bwd(*(_meta(1, 8, 8, 8),) * 2, *(_meta(8),) * 4),
    lambda: tba.bn_act_dpre(*(_meta(1, 8, 8, 8),) * 2, *(_meta(8),) * 4,
                            _meta(2, 8)),
    lambda: tcb.conv3x3_pair_nhwc(_meta(1, 8, 8, 4), _meta(1, 8, 8, 4),
                                  _meta(3, 3, 8, 8)),
    lambda: tcb.conv3x3_dgrad_pair(_meta(1, 8, 8, 8), _meta(3, 3, 8, 12), 4),
    lambda: tcb.conv3x3_wgrad_pair(_meta(1, 8, 8, 4), _meta(1, 8, 8, 4),
                                   _meta(1, 8, 8, 8)),
    lambda: tcb.conv3x3_dgrad_reduce(_meta(1, 8, 8, 8), _meta(3, 3, 8, 4),
                                     _meta(1, 8, 8, 4), *(_meta(4),) * 4),
    lambda: twa.window_attention_fwd(_meta(4, 9, 24), _meta(2, 9, 9), None,
                                     2),
    lambda: twa.window_attention_bwd(_meta(4, 9, 24), _meta(2, 9, 9),
                                     _meta(2, 9, 9), _meta(4, 9, 8), 2),
], ids=["conv3x3", "wgrad", "bn_act", "bn_act_bwd", "bn_act_dpre",
        "pair_fwd", "dgrad_pair", "wgrad_pair", "dgrad_reduce",
        "attention_fwd", "attention_bwd"])
def test_wrappers_refuse_non_cuda_devices(call):
    before = [fn.launches for fn in _WRAPPERS]
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert [fn.launches for fn in _WRAPPERS] == before


_TINY_CFG = dict(
    num_classes=4, in_channels=1, train_crop_size=[16, 16], batch_size=1,
    unlabel_batch_size=1, seed=0, total_itrs=10, step_size=5,
    model="unet", feature_chns=[8] * 5, opt="sgd", lr=0.01, sched="medical",
    model1=dict(model="unet", feature_chns=[8] * 5, opt="sgd", lr=0.01),
    model2=dict(model="unet", feature_chns=[8] * 5, opt="sgd", lr=0.01))


@pytest.mark.parametrize("name", ["supervised", "mean_teacher", "cps",
                                  "ctct", "hpfg", "s4cvnet", "uamt", "ict",
                                  "ssnet", "swin_mae"])
def test_algorithms_default_to_the_card(name, monkeypatch):
    """Every constructor defaults to ``device="cuda"``; without a card the
    default raises and asks for ``device="cpu"``, it never builds on the
    CPU by itself."""
    import inspect

    from hpfg_tpu_torch.train.algorithms.base import Algorithm
    from hpfg_tpu_torch.train.algorithms.dual import DualAlgorithm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        talgos.build_algorithm(name, _TINY_CFG)
    for c in (talgos.ALGORITHMS[name], DualAlgorithm, Algorithm):
        assert inspect.signature(c.__init__).parameters["device"].default \
            == "cuda", c
