"""The port stands apart from JAX: importing ``hpfg_tpu_torch`` and running
one tiny Mean-Teacher step on the CPU, or its CLI's training and evaluation
of Supervised, Mean-Teacher, CPS, CTCT, HPFG, S4CVNet, UAMT, ICT-MedSeg,
SS-Net and Swin-MAE on a synthetic ACDC tree and of Mean-Teacher and HPFG
on synthetic LIDC and ISIC trees, or parsing and building the full-width
algorithms of the six configs of the UAMT / ICT / SS-Net / Swin-MAE slice
and of the 15 LIDC / ISIC / Synapse / Building configs, loads neither
``jax`` nor the JAX package; the kernel wrappers take their plain versions
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


#: the LIDC, ISIC, Synapse and Building configs the port trains (all but
#: transunet_30k_96x96_LIDC, whose model is not ported)
CONFIGS_2D = (
    "ccnet_unet_30k_96x96_LIDC", "cps_unet_30k_96x96_LIDC",
    "mean_teacher_unet_30k_96x96_LIDC", "swinunet_30k_96x96_LIDC",
    "unet_30k_96x96_LIDC", "ccnet_unet_30k_224x224_ISIC",
    "ccnet_unet_30k_pretrain_100%_224x224_ISIC", "cps_unet_30k_224x224_ISIC",
    "ict-medseg_unet_30k_224x224_ISIC", "mean_teacher_unet_30k_224x224_ISIC",
    "unet_30k_224x224_ISIC", "ict-medseg_unet_30k_224x224_Synapse",
    "unet_30k_224x224_Synapse", "ccnet_segformer_80k_100%_512x512_Building",
    "ccnet_unet_80k_100%_512x512_Building")

_CLI_2D = r"""
import json, sys
import torch
from hpfg_tpu_torch.config import parse_config
from hpfg_tpu_torch.run import run
from hpfg_tpu_torch.train.algorithms import build_algorithm

lidc, isic, save = sys.argv[1:4]
common = ["--set", "device=cpu", "--set", "precision=fp32",
          "--set", "label_num=0.25", "--set", "batch_size=2",
          "--set", "unlabel_batch_size=4", "--set", "train_crop_size=[32,32]",
          "--set", "test_crop_size=[32,32]", "--set", "total_itrs=4",
          "--set", "step_size=2", "--set", "feature_chns=[8,8,8,8,8]"]
runs = {}
for name, cfg, root in (
        ("lidc", "configs/mean_teacher_unet_30k_96x96_LIDC.yaml", lidc),
        ("isic", "configs/ccnet_unet_30k_224x224_ISIC.yaml", isic)):
    t = run(["--config", cfg, "--set", f"data_path={root}",
             "--set", f"save_path={save}/{name}", *common])
    runs[name] = {"steps": t.algorithm.step_count,
                  "evals": [h["iter"] for h in t.history],
                  "models": sorted(t.history[-1]["results"])}
built = {}
for cfg in sys.argv[4:]:
    c = parse_config("t", "", ["--config", f"configs/{cfg}.yaml"])
    algo = build_algorithm(c["algorithm"], c, dtype=torch.bfloat16,
                           device="cpu")
    models = [getattr(algo, k) for k in ("model", "model1", "model2")
              if hasattr(algo, k)]
    built[cfg] = [type(algo).__name__, [type(m).__name__ for m in models],
                  [m.encoder.in_conv.conv1.kernel.shape[2]
                   if hasattr(m.encoder, "in_conv") else None
                   for m in models]]
print(json.dumps({
    "runs": runs, "built": built,
    "jax_side": sorted(k for k in sys.modules
                       if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                              "hpfg_tpu"))}))
"""


def test_port_cli_trains_lidc_and_isic_and_builds_the_2d_configs(tmp_path):
    """The CLI trains and evaluates 4 iterations of Mean-Teacher on a 32^2
    LIDC tree and of HPFG (the flat ccnet schema) on a 32^2 ISIC tree
    (UNets of width 8; the log shows each eval's dice and ``done: 4
    iters``), and the algorithms of the 15 LIDC / ISIC / Synapse /
    Building configs the port trains parse and build at full width, in a
    fresh process; no jax, flax or hpfg_tpu module loads."""
    from hpfg_tpu.data.synthetic import make_synthetic_isic, make_synthetic_lidc

    lidc = make_synthetic_lidc(str(tmp_path / "lidc"), n=24, hw=(32, 32))
    isic = make_synthetic_isic(str(tmp_path / "isic"), n=24, hw=(32, 32))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_2D, lidc, isic, str(tmp_path),
         *CONFIGS_2D], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax_side"] == []
    assert out["runs"]["lidc"]["models"] == ["model1", "model2"]
    assert out["runs"]["isic"]["models"] == ["ema", "model1", "model2"]
    for name, r in out["runs"].items():
        assert r["steps"] == 4 and r["evals"] == [2, 4]
        with open(tmp_path / name / "log.log", encoding="utf-8") as f:
            log = f.read()
        for it in (2, 4):
            assert f"iter {it} model1 dice" in log, (name, it)
        assert "done: 4 iters" in log
        assert os.path.exists(tmp_path / name / "model" / "last.pt")
    built = out["built"]
    assert sorted(built) == sorted(CONFIGS_2D)
    for cfg, (algo, models, stems) in built.items():
        want_c = 1 if cfg.endswith("Synapse") else 3
        assert all(c in (want_c, None) for c in stems), (cfg, stems)
    assert built["mean_teacher_unet_30k_96x96_LIDC"][:2] == \
        ["MeanTeacher", ["UNetLIDC"]]
    assert built["cps_unet_30k_224x224_ISIC"][1] == ["UNetLIDC", "UNetLIDC"]
    assert built["ccnet_unet_80k_100%_512x512_Building"][1] == ["UNetPlus"]
    assert built["swinunet_30k_96x96_LIDC"][1] == ["SwinUNet"]
    assert built["ccnet_segformer_80k_100%_512x512_Building"][1] == \
        ["SegFormerPlus"]
    assert built["unet_30k_224x224_Synapse"][1] == ["UNet"]


#: every registry name the JAX package's ``build_model`` accepts
REGISTRY = ("unet", "unet_plus", "unet_lidc", "unet_large", "swinunet",
            "swinunet_plus", "swinunet_lidc", "segformer", "segformer_plus",
            "transunet", "transunet_lidc", "cmt", "cmt_plus",
            "uniformer_plus", "resunet", "resunet_plusplus",
            "resunetplusplus", "uctransnet", "ssnet", "swinmae")


def test_every_jax_registry_name_builds_in_the_port():
    """The port's registry holds the names the JAX ``build_model`` builds,
    and each builds on the CPU into the class of the same name (at 224^2,
    the LIDC variants at 96^2, one input channel, 4 classes); the *_plus
    models return the 3-tuple in both packages' lists; an unknown name
    raises in both."""
    from hpfg_tpu.config import Config
    from hpfg_tpu.models import build_model as jax_build_model
    from hpfg_tpu.models import returns_features as jax_features
    from hpfg_tpu_torch.models import MODELS, build_model, returns_features

    assert sorted(MODELS) == sorted(REGISTRY)
    for name in REGISTRY:
        size = 96 if name.endswith("_lidc") else 224
        cfg = dict(model=name, in_channels=1, num_classes=4,
                   train_crop_size=[size, size])
        want = type(jax_build_model(Config(**cfg))).__name__
        assert type(build_model(cfg)).__name__ == want, name
        assert returns_features(name) == jax_features(name), name
    for build, cfg in ((jax_build_model, Config(model="unet3d")),
                       (build_model, {"model": "unet3d"})):
        with pytest.raises(NotImplementedError, match="unet3d"):
            build(cfg)


_ZOO_CONFIGS = r"""
import json, sys
import numpy as np
import torch
from hpfg_tpu_torch.config import parse_config
from hpfg_tpu_torch.train.algorithms import build_algorithm

small = ["--set", "device=cpu", "--set", "precision=fp32",
         "--set", "batch_size=2", "--set", "unlabel_batch_size=4",
         "--set", "train_crop_size=[32,32]", "--set", "test_crop_size=[32,32]"]
rng = np.random.default_rng(0)
built = {}
for cfg in sys.argv[1:]:
    c = parse_config("t", "", ["--config", f"configs/{cfg}.yaml", *small])
    algo = build_algorithm(c["algorithm"], c, dtype=torch.float32,
                           device="cpu")
    ch = int(c["in_channels"])

    def images(n):
        return rng.normal(size=(n, 32, 32, ch)).astype(np.float32)

    def labels(n):
        return rng.integers(0, int(c["num_classes"]),
                            (n, 32, 32)).astype(np.int32)

    if c["algorithm"] == "hpfg":
        batch = {"label_img": images(2), "label": labels(2),
                 "label_img1": images(2), "label1": labels(2),
                 "unlabel_img": images(4)}
    else:
        batch = {"image": images(2), "label": labels(2)}
    loss = float(algo.step(batch)["loss"])
    models = [getattr(algo, k) for k in ("model", "model1", "model2", "ema")
              if hasattr(algo, k)]
    built[cfg] = [type(algo).__name__, [type(m).__name__ for m in models],
                  loss]
print(json.dumps({
    "built": built,
    "jax_side": sorted(k for k in sys.modules
                       if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                              "hpfg_tpu"))}))
"""


def test_port_cli_parses_and_steps_the_zoo_configs_without_jax():
    """The CLI's parser reads configs/ccnet_cmt_30k_224x224_ACDC.yaml,
    ccnet_uniformer_30k_224x224_ACDC.yaml (HPFG, the flat ccnet schema) and
    transunet_30k_96x96_LIDC.yaml (Supervised) with a 32x32 crop, builds
    their full-width algorithms on the CPU and takes one step of each on
    random batches, in a fresh process; no jax, flax or hpfg_tpu module
    loads. (No checkpoint is written: one of TransUNet's, with adamW's
    state, is about 800 MB.)"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    configs = ("ccnet_cmt_30k_224x224_ACDC",
               "ccnet_uniformer_30k_224x224_ACDC",
               "transunet_30k_96x96_LIDC")
    proc = subprocess.run([sys.executable, "-c", _ZOO_CONFIGS, *configs],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax_side"] == []
    built = out["built"]
    assert built["ccnet_cmt_30k_224x224_ACDC"][:2] == ["HPFG",
                                                       ["CMTPlus"] * 3]
    assert built["ccnet_uniformer_30k_224x224_ACDC"][:2] == [
        "HPFG", ["UniformerPlus"] * 3]
    assert built["transunet_30k_96x96_LIDC"][:2] == ["Supervised",
                                                     ["TransUNet"]]
    for name, (_, _, loss) in built.items():
        assert loss == loss and loss > 0, name


def test_profile_kinds_sums_a_step_profile(tmp_path):
    """``scripts/profile_kinds.py`` sums the rows of a ``profile_<path>
    .txt`` (as ``chip_smoke.profile_step`` writes them) by kind."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import profile_kinds
    finally:
        sys.path.pop(0)
    path = tmp_path / "profile_x.txt"
    path.write_text(
        "profile of one x step: ...\n"
        "     3.000 ms  50.0% x10   void at::native::vectorized_elementwise"
        "_kernel<4, at::native::BinaryFunctor<float>>\n"
        "     2.000 ms  33.3% x4    sm90_xmma_fprop_implicit_gemm_bf16bf16\n"
        "     1.000 ms  16.7% x2    nvjet_tst_64x32_64x16_1x4_h_bz_NTT\n",
        encoding="utf-8")
    line = profile_kinds.summarize(str(path))
    assert line.startswith(f"{path}: 6.00 ms; ")
    assert "elementwise and copies 3.00 ms x10 (50.0%)" in line
    assert "cuDNN 2.00 ms x4 (33.3%)" in line
    assert "cuBLAS 1.00 ms x2 (16.7%)" in line
