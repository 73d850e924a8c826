#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``hpfg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and exits non-zero without one. It imports neither jax
nor the JAX package. Phases, each of which fails the run on error:

  1. the card's name and power limit (nvidia-smi), then the build of the
     CUDA kernels from ``hpfg_tpu_torch/csrc`` (nvcc, with its seconds);
  2. every hand-written kernel against its plain PyTorch version on the
     card, at the shapes the full-width UNet gives it (batch 32), in fp32
     and bf16: A conv3x3_nhwc, B conv3x3_wgrad_nhwc, C bn_act, D bn_act_bwd
     (and its dpre-only entry) at every conv shape; K8 conv3x3_pair_nhwc,
     K9 conv3x3_dgrad_pair and K10 conv3x3_wgrad_pair at the four UpBlock
     shapes; K11 conv3x3_dgrad_reduce at every ConvBlock's conv2, with and
     without the encoder's dropout; hash dropout masks bit-exact in fp32
     and bf16; C bitwise equal to its plain version; the statistics, K11's
     sums, D's sums and B's and K10's dW bitwise the same in two runs; each
     row's achieved TFLOP/s and GB/s; then the
     ConvBlock Function's forward and backward (pair inputs for the
     UpBlocks) and Conv3x3Plain. Beside each kernel in bf16: its time, the
     plain version's, and the one PyTorch library call that computes the
     same conv (cuDNN: F.conv2d, conv2d_input, conv2d_weight; for K8 and K10
     on the materialised concat; for K11 the dgrad alone, which does less
     work), and the kernel's bound: the larger of its bytes over 3.35 TB/s
     and its FLOPs over 989 TFLOP/s (H100 SXM bf16 peak);
     A's dgrad into F = 1 at the stem (32 x 224^2 x 16 -> 1) is SS-Net's:
     its VAT differentiates the model with respect to its 1-channel image;
  2b. phase 2's kernel checks again at batch 24, the supervised path's,
     and at ICT's batches 20 (the student) and 12 (each teacher half), at
     the same shapes (every shape those paths give A, B, C, D and K8 to
     K11), in fp32 and bf16, against their plain versions, untimed;
  2c. the window-attention kernels K13 window_attention_fwd and K14
     window_attention_bwd against their plain versions at the four stage
     shapes of the full-width SwinUNet (batch 32), unshifted and shifted,
     with attention dropout (keep 0.9) and without, in fp32 and bf16; the
     attention dropout mask bit-exact in K13's output and K14's dv, in fp32
     and bf16 (Bn 19 and 2048); dbias bitwise the same in two runs. In bf16
     without dropout, beside each: its time, the plain version's,
     F.scaled_dot_product_attention with attn_mask = bias + mask (K13) and
     that call's autograd backward (K14), the bound and the achieved
     TFLOP/s and GB/s; then K13 and K14 again at Swin-MAE's batch 24
     (every window: the masked tokens go through the blocks too), checked
     and timed the same way;
  2d. the kernels at the new paths' geometries, checked and timed as in
     phases 2 and 2c: A to D and K8 to K11 at every conv shape of the
     LIDC Mean-Teacher UNet (96^2, C = 3 stem, F = 2 head, batch 32:
     stages 96 down to 6), the ISIC HPFG UNet_Plus (224^2, C = 3, F = 2,
     batch 40) and the Building UNet_Plus (512^2, C = 3, F = 2, batch 12),
     the Synapse UNet's F = 9 head (224^2, batch 24), and K13 and K14 at
     the four stages of the LIDC SwinUNet (96^2, patch 2, window 3: L = 9,
     shifted by 1; batch 24);
  3. the Mean-Teacher main path through ``Trainer.fit`` with the values of
     configs/mean_teacher_unet_30k_224x224_ACDC.yaml (full-width UNet,
     224^2, 8 labelled + 24 unlabelled images, bf16) on numpy-made batches
     in the ACDC layout, 2 warm-up and 5 timed steps, with ``F.conv2d`` /
     ``torch.conv2d`` patched to raise; the launch counters must rise by
     what the model's structure predicts; one more step traced (device
     busy time, the conv kernels' and C's and D's time, and the count of
     device kernels, copies and memsets in the step);
  3b. the HPFG main path the same way, with the values of
     configs/hpfg_unet_plus_30k_224x224_ACDC.yaml (two full-width UNet_Plus
     students and the EMA teacher: three forwards and two backwards a step);
  3c. the S4CVNet main path the same way, with the values of
     configs/s4cvnet_unet_30k_224x224_ACDC.yaml: model1 a full-width UNet
     (one forward, one backward), model2 a full-width SwinUNet (embed 96,
     depths 2/2/6/2, heads 3/6/12/24, window 7, drop 0.1, attention drop
     0.1, drop path 0.2) and its EMA teacher; F.scaled_dot_product_attention
     is patched to raise as well; one K13 per WindowAttention of model2 and
     of the teacher and one K14 per WindowAttention of model2, a step;
  3d. the Supervised path, with the values of configs/unet_30k_224x224_ACDC
     .yaml: one full-width UNet, 24 labelled images a step, one forward and
     one backward;
  3e. the CPS path, with configs/cps_unet_30k_224x224_ACDC.yaml: two
     full-width UNets on 8 + 24 images, two forwards and two backwards;
  3f. the CTCT path, with configs/ctct_unet_segformer_30k_224x224_ACDC.yaml:
     a full-width UNet (one forward, one backward, SGD) and a SegFormer B0
     (adamW) on 8 + 24 images. The SegFormer's convs are cuDNN: F.conv2d is
     allowed while model2's forward runs (a flag set and cleared by forward
     hooks) and nowhere else, so the UNet still reaches none;
  3g. the UAMT path, with configs/uncertainty_aware_unet_30k_224x224_ACDC
     .yaml: a full-width UNet and its EMA teacher on 8 + 24 images; the
     teacher's noisy target pass and its 8 Monte-Carlo passes (no folding)
     at batch 24 and the student's forward at 32, one backward;
  3h. the ICT path, with configs/ict-medseg_unet_30k_224x224_ACDC.yaml: the
     student forwards 8 labelled + 12 mixed images, the teacher each
     unlabelled half (12 + 12), one backward;
  3i. the SS-Net path, with configs/ssnet_unet_30k_224x224_ACDC.yaml: the
     full-width SSNet on 8 + 24 images, four forwards (the main one and
     VAT's clean, inner and final passes) and three backward graphs: the
     inner one to VAT's direction alone (frozen weights: no B, no K10, and
     the stem's input gradient, A into F = 1), the outer one through the
     main and final passes; its heads and the memory bank in plain torch;
  3j. the Swin-MAE path, with configs/swinmae_30k_224x224_ACDC.yaml: the
     full-width Swin-MAE (embed 96, depths 2/2/2/2, heads 3/6/12/24, window
     7, decoder embed 768) on 24 images, one K13 and one K14 per
     WindowAttention (14) a step, no conv kernel;
  3k. the LIDC Mean-Teacher path, configs/mean_teacher_unet_30k_96x96_LIDC
     .yaml: the full-width unet_lidc (C = 3, F = 2) at 96^2 on 8 + 24
     RGB images;
  3l. the ISIC HPFG path, configs/ccnet_unet_30k_224x224_ISIC.yaml (the
     flat ccnet schema): two UNet_Plus students and the EMA teacher at
     224^2 on 8 + 32 RGB images, CutMix on RGB;
  3m. the Synapse Supervised path, configs/unet_30k_224x224_Synapse.yaml:
     the UNet with an F = 9 head on 24 images;
  3n. the Building Supervised path, configs/ccnet_unet_80k_100%_512x512
     _Building.yaml: a UNet_Plus at 512^2 on 12 RGB images;
  3o. the LIDC SwinUNet path, configs/swinunet_30k_96x96_LIDC.yaml: the
     swinunet_lidc (patch 2, window 3) on 24 RGB images, one K13 and one
     K14 per WindowAttention a step, no conv kernel;
  3p. the CMT HPFG path, configs/ccnet_cmt_30k_224x224_ACDC.yaml (the flat
     ccnet schema): two CMT_Plus students and the EMA teacher at 224^2 on
     8 + 24 images, adamW; 3q. the UniFormer HPFG path,
     configs/ccnet_uniformer_30k_224x224_ACDC.yaml, the same on
     UniFormer_Plus with DropPath 0.1 on; 3r. the TransUNet path,
     configs/transunet_30k_96x96_LIDC.yaml: Supervised transunet_lidc on
     24 RGB images at 96^2. These models run none of the port's kernels
     (their convs are cuDNN, F.conv2d allowed inside their forwards; SDPA
     stays forbidden): every counter must stay 0. Their eval (phase 4)
     holds the card's bf16 model against a CPU copy in fp32;
  4. eval-mode forwards through the kernels against the same models on
     the CPU in the same dtype (plain versions): one synthetic volume
     through the UNet's, UNet_Plus's, the SwinUNet's, the SegFormer's and
     SSNet's ``val``; for Synapse two volumes through ``evaluate_volumes``
     with the cubic zoom (order 3) its eval uses; for the LIDC, ISIC and
     Building paths image batches through ``evaluate_images``, the last
     batch smaller than the others, as a loader that keeps its last batch
     gives it;
  5. resume on the CTCT and SS-Net paths: two steps through Trainer.fit,
     one ``save("last")`` timed on the host, a fresh algorithm (another
     seed) and Trainer restored from it: every tensor and generator state
     (SS-Net's memory bank included) bitwise equal to the checkpoint, and
     the next step's loss bitwise equal to that of the run that was not
     interrupted, on the same batch;
  6. the Swin-MAE -> SwinUNet encoder transfer: two Swin-MAE steps and
     ``save("last")``, then an S4CVNet Trainer built with ``pretrain_ckpt``
     pointing there: every transferred tensor of model2 and of the EMA
     teacher bitwise equal to the MAE's, and the report's counts those the
     depth mismatch (2/2/2/2 into 2/2/6/2) predicts;
  7. the CLI from files: a synthetic LIDC tree (96^2 PNGs, written by the
     port's ``data/synthetic.py``) in a temporary directory, then
     ``python -m hpfg_tpu_torch.run`` with configs/mean_teacher_unet_30k
     _96x96_LIDC.yaml at full width on the card for 4 iterations with an
     evaluation every 2 (preflight, the PNG loaders, ``evaluate_images``,
     the checkpoint rotation); its log must show both evaluations and
     ``done: 4 iters`` and its ``last.pt`` must exist. The tree and the
     checkpoints are deleted at the end;
  8. the models no config names (``ZOO_MODELS``: cmt, transunet at 224^2,
     unet_large, resunet, resunet_plusplus, uctransnet), each in place of
     the UNet of configs/unet_30k_224x224_ACDC.yaml as ``--set model=``
     would put it: 1 + 2 supervised steps on 24 images at 224^2 in bf16
     (UCTransNet's sigmoid head feeds the loss as in the JAX package),
     finite losses, step time and peak memory, and ``val`` of two images
     against the same weights on the CPU in fp32 (its argmax agreement
     printed, not gated: three steps from a random init leave the classes'
     logits within bf16's rounding of each other at some pixels);
  9. configs/ccnet_transunet_30k_224x224_ACDC.yaml must raise HPFG's
     ValueError at construction (its students are not *_plus models), as
     in the JAX package.

Checkpoint writes are left out of the timed and traced main-path steps (the
trainer's ``save`` is a no-op there); phase 5 times one.

Tolerances, relative to the reference tensor's largest magnitude: fp32
1e-4 (another summation order), bf16 2e-2 (bf16 rounding at other points),
D's sums (fp32 in both dtypes) 1e-4; the whole eval forward in bf16 5e-2, with at least 99% of the argmax
predictions equal. Details go to OUT_DIR.

The last line of stdout is {"ok": true, "device": {...}}; the line before it
lists the kernels with their launch counts on each of the eighteen main
paths and summed over them, errors, times and bounds (at the ACDC paths'
shapes, and in ``at_geometries`` at each new path's).
"""

from __future__ import annotations

import itertools
import json
import os
import re
import subprocess
import sys
import time
from typing import NamedTuple

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
BATCH = 32
HW = 224
WARMUP, STEPS = 2, 5
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MODEL_TOL, MODEL_AGREE = 5e-2, 0.99
MT_CONFIG = "configs/mean_teacher_unet_30k_224x224_ACDC.yaml"
HPFG_CONFIG = "configs/hpfg_unet_plus_30k_224x224_ACDC.yaml"
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

CU = "hpfg_tpu_torch/csrc/conv3x3.cu"
ATTN_CU = "hpfg_tpu_torch/csrc/window_attention.cu"
BN_CU = "hpfg_tpu_torch/csrc/bn_act.cu"
PALLAS = "hpfg_tpu/ops/pallas/conv_block.py"
ATTN_PALLAS = "hpfg_tpu/ops/pallas/window_attention.py"
S4_CONFIG = "configs/s4cvnet_unet_30k_224x224_ACDC.yaml"
SUP_CONFIG = "configs/unet_30k_224x224_ACDC.yaml"
#: the supervised path's batch (Swin-MAE's too; the others run BATCH, or
#: ICT_BATCHES)
SUP_BATCH = 24
CPS_CONFIG = "configs/cps_unet_30k_224x224_ACDC.yaml"
CTCT_CONFIG = "configs/ctct_unet_segformer_30k_224x224_ACDC.yaml"
UAMT_CONFIG = "configs/uncertainty_aware_unet_30k_224x224_ACDC.yaml"
ICT_CONFIG = "configs/ict-medseg_unet_30k_224x224_ACDC.yaml"
SSNET_CONFIG = "configs/ssnet_unet_30k_224x224_ACDC.yaml"
MAE_CONFIG = "configs/swinmae_30k_224x224_ACDC.yaml"
#: ICT's student (8 + 12) and teacher (12) batches
ICT_BATCHES = (20, 12)
#: Swin-MAE's batch, at which K13 and K14 train
MAE_BATCH = 24
LIDC_MT_CONFIG = "configs/mean_teacher_unet_30k_96x96_LIDC.yaml"
ISIC_HPFG_CONFIG = "configs/ccnet_unet_30k_224x224_ISIC.yaml"
SYNAPSE_CONFIG = "configs/unet_30k_224x224_Synapse.yaml"
BUILDING_CONFIG = "configs/ccnet_unet_80k_100%_512x512_Building.yaml"
LIDC_SWIN_CONFIG = "configs/swinunet_30k_96x96_LIDC.yaml"
CMT_CONFIG = "configs/ccnet_cmt_30k_224x224_ACDC.yaml"
UNIFORMER_CONFIG = "configs/ccnet_uniformer_30k_224x224_ACDC.yaml"
TRANSUNET_CONFIG = "configs/transunet_30k_96x96_LIDC.yaml"
#: HPFG on TransUNet: refused at construction in both packages
CCNET_TRANSUNET_CONFIG = "configs/ccnet_transunet_30k_224x224_ACDC.yaml"
#: the models of an HPFG step (two students and the EMA teacher)
TEACHER_DUAL = ("model1", "model2", "ema")
#: the registry names no config names, trained by the zoo phase from
#: SUP_CONFIG with ``model`` overridden
ZOO_MODELS = ("cmt", "transunet", "unet_large", "resunet",
              "resunet_plusplus", "uctransnet")
#: the zoo phase's warm-up and timed steps
ZOO_WARMUP, ZOO_STEPS = 1, 2


class MainPath(NamedTuple):
    """A main path: its config; the UNet whose conv kernels are counted (None
    where no model runs them) and its forwards and backwards a step; the
    models whose window attentions run forwards and backwards a step; the
    models whose forwards may call F.conv2d (cuDNN); the model the eval
    phase checks (None where an earlier path checks the same one); the
    UNet's backwards a step to its input alone, with frozen weights (SS-Net's
    VAT inner gradient). The eval phase holds the card's bf16 model against
    a CPU copy in the same dtype where the path runs kernels (their plain
    versions), else in fp32 (``eval_fp32``)."""
    label: str
    config: str
    unet: str | None
    forwards: int
    backwards: int
    attn_fwd: tuple = ()
    attn_bwd: tuple = ()
    conv2d_model: tuple = ()
    eval_model: str | None = None
    inner_backwards: int = 0

    @property
    def eval_fp32(self) -> bool:
        return not (self.unet or self.attn_fwd)


PATHS = [MainPath("mean_teacher", MT_CONFIG, "model", 2, 1,
                  eval_model="model"),
         MainPath("hpfg", HPFG_CONFIG, "model1", 3, 2, eval_model="model1"),
         MainPath("s4cvnet", S4_CONFIG, "model1", 1, 1, ("model2", "ema"),
                  ("model2",), eval_model="model2"),
         MainPath("supervised", SUP_CONFIG, "model", 1, 1),
         MainPath("cps", CPS_CONFIG, "model1", 2, 2),
         MainPath("ctct", CTCT_CONFIG, "model1", 1, 1,
                  conv2d_model=("model2",), eval_model="model2"),
         MainPath("uamt", UAMT_CONFIG, "model", 10, 1),
         MainPath("ict", ICT_CONFIG, "model", 3, 1),
         MainPath("ssnet", SSNET_CONFIG, "model", 4, 2, eval_model="model",
                  inner_backwards=1),
         MainPath("swin_mae", MAE_CONFIG, None, 0, 0, ("model",),
                  ("model",)),
         MainPath("lidc_mt", LIDC_MT_CONFIG, "model", 2, 1,
                  eval_model="model"),
         MainPath("isic_hpfg", ISIC_HPFG_CONFIG, "model1", 3, 2,
                  eval_model="model1"),
         MainPath("synapse_sup", SYNAPSE_CONFIG, "model", 1, 1,
                  eval_model="model"),
         MainPath("building_sup", BUILDING_CONFIG, "model", 1, 1,
                  eval_model="model"),
         MainPath("lidc_swin", LIDC_SWIN_CONFIG, None, 0, 0, ("model",),
                  ("model",), eval_model="model"),
         MainPath("acdc_cmt_hpfg", CMT_CONFIG, None, 0, 0,
                  conv2d_model=TEACHER_DUAL, eval_model="model1"),
         MainPath("acdc_uniformer_hpfg", UNIFORMER_CONFIG, None, 0, 0,
                  conv2d_model=TEACHER_DUAL, eval_model="model1"),
         MainPath("lidc_transunet", TRANSUNET_CONFIG, None, 0, 0,
                  conv2d_model=("model",), eval_model="model")]
ALL_PATHS = tuple(p.label for p in PATHS)
#: the paths that run the conv kernels (A to D, K8 to K11), and K13 / K14
CONV_PATHS = tuple(p.label for p in PATHS if p.unet)
ATTN_PATHS = tuple(p.label for p in PATHS if p.attn_fwd)
KERNELS = {
    "conv3x3_nhwc": dict(route="cuda", source=CU, replaces=f"{PALLAS}:734",
                         also_replaces=[f"{PALLAS}:785", f"{PALLAS}:1176",
                                        f"{PALLAS}:746"],
                         counters=["conv3x3_nhwc"]),
    "conv3x3_wgrad_nhwc": dict(route="cuda", source=CU,
                               replaces=f"{PALLAS}:1192", also_replaces=[],
                               counters=["conv3x3_wgrad_nhwc"]),
    "bn_act": dict(route="cuda", source=BN_CU, replaces=f"{PALLAS}:810",
                   also_replaces=[], counters=["bn_act"]),
    "bn_act_bwd": dict(route="cuda", source=BN_CU,
                       replaces=f"{PALLAS}:1151",
                       also_replaces=[f"{PALLAS}:1166"],
                       counters=["bn_act_bwd", "bn_act_dpre"]),
    "conv3x3_pair_nhwc": dict(route="cuda", source=CU,
                              replaces=f"{PALLAS}:772", also_replaces=[],
                              counters=["conv3x3_pair_nhwc"]),
    "conv3x3_dgrad_pair": dict(route="cuda", source=CU,
                               replaces=f"{PALLAS}:1364", also_replaces=[],
                               counters=["conv3x3_dgrad_pair"]),
    "conv3x3_wgrad_pair": dict(route="cuda", source=CU,
                               replaces=f"{PALLAS}:1453", also_replaces=[],
                               counters=["conv3x3_wgrad_pair"]),
    "conv3x3_dgrad_reduce": dict(route="cuda", source=CU,
                                 replaces=f"{PALLAS}:1525", also_replaces=[],
                                 counters=["conv3x3_dgrad_reduce"],
                                 library_note="conv2d_input alone: the dgrad"
                                 " without the reduce, less work"),
    "window_attention_fwd": dict(
        route="cuda", source=ATTN_CU, replaces=f"{ATTN_PALLAS}:66",
        also_replaces=[], counters=["window_attention_fwd"],
        paths=ATTN_PATHS,
        library_note="F.scaled_dot_product_attention on [Bn, H, L, D] with "
        "attn_mask = bias + mask"),
    "window_attention_bwd": dict(
        route="cuda", source=ATTN_CU, replaces=f"{ATTN_PALLAS}:153",
        also_replaces=[], counters=["window_attention_bwd"],
        paths=ATTN_PATHS,
        library_note="autograd backward of that SDPA call for q, k, v and "
        "the bias"),
}
_FEATS = (16, 32, 64, 128, 256)
_KEEP = (0.95, 0.9, 0.8, 0.7, 0.5)


def unet_blocks(hw: int, c_in: int) -> list[tuple]:
    """The full-width UNet's ConvBlocks at ``hw`` with a ``c_in`` stem:
    (name, H=W, C in, F out, keep prob); an UpBlock's C is its (skip, up)
    pair, F + F."""
    down = [("in_conv", hw, c_in, 16, _KEEP[0])] + [
        (f"down{i}", hw >> i, _FEATS[i - 1], _FEATS[i], _KEEP[i])
        for i in range(1, 5)]
    up = [(f"up{i}", hw >> (4 - i), 2 * _FEATS[4 - i], _FEATS[4 - i], None)
          for i in range(1, 5)]
    return down + up


def unet_plain(hw: int, f_out: int) -> list[tuple]:
    """Its plain convs: the logits head into ``f_out`` and the UpBlock 1x1
    convs (run as 3x3): (name, H=W, C, F, is 1x1)."""
    return [("head", hw, 16, f_out, False)] + [
        (f"up{i}.1x1", hw >> (5 - i), _FEATS[5 - i], _FEATS[4 - i], True)
        for i in range(1, 5)]


BLOCKS = unet_blocks(HW, 1)
PLAIN = unet_plain(HW, 4)


class Geometry(NamedTuple):
    """The conv shapes of a new path, checked and timed in phase 2d: the
    path's label, its batch, its ConvBlocks and its plain convs."""
    label: str
    batch: int
    blocks: list
    plain: list


GEOMETRIES = [
    Geometry("lidc_mt", 32, unet_blocks(96, 3), unet_plain(96, 2)),
    Geometry("isic_hpfg", 40, unet_blocks(224, 3), unet_plain(224, 2)),
    Geometry("building_sup", 12, unet_blocks(512, 3), unet_plain(512, 2)),
    # the Synapse UNet differs from the ACDC one in its head alone
    Geometry("synapse_sup", 24, [], unet_plain(224, 9)[:1])]


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    HBM bandwidth and the operations over the bf16 peak, and which sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_work(hh, c, f, es, extra_elems=0, w_es=None, batch=BATCH):
    """(FLOPs, bytes) of one SAME 3x3 conv between c and f channels at
    ``batch`` (either direction: a dgrad is the conv from f to c): each
    input read once, each output written once; ``extra_elems`` more
    elements of ``es`` bytes (statistics, a residual); ``w_es``: bytes per
    weight element when it differs from ``es`` (fp32 dW)."""
    pix = batch * hh * hh
    flops = 2 * pix * 9 * c * f
    nbytes = (es * pix * (c + f) + (es if w_es is None else w_es) * 9 * c * f
              + es * extra_elems)
    return flops, nbytes


class Report:
    """Collects comparisons and failures; writes the details to OUT_DIR."""

    def __init__(self):
        self.failures: list[str] = []
        self.rows: list[dict] = []
        #: the new path whose geometry the checks run at (phase 2d), else
        #: None; each row records it
        self.geometry: str | None = None
        os.makedirs(OUT_DIR, exist_ok=True)
        self._log = open(os.path.join(OUT_DIR, "kernels.jsonl"), "w",
                         encoding="utf-8")

    def fail(self, msg: str) -> None:
        self.failures.append(msg)
        print(f"FAIL {msg}", flush=True)

    def compare(self, kernel: str, what: str, dtype: str, got, ref,
                ms=None, plain_ms=None, tol=None, library_ms=None,
                work=None, main=True) -> float:
        """``work``: (FLOPs, bytes) of the timed call; ``main``: the timed
        call is one the main path makes (it enters the kernel's totals)."""
        tol = TOL[dtype] if tol is None else tol
        got, ref = got.float(), ref.float()
        err = (got - ref).abs().max().item()
        scale = max(ref.abs().max().item(), 1e-30)
        rel = err / scale
        row = dict(kernel=kernel, what=what, dtype=dtype, max_abs_err=err,
                   rel_err=rel, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, main=main, geometry=self.geometry)
        if work is not None:
            row["flops"], row["bytes"] = work
            row["bound_ms"], row["bound_by"] = bound(*work)
        self.rows.append(row)
        self._log.write(json.dumps(row) + "\n")
        ok = rel <= tol and got.isfinite().all().item()
        if not ok:
            self.fail(f"{kernel} {what} {dtype}: rel err {rel:.3e} > {tol}")
        return rel

    def close(self):
        self._log.close()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, rounds: int = 3) -> float:
    """ms per call: CUDA events around ``reps`` back-to-back calls after a
    warm-up call, the least of ``rounds`` such rounds."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(rounds):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def times(ms, pms, lms=None):
    return f"{ms:.3f}/{pms:.3f}" + ("" if lms is None else f"/{lms:.3f}")


def perf(ms, pms, lms=None, work=None) -> str:
    """' kernel/plain[/library] ms [rate]' of a timed call; '' untimed."""
    if ms is None:
        return ""
    return f" {times(ms, pms, lms)}ms" + ("" if work is None
                                         else f" {rate(work, ms)}")


def timer(timed: bool):
    """``cuda_ms`` when timing, else a stand-in that times nothing."""
    return cuda_ms if timed else (lambda fn: None)


def rate(work, ms) -> str:
    """Achieved TFLOP/s and GB/s of a timed call beside its bound in ms."""
    b, by = bound(*work)
    return (f"{work[0] / ms / 1e9:.1f} TFLOP/s {work[1] / ms / 1e6:.0f} GB/s "
            f"(bound {b:.3f} ms, {by})")


def same_twice(rep: Report, what: str, fn) -> None:
    """Fail unless two runs of ``fn`` give bitwise equal tensors (sums of
    per-block partials in a fixed order)."""
    import torch

    a, b = fn(), fn()
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        rep.fail(f"{what}: two runs differ")


def nchw(t):  # NHWC storage seen as NCHW (channels_last) for cuDNN
    return t.permute(0, 3, 1, 2)


def oihw(w):
    import torch

    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_hash_masks(rep: Report, dev) -> None:
    """The hash dropout masks, bit-exact: an all-ones input through the
    prologue a=1, b=0 and a centre-tap identity conv outputs the mask
    itself (one product each: in bf16 the fp32 mask rounded to bf16)."""
    import torch

    from hpfg_tpu_torch.ops import conv_block as cb

    for dt, keep in itertools.product((torch.float32, torch.bfloat16),
                                      (0.95, 0.9, 0.8, 0.7, 0.5)):
        for hh, c in ((224, 16), (14, 256)):
            x = torch.ones((4, hh, hh, c), device=dev, dtype=dt)
            eye = torch.zeros((3, 3, c, c), device=dev, dtype=dt)
            eye[1, 1] = torch.eye(c, device=dev, dtype=dt)
            ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            drop = cb.HashDropout(4242 + c, keep)
            ref = cb.hash_mask(drop.seed, 4, hh, hh * c, keep, dev).view(
                4, hh, hh, c).to(dt)
            got_in, _ = cb.conv3x3_nhwc(x, eye, affine=(ones, zeros),
                                        drop=drop)
            got_out, _ = cb.conv3x3_nhwc(x, eye, out_drop=drop)
            for what, got in (("prologue", got_in), ("output", got_out)):
                if not torch.equal(got, ref):
                    rep.fail(f"hash mask ({what}) keep={keep} {hh}x{hh}x{c} "
                             f"{dt}: {(got != ref).sum().item()} elements "
                             f"differ")
    print("hash masks: bit-exact check done (prologue and output masks, "
          "keep 0.95..0.5, float32 and bfloat16)", flush=True)


def check_kernels(rep: Report, dev, batch: int = BATCH,
                  timed: bool = True, blocks=BLOCKS, plain=PLAIN) -> None:
    """Kernels A to D at every distinct conv shape of the UNet's ``blocks``
    and ``plain`` convs at ``batch``; ``timed``: each call timed beside its
    plain version (and in bf16 the library's), and the calls the main path
    makes enter the kernels' totals (the run at BATCH, or that of the new
    path whose geometry ``rep.geometry`` names). The UpBlock conv1 rows
    run A and B over the materialised concat: the main path runs K8 to K10
    there (see check_pair_kernels), so those rows are kept as the
    single-source yardstick and stay out of the kernels' totals, as does
    A's conv2 dgrad (K11 on the main path) and, on a new path, the stem's
    dgrad (only SS-Net's VAT runs it)."""
    import torch
    import torch.nn.functional as F

    from hpfg_tpu_torch.ops import bn_act as ba
    from hpfg_tpu_torch.ops import conv_block as cb

    gen = torch.Generator(device=dev).manual_seed(0)
    clock = timer(timed)
    geometry = rep.geometry
    sfx = (f" {geometry} batch {batch}" if geometry else
           "" if batch == BATCH else f" batch {batch}")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    if timed and geometry is None:
        check_hash_masks(rep, dev)
    print(f"kernel vs plain: rel err (tol float32 {TOL['float32']}, bfloat16 "
          f"{TOL['bfloat16']})" + (" kernel/plain ms" if timed else "") +
          f", batch {batch}" + ("; in bfloat16 a third time: the same conv "
                                "by cuDNN in bf16 with its defaults"
                                if timed else ""), flush=True)

    # one case per distinct conv shape; where an encoder and a decoder conv2
    # share a shape, the encoder's (with dropout) is the one checked
    conv_shapes = {}
    for name, hh, c, f, keep in blocks:
        conv_shapes[(hh, c, f)] = (f"{name}.conv1", None)
        conv_shapes.setdefault((hh, f, f), (f"{name}.conv2", keep or 1.0))
    for name, hh, c, f, _ in plain:
        conv_shapes.setdefault((hh, c, f), (name, None))

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        es = dt.itemsize
        for (hh, c, f), (name, keep) in sorted(conv_shapes.items()):
            x = randn(batch, hh, hh, c).to(dt)
            w = randn(3, 3, c, f, scale=(9 * c) ** -0.5).to(dt)
            bias = randn(f, scale=0.1)
            dp = randn(batch, hh, hh, f).to(dt)
            lib = clock if dt == torch.bfloat16 else (lambda fn: None)
            concat = name.startswith("up") and name.endswith("conv1")
            conv2 = name.endswith("conv2")
            new_stem = geometry is not None and name == "in_conv.conv1"
            line = [f"{dname} {name:>10} {hh:>3}^2 {c:>3}->{f:<3}{sfx}"]
            args = dict(bias=bias, want_stats=True)
            if keep is not None:  # conv2: BN1 + LeakyReLU + dropout prologue
                a, b = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
                args.update(affine=(a, b), drop=(cb.HashDropout(77, keep)
                                                 if keep < 1.0 else None))
            y, st = cb.conv3x3_nhwc(x, w, **args)
            y_r, st_r = cb.conv3x3_reference(x, w, **args)
            ms = clock(lambda: cb.conv3x3_nhwc(x, w, **args))
            pms = clock(lambda: cb.conv3x3_reference(x, w, **args))
            # the conv alone (no prologue, statistics or mask) by cuDNN
            w_c, bias_c = oihw(w), bias.to(dt)
            cms = lib(lambda: F.conv2d(nchw(x), w_c, bias_c, padding=1))
            work = conv_work(hh, c, f, es, 2 * f, batch=batch)
            r1 = rep.compare("conv3x3_nhwc", f"{name} fwd{sfx}", dname, y,
                             y_r, ms, pms, library_ms=cms,
                             main=timed and not concat, work=work)
            r2 = rep.compare("conv3x3_nhwc", f"{name} stats{sfx}", dname, st,
                             st_r)
            same_twice(rep, f"conv3x3_nhwc {name} stats {dname}{sfx}",
                       lambda: (cb.conv3x3_nhwc(x, w, **args)[1],))
            line.append(f"A fwd {max(r1, r2):.1e}{perf(ms, pms, cms, work)}")

            wf = cb.flip_transpose(w)
            odrop = args.get("drop")
            dx, _ = cb.conv3x3_nhwc(dp, wf, out_drop=odrop)
            dx_r, _ = cb.conv3x3_reference(dp, wf, out_drop=odrop)
            ms = clock(lambda: cb.conv3x3_nhwc(dp, wf, out_drop=odrop))
            pms = clock(lambda: cb.conv3x3_reference(dp, wf, out_drop=odrop))
            wf_c = oihw(wf)
            cms = lib(lambda: F.conv2d(nchw(dp), wf_c, padding=1))
            work = conv_work(hh, f, c, es, batch=batch)
            # a conv2's dgrad runs as K11; the stem's (into F = 1) runs in
            # SS-Net's VAT inner gradient
            r = rep.compare("conv3x3_nhwc", f"{name} dgrad{sfx}", dname, dx,
                            dx_r, ms, pms, library_ms=cms,
                            main=timed and not (concat or conv2 or new_stem),
                            work=work)
            line.append(f"A dgrad{f' into F = {c}' if c < 16 else ''} {r:.1e}"
                        f"{perf(ms, pms, cms, work)}")

            wargs = {k: args[k] for k in ("affine", "drop") if k in args}
            dw = cb.conv3x3_wgrad_nhwc(x, dp, **wargs)
            dw_r = cb.conv3x3_wgrad_reference(x, dp, **wargs)
            ms = clock(lambda: cb.conv3x3_wgrad_nhwc(x, dp, **wargs))
            pms = clock(lambda: cb.conv3x3_wgrad_reference(x, dp, **wargs))
            cms = lib(lambda: torch.nn.grad.conv2d_weight(
                nchw(x), (f, c, 3, 3), nchw(dp), padding=1))
            work = conv_work(hh, c, f, es, w_es=4, batch=batch)
            r = rep.compare("conv3x3_wgrad_nhwc", f"{name} wgrad{sfx}", dname,
                            dw, dw_r, ms, pms, library_ms=cms,
                            main=timed and not concat, work=work)
            same_twice(rep, f"conv3x3_wgrad_nhwc {name} {dname}{sfx}",
                       lambda: (cb.conv3x3_wgrad_nhwc(x, dp, **wargs),))
            line.append(f"B {r:.1e}{perf(ms, pms, cms, work)}")

            if keep is not None:  # block output: BN2 + LeakyReLU fwd / bwd
                n = batch * hh * hh * f
                g = randn(batch, hh, hh, f).to(dt)
                a2, b2 = 1.0 + randn(f, scale=0.1), randn(f, scale=0.1)
                y = ba.bn_act(g, a2, b2)
                ms = clock(lambda: ba.bn_act(g, a2, b2))
                pms = clock(lambda: ba.bn_act_reference(g, a2, b2))
                y_r = ba.bn_act_reference(g, a2, b2)
                work = (3 * n, 2 * es * n)
                r = rep.compare("bn_act", f"{name} bn_act{sfx}", dname, y,
                                y_r, ms, pms, work=work, main=timed)
                if not torch.equal(y, y_r):
                    rep.fail(f"bn_act {name} {dname}{sfx}: not bitwise equal "
                             f"to the plain version")
                line.append(f"C {r:.1e} bitwise{perf(ms, pms, work=work)}")
                m, inv = randn(f, scale=0.1), 1.0 + randn(f, scale=0.1).abs()
                s, d = ba.bn_act_bwd(dp, g, a2, b2, m, inv)
                s_r, d_r = ba.bn_act_bwd_reference(dp, g, a2, b2, m, inv)
                ms = clock(lambda: ba.bn_act_bwd(dp, g, a2, b2, m, inv))
                pms = clock(lambda: ba.bn_act_bwd_reference(dp, g, a2, b2,
                                                            m, inv))
                work = (17 * n, 3 * es * n)
                # the sums are fp32 in both dtypes: the fp32 tolerance
                r1 = rep.compare("bn_act_bwd", f"{name} sums{sfx}", dname, s,
                                 s_r, ms, pms, tol=TOL["float32"], work=work,
                                 main=timed)
                r2 = rep.compare("bn_act_bwd", f"{name} dpre{sfx}", dname, d,
                                 d_r)
                same_twice(rep, f"bn_act_bwd {name} sums {dname}{sfx}",
                           lambda: (ba.bn_act_bwd(dp, g, a2, b2, m, inv)[0],))
                line.append(f"D {max(r1, r2):.1e}{perf(ms, pms, work=work)}")
                d = ba.bn_act_dpre(dp, g, a2, b2, m, inv, s_r)
                ms = clock(lambda: ba.bn_act_dpre(dp, g, a2, b2, m, inv, s_r))
                pms = clock(lambda: ba.bn_act_dpre_reference(
                    dp, g, a2, b2, m, inv, s_r))
                work = (9 * n, 3 * es * n)
                r = rep.compare("bn_act_bwd", f"{name} dpre-only{sfx}", dname,
                                d, ba.bn_act_dpre_reference(dp, g, a2, b2, m,
                                                            inv, s_r),
                                ms, pms, work=work, main=timed)
                line.append(f"D dpre {r:.1e}{perf(ms, pms, work=work)}")
            print(" | ".join(line), flush=True)
            del x, w, dp, y, y_r, dx, dx_r
            torch.cuda.empty_cache()


def check_pair_kernels(rep: Report, dev, batch: int = BATCH,
                       timed: bool = True, blocks=BLOCKS) -> None:
    """K8, K9 and K10 at the four UpBlock shapes of ``blocks``, and K11 at
    every ConvBlock's conv2 (the encoder's with and without its dropout),
    against their plain versions at ``batch``; ``timed`` as in
    check_kernels, in bf16 beside the library call that computes the same
    conv."""
    import torch
    import torch.nn.functional as F

    from hpfg_tpu_torch.ops import conv_block as cb

    gen = torch.Generator(device=dev).manual_seed(2)
    clock = timer(timed)
    geometry = rep.geometry
    sfx = (f" {geometry} batch {batch}" if geometry else
           "" if batch == BATCH else f" batch {batch}")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        es = dt.itemsize
        lib = clock if dt == torch.bfloat16 else (lambda fn: None)
        for name, hh, c, f, keep in blocks:
            if not name.startswith("up"):
                continue
            ca = cbh = c // 2
            xa = randn(batch, hh, hh, ca).to(dt)
            xb = randn(batch, hh, hh, cbh).to(dt)
            w = randn(3, 3, c, f, scale=(9 * c) ** -0.5).to(dt)
            bias = randn(f, scale=0.1)
            dp = randn(batch, hh, hh, f).to(dt)
            line = [f"{dname} {name:>6}.conv1 {hh:>3}^2 {ca}+{cbh}->{f}{sfx}"]
            cat = torch.cat([xa, xb], dim=-1)
            w_c = oihw(w)

            def k8():
                return cb.conv3x3_pair_nhwc(xa, xb, w, bias, want_stats=True)

            def k8_plain():
                return cb.conv3x3_pair_reference(xa, xb, w, bias,
                                                 want_stats=True)

            (y, st), (y_r, st_r) = k8(), k8_plain()
            ms, pms = clock(k8), clock(k8_plain)
            lms = lib(lambda: F.conv2d(nchw(cat), w_c, bias.to(dt),
                                       padding=1))
            work = conv_work(hh, c, f, es, 2 * f, batch=batch)
            r = max(rep.compare("conv3x3_pair_nhwc", f"{name} fwd{sfx}",
                                dname, y, y_r, ms, pms, library_ms=lms,
                                work=work, main=timed),
                    rep.compare("conv3x3_pair_nhwc", f"{name} stats{sfx}",
                                dname, st, st_r))
            line.append(f"K8 {r:.1e}{perf(ms, pms, lms, work)}")

            wf = cb.flip_transpose(w)
            got = cb.conv3x3_dgrad_pair(dp, wf, ca)
            ref = cb.conv3x3_dgrad_pair_reference(dp, wf, ca)
            ms = clock(lambda: cb.conv3x3_dgrad_pair(dp, wf, ca))
            pms = clock(lambda: cb.conv3x3_dgrad_pair_reference(dp, wf, ca))
            lms = lib(lambda: torch.nn.grad.conv2d_input(
                (batch, c, hh, hh), w_c, nchw(dp), padding=1))
            work = conv_work(hh, f, c, es, batch=batch)
            r = max(rep.compare("conv3x3_dgrad_pair", f"{name} dx_skip{sfx}",
                                dname, got[0], ref[0], ms, pms,
                                library_ms=lms, work=work, main=timed),
                    rep.compare("conv3x3_dgrad_pair", f"{name} dx_up{sfx}",
                                dname, got[1], ref[1]))
            if not (got[0].is_contiguous() and got[1].is_contiguous()):
                rep.fail(f"conv3x3_dgrad_pair {name}{sfx}: outputs not "
                         f"contiguous")
            line.append(f"K9 {r:.1e}{perf(ms, pms, lms, work)}")

            got = cb.conv3x3_wgrad_pair(xa, xb, dp)
            ref = cb.conv3x3_wgrad_pair_reference(xa, xb, dp)
            ms = clock(lambda: cb.conv3x3_wgrad_pair(xa, xb, dp))
            pms = clock(lambda: cb.conv3x3_wgrad_pair_reference(xa, xb, dp))
            lms = lib(lambda: torch.nn.grad.conv2d_weight(
                nchw(cat), (f, c, 3, 3), nchw(dp), padding=1))
            work = conv_work(hh, c, f, es, w_es=4, batch=batch)
            r = max(rep.compare("conv3x3_wgrad_pair", f"{name} dw_skip{sfx}",
                                dname, got[0], ref[0], ms, pms,
                                library_ms=lms, work=work, main=timed),
                    rep.compare("conv3x3_wgrad_pair", f"{name} dw_up{sfx}",
                                dname, got[1], ref[1]))
            same_twice(rep, f"conv3x3_wgrad_pair {name} {dname}{sfx}",
                       lambda: cb.conv3x3_wgrad_pair(xa, xb, dp))
            line.append(f"K10 {r:.1e}{perf(ms, pms, lms, work)}")
            print(" | ".join(line), flush=True)
            del xa, xb, cat, dp, y, y_r, got, ref
            torch.cuda.empty_cache()

        # the main path's K11 calls: each encoder conv2 dgrad with its
        # dropout, each decoder one (the same shapes) without; the encoder
        # shapes without dropout are checked too
        main_cases = {(hh, f, keep): name for name, hh, _, f, keep in blocks}
        cases = dict(main_cases)
        for name, hh, _, f, keep in blocks:
            cases.setdefault((hh, f, None), name)
        for (hh, f, kp), name in cases.items():
            dp = randn(batch, hh, hh, f).to(dt)
            w2 = randn(3, 3, f, f, scale=(9 * f) ** -0.5).to(dt)
            wf = cb.flip_transpose(w2)
            w2_c = oihw(w2)
            pre = randn(batch, hh, hh, f).to(dt)
            a, b = 1.0 + randn(f, scale=0.1), randn(f, scale=0.1)
            m, inv = randn(f, scale=0.1), 1.0 + randn(f, scale=0.1).abs()
            drop = cb.HashDropout(88, kp) if kp else None

            def k11():
                return cb.conv3x3_dgrad_reduce(dp, wf, pre, a, b, m, inv,
                                               out_drop=drop)

            def k11_plain():
                return cb.conv3x3_dgrad_reduce_reference(
                    dp, wf, pre, a, b, m, inv, out_drop=drop)

            (dd, s), (dd_r, s_r) = k11(), k11_plain()
            ms, pms = clock(k11), clock(k11_plain)
            lms = lib(lambda: torch.nn.grad.conv2d_input(
                (batch, f, hh, hh), w2_c, nchw(dp), padding=1))
            n = batch * hh * hh * f
            flops, nbytes = conv_work(hh, f, f, es, n, batch=batch)
            work = (flops + 8 * n, nbytes)
            what = f"{name}.conv2 {'keep ' + str(kp) if kp else 'no drop'}"
            r = max(rep.compare("conv3x3_dgrad_reduce", f"{what} dd{sfx}",
                                dname, dd, dd_r, ms, pms, library_ms=lms,
                                work=work,
                                main=timed and (hh, f, kp) in main_cases),
                    rep.compare("conv3x3_dgrad_reduce", f"{what} sums{sfx}",
                                dname, s, s_r))
            same_twice(rep, f"conv3x3_dgrad_reduce {what} sums {dname}{sfx}",
                       lambda: (k11()[1],))
            print(f"{dname} {what:>24} {hh:>3}^2 {f}->{f}{sfx}: K11 {r:.1e}"
                  f"{perf(ms, pms, lms, work)}" + (" (library: the dgrad "
                                                   "alone)" if timed else ""),
                  flush=True)
            del dp, pre, dd, dd_r
            torch.cuda.empty_cache()


def attn_work(bn, heads, l, d, es, n_mask, backward):
    """(FLOPs, bytes) of one window-attention call over Bn windows: q, k, v
    (and do) read once, o (or dq, dk, dv and the fp32 dbias) written once,
    the fp32 bias and mask read once; two products of 2 L^2 D FLOPs per
    window and head forward, five backward (the scores again, dv, dp, dq,
    dk)."""
    c = heads * d
    tok = bn * l * c * es
    consts = 4 * heads * l * l + (4 * n_mask * l * l if n_mask else 0)
    flops = (5 if backward else 2) * 2 * bn * heads * l * l * d
    nbytes = (7 * tok + 4 * heads * l * l if backward else 4 * tok) + consts
    return flops, nbytes


# the full-width SwinUNet's window attentions at 224^2, batch BATCH:
# (stage, token side, heads); L = 7^2, D = 32
ATTN_STAGES = [(0, 56, 3), (1, 28, 6), (2, 14, 12), (3, 7, 24)]
ATTN_WS, ATTN_D = 7, 32
# the LIDC SwinUNet's (swinunet_lidc: 96^2, patch 2, window 3: L = 9) at
# its batch of 24
LIDC_ATTN_STAGES = [(0, 48, 3), (1, 24, 6), (2, 12, 12), (3, 6, 24)]
LIDC_WS, LIDC_SWIN_BATCH = 3, 24


def check_attention_kernels(rep: Report, dev, batch: int = BATCH,
                            stages=ATTN_STAGES, ws: int = ATTN_WS) -> None:
    """K13 and K14 against their plain versions at the stage shapes
    ``stages`` (window ``ws``; by default the four of the full-width
    SwinUNet and Swin-MAE) at ``batch``, unshifted and shifted (the
    stage's own shift mask, by ws // 2), with attention dropout at keep
    0.9 and without, in fp32 and bf16; at BATCH also the dropout mask
    bit-exact in both dtypes (q = k = 0, v and do the identity: K13's
    output and K14's dv are then fl(1/L) times the mask, rounded once to
    the dtype); dbias bitwise the same in two runs. In bf16 without
    dropout: the kernel's time, the plain version's, one SDPA call (K13)
    and its autograd backward (K14), the bound and the achieved rates."""
    import torch

    from hpfg_tpu_torch.models.swinunet import _shift_attention_mask
    from hpfg_tpu_torch.ops import window_attention as wa
    from hpfg_tpu_torch.ops.conv_block import HashDropout

    gen = torch.Generator(device=dev).manual_seed(3)
    l = ws * ws
    geometry = rep.geometry
    sfx = (f" {geometry} batch {batch}" if geometry else
           "" if batch == BATCH else f" batch {batch}")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # dropout masks, bit-exact, at Bn multiples of 16 and not
    heads, d = 2, 64
    for dt, bn in itertools.product(
            (torch.float32, torch.bfloat16),
            (19, 2048) if batch == BATCH and geometry is None else ()):
        qkv = torch.zeros((bn, l, 3 * heads * d), device=dev)
        do = torch.zeros((bn, l, heads * d), device=dev)
        for h in range(heads):
            o = 2 * heads * d + h * d
            qkv[:, :, o:o + l] = torch.eye(l, device=dev)
            do[:, :, h * d:h * d + l] = torch.eye(l, device=dev)
        qkv, do = qkv.to(dt), do.to(dt)
        drop = HashDropout(4321 + bn, 0.9)
        zero_bias = torch.zeros((heads, l, l), device=dev)
        out = wa.window_attention_fwd(qkv, zero_bias, None, heads,
                                      drop).view(bn, l, heads, d)
        dv = wa.window_attention_bwd(qkv, zero_bias, None, do, heads,
                                     drop)[0][..., 2 * heads * d:]
        dv = dv.reshape(bn, l, heads, d)
        ref = (wa.attn_drop_mask(drop.seed, bn, heads, l, drop.keep, dev)
               * (torch.tensor(1.0, device=dev) / l)).to(dt)
        # [Bn, L, H, D] -> [Bn, H, i, j]: out[w, i, h, j], dv[w, j, h, i]
        for name, got, perm in (("K13 output", out, (0, 2, 1, 3)),
                                ("K14 dv", dv, (0, 2, 3, 1))):
            if not (torch.equal(got[..., :l].permute(*perm), ref)
                    and not got[..., l:].any()):
                rep.fail(f"attention dropout mask {name} {dt} Bn={bn}: "
                         "not bit-exact")
    if batch == BATCH and geometry is None:
        print("attention dropout masks: bit-exact check done (K13 output and "
              "K14 dv, fp32 and bf16, Bn 19 and 2048, keep 0.9)", flush=True)

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        es = dt.itemsize
        bf16 = dt == torch.bfloat16
        for stage, side, heads in stages:
            nw = (side // ws) ** 2
            bn, c = batch * nw, heads * ATTN_D
            qkv = randn(bn, l, 3 * c).to(dt)
            bias = randn(heads, l, l, scale=0.02)
            do = randn(bn, l, c).to(dt)
            q, k, v = qkv.split(c, dim=-1)
            smask = torch.from_numpy(_shift_attention_mask(
                side, side, ws, ws // 2)).to(dev)
            for mask in (None, smask):
                what = (f"stage {stage} "
                        f"{'unshifted' if mask is None else 'shifted'}{sfx}")
                n_mask = 0 if mask is None else mask.shape[0]
                line = [f"{dname} attention {what:>17} Bn={bn} H={heads} "
                        f"L={l}"]
                for drop in (None, HashDropout(55 + stage, 0.9)):
                    tag = "keep 0.9" if drop else "no drop"

                    def fwd():
                        return wa.window_attention_fwd(qkv, bias, mask,
                                                       heads, drop)

                    def fwd_plain():
                        return wa.window_attention_reference(
                            q, k, v, bias, mask, heads, drop)

                    def bwd():
                        return wa.window_attention_bwd(qkv, bias, mask, do,
                                                       heads, drop)

                    def bwd_plain():
                        return wa.window_attention_bwd_reference(
                            q, k, v, bias, mask, do, heads, drop)

                    # timed in bf16 without dropout, where SDPA computes
                    # the same function
                    timed = bf16 and drop is None
                    ms = pms = lms = bms = bpms = blms = None
                    if timed:
                        ms, pms = cuda_ms(fwd), cuda_ms(fwd_plain)
                        bms, bpms = cuda_ms(bwd), cuda_ms(bwd_plain)
                        lms, blms = sdpa_ms(q, k, v, bias, mask, do, heads)
                    r = rep.compare("window_attention_fwd", f"{what} {tag}",
                                    dname, fwd(), fwd_plain(), ms, pms,
                                    library_ms=lms, main=timed,
                                    work=attn_work(bn, heads, l, ATTN_D, es,
                                                   n_mask, False))
                    (dqkv, dbias), (*ref, dbias_r) = bwd(), bwd_plain()
                    got = dict(zip(("dq", "dk", "dv"), dqkv.split(c, -1)),
                               dbias=dbias)
                    want = dict(zip(("dq", "dk", "dv"), ref), dbias=dbias_r)
                    # the timed call's numbers go on its dbias row
                    rb = max(rep.compare(
                        "window_attention_bwd", f"{what} {tag} {g}", dname,
                        got[g], want[g], *((bms, bpms) if g == "dbias"
                                           else (None, None)),
                        library_ms=blms if g == "dbias" else None,
                        main=timed and g == "dbias",
                        work=(attn_work(bn, heads, l, ATTN_D, es, n_mask,
                                        True) if g == "dbias" else None))
                        for g in got)
                    if not torch.equal(bwd()[1], dbias):
                        rep.fail(f"window_attention_bwd {what} {tag} "
                                 f"{dname}: dbias differs between two runs")
                    line.append(f"{tag}: K13 {r:.1e} K14 {rb:.1e}" + (
                        f" {times(ms, pms, lms)} / {times(bms, bpms, blms)}ms"
                        if timed else ""))
                    if timed:
                        rates = ("  K13 " + rate(attn_work(
                            bn, heads, l, ATTN_D, es, n_mask, False), ms)
                            + "; K14 " + rate(attn_work(
                                bn, heads, l, ATTN_D, es, n_mask, True), bms))
                print(" | ".join(line), flush=True)
                if bf16:
                    print(rates, flush=True)
            del qkv, do, q, k, v
            torch.cuda.empty_cache()


def sdpa_ms(q, k, v, bias, mask, do, heads):
    """The library yardstick of K13 and K14 in ms: one
    F.scaled_dot_product_attention call on [Bn, H, L, D] with attn_mask =
    bias + mask, and the autograd backward of that call for q, k, v and the
    bias (the attn_mask gradient summed over windows). (None, None) if the
    call fails."""
    import torch
    import torch.nn.functional as F

    bn, l, c = q.shape

    def heads_first(t):
        return t.reshape(bn, l, heads, c // heads).transpose(1, 2).contiguous()

    try:
        qh, kh, vh, doh = (heads_first(t) for t in (q, k, v, do))
        full = bias[None] if mask is None else (
            bias[None] + mask.repeat(bn // mask.shape[0], 1, 1)[:, None])
        am = full.to(q.dtype)
        fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=am))
        leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
        b_leaf = bias.detach().to(q.dtype).requires_grad_(True)
        am_g = b_leaf[None] if mask is None else (
            b_leaf[None] + mask.repeat(bn // mask.shape[0], 1, 1)[:, None]
            .to(q.dtype))
        out = F.scaled_dot_product_attention(*leaves, attn_mask=am_g)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (*leaves, b_leaf), doh, retain_graph=True))
        return fwd_ms, bwd_ms
    except Exception as exc:  # the yardstick is optional, the kernel is not
        print(f"  sdpa yardstick failed: {type(exc).__name__}: {exc}",
              flush=True)
        return None, None


def check_functions(rep: Report, dev) -> None:
    """The ConvBlock Function's forward and backward (block_forward,
    block_backward; a (skip, up) pair for the UpBlocks) and Conv3x3Plain on
    the card (kernels), at every block of the UNet. Forward: fp32 against
    the plain block on the card, bf16 against the same forward on the CPU
    (plain versions, the same bf16 rounding points). Backward: the kernel
    backward and the plain backward (on the CPU) from the SAME forward
    residuals, so both take the same LeakyReLU-derivative branch at every
    element; an autograd reference through its own forward would flip that
    branch wherever its forward differs in the last bit from the kernels'
    near z = 0, and each flip moves the gradients near it by O(1) (a kink,
    not an error)."""
    import torch
    import torch.nn.functional as F

    from hpfg_tpu_torch.ops import conv_block as cb

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def to_cpu(ts):
        return [tuple(u.cpu() for u in t) if isinstance(t, tuple)
                else t.cpu() for t in ts]

    grad_names = ("dx", "dw1", "dscale1", "dbias1", "dw2", "dscale2",
                  "dbias2")
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        for name, hh, c, f, keep in BLOCKS:
            p = [randn(3, 3, c, f, scale=(9 * c) ** -0.5),
                 randn(f, scale=0.1), 1 + randn(f, scale=0.1),
                 randn(f, scale=0.1), randn(3, 3, f, f, scale=(9 * f) ** -0.5),
                 randn(f, scale=0.1), 1 + randn(f, scale=0.1),
                 randn(f, scale=0.1)]
            x = randn(BATCH, hh, hh, c).to(dt)
            dy = randn(BATCH, hh, hh, f).to(dt)
            drop = cb.HashDropout(99, keep) if keep else None
            pair = name.startswith("up")
            xin = (x[..., :c // 2].contiguous(), x[..., c // 2:].contiguous()
                   ) if pair else x
            y, st, res = cb.block_forward(xin, *p, None, True, drop)
            if dt == torch.float32:
                mask = (cb.hash_mask(99, BATCH, hh, hh * f, keep, dev).view(
                    BATCH, hh, hh, f) if keep else None)
                y_r, st_r = cb.conv_block_reference(x, *p, mask=mask)
            else:
                y_r, st_r, _ = cb.block_forward(to_cpu([xin])[0], *to_cpu(p),
                                                None, True, drop)
            worst = max(
                rep.compare("FusedConvBlock", f"{name} y", dname, y,
                            y_r.to(dev)),
                rep.compare("FusedConvBlock", f"{name} stats", dname,
                            torch.cat(list(st)),
                            torch.cat(to_cpu(st_r)).to(dev)))
            args = (p[2], p[3], p[6], p[7])
            grads = cb.block_backward(dy, res, *args, st, drop,
                                      need_dx=c > 1)
            grads_r = cb.block_backward(dy.cpu(), to_cpu(res), *to_cpu(args),
                                        to_cpu(st), drop, need_dx=c > 1)
            for gname, got, ref in zip(grad_names, grads, grads_r):
                if got is None:
                    continue
                pairs = (zip(("_skip", "_up"), got, ref)
                         if isinstance(got, tuple) else [("", got, ref)])
                for sfx, g, r in pairs:
                    worst = max(worst, rep.compare(
                        "FusedConvBlock", f"{name} {gname}{sfx}", dname, g,
                        r.to(dev)))
            print(f"{dname} FusedConvBlock {name:>8} "
                  f"{'(pair) ' if pair else ''}fwd+bwd worst rel "
                  f"{worst:.1e} (tol {TOL[dname]})", flush=True)
            del x, xin, dy, y, y_r, res, grads, grads_r
            torch.cuda.empty_cache()

        for name, hh, c, f, is_1x1 in PLAIN:
            w = randn(3, 3, c, f, scale=(9 * c) ** -0.5)
            if is_1x1:
                w = F.pad(w[1:2, 1:2], (0, 0, 0, 0, 1, 1, 1, 1))
            b = randn(f, scale=0.1)
            x0 = randn(BATCH, hh, hh, c).to(dt)
            dy = randn(BATCH, hh, hh, f).to(dt)
            res = []
            for kernel in (True, False):
                x = x0.clone().requires_grad_(True)
                wt = w.clone().requires_grad_(True)
                bt = b.clone().requires_grad_(True)
                if kernel:
                    y = cb.conv3x3_plain(x, wt, bt)
                else:
                    y = (F.conv2d(x.float().permute(0, 3, 1, 2),
                                  wt.to(dt).float().permute(3, 2, 0, 1),
                                  padding=1).permute(0, 2, 3, 1) + bt)
                (y.float() * dy.float()).sum().backward()
                res.append((y.detach(), x.grad, wt.grad, bt.grad))
            worst = max(rep.compare("Conv3x3Plain", f"{name} {k}", dname,
                                    res[0][i], res[1][i])
                        for i, k in enumerate(("y", "dx", "dw", "db")))
            print(f"{dname} Conv3x3Plain {name:>8} fwd+grads worst rel "
                  f"{worst:.1e} (tol {TOL[dname]})", flush=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------

class ArrayLoader:
    """In-memory stand-in for the BatchLoader: yields (image, label) numpy
    batches; ``cycle`` repeats forever."""

    def __init__(self, images, labels, batch_size):
        self.images, self.labels, self.bs = images, labels, batch_size

    def __iter__(self):
        for i in range(0, len(self.images) - self.bs + 1, self.bs):
            yield self.images[i:i + self.bs], self.labels[i:i + self.bs]

    def cycle(self):
        while True:
            yield from self


def load_config(path: str) -> dict:
    import yaml

    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        return yaml.safe_load(f)


def predicted_launches(model, steps: int, forwards: int, backwards: int,
                       inner_backwards: int = 0) -> dict:
    """Kernel launches per run from the model's structure: ``forwards``
    train-mode forwards, ``backwards`` backwards and ``inner_backwards``
    backwards to the input alone (frozen weights) of ``model`` a step (no
    model: none). A forward runs conv1 (K8 in an UpBlock, else A), conv2
    (A) and C in every ConvBlock, and A for each plain conv (the UpBlock
    1x1s and the head). A backward runs D, K11, B (conv2), D's dpre-only
    entry and conv1's gradients (K9 and K10 in an UpBlock; else A, except
    at the stem, whose input needs no gradient, and B) in every ConvBlock,
    and A and B for each plain conv. A backward to the input runs no B and
    no K10, and A at the stem too (into F = in_channels)."""
    from hpfg_tpu_torch.models.layers import ConvBlock, UpBlock

    if model is None:
        return {k: 0 for k in counters()}
    blocks = sum(isinstance(m, ConvBlock) for m in model.modules())
    pairs = sum(isinstance(m, UpBlock) for m in model.modules())
    plain = pairs + 1
    fwd = {"conv3x3_nhwc": 2 * blocks - pairs + plain,
           "conv3x3_pair_nhwc": pairs, "bn_act": blocks}
    bwd = {"conv3x3_nhwc": blocks - pairs - 1 + plain,
           "conv3x3_wgrad_nhwc": blocks + (blocks - pairs) + plain,
           "bn_act_bwd": blocks, "bn_act_dpre": blocks,
           "conv3x3_dgrad_reduce": blocks, "conv3x3_dgrad_pair": pairs,
           "conv3x3_wgrad_pair": pairs}
    inner = {"conv3x3_nhwc": blocks - pairs + plain, "bn_act_bwd": blocks,
             "bn_act_dpre": blocks, "conv3x3_dgrad_reduce": blocks,
             "conv3x3_dgrad_pair": pairs}
    return {k: steps * (forwards * fwd.get(k, 0) + backwards * bwd.get(k, 0)
                        + inner_backwards * inner.get(k, 0))
            for k in counters()}


def predicted_attention(algo, steps: int, fwd_models, bwd_models) -> dict:
    """K13 and K14 launches per run: one K13 for each WindowAttention of the
    models that forward a step (``fwd_models``), one K14 for each of those
    that also backward (``bwd_models``)."""
    from hpfg_tpu_torch.models.swinunet import WindowAttention

    def n(attr):
        return sum(isinstance(m, WindowAttention)
                   for m in getattr(algo, attr).modules())

    return {"window_attention_fwd": steps * sum(n(a) for a in fwd_models),
            "window_attention_bwd": steps * sum(n(a) for a in bwd_models)}


def counters() -> dict:
    from hpfg_tpu_torch.ops import bn_act as ba
    from hpfg_tpu_torch.ops import conv_block as cb
    from hpfg_tpu_torch.ops import window_attention as wa

    return {"conv3x3_nhwc": cb.conv3x3_nhwc,
            "conv3x3_wgrad_nhwc": cb.conv3x3_wgrad_nhwc,
            "bn_act": ba.bn_act, "bn_act_bwd": ba.bn_act_bwd,
            "bn_act_dpre": ba.bn_act_dpre,
            "conv3x3_pair_nhwc": cb.conv3x3_pair_nhwc,
            "conv3x3_dgrad_pair": cb.conv3x3_dgrad_pair,
            "conv3x3_wgrad_pair": cb.conv3x3_wgrad_pair,
            "conv3x3_dgrad_reduce": cb.conv3x3_dgrad_reduce,
            "window_attention_fwd": wa.window_attention_fwd,
            "window_attention_bwd": wa.window_attention_bwd}


def crop(cfg: dict) -> int:
    return int(cfg["train_crop_size"][0])


def make_loaders(cfg: dict, rng):
    """In-memory loaders of numpy batches at the config's crop, input
    channels and classes (NHWC images, H x W labels), two batches of each
    kind: (labelled, unlabelled, test) for a config with an
    ``unlabel_batch_size``, else (train, test) as the supervised loaders
    give them. Returns (loaders, images a step)."""
    import numpy as np

    hw, c = crop(cfg), int(cfg.get("in_channels", 1))
    lb = int(cfg["batch_size"])
    labelled = ArrayLoader(
        rng.normal(size=(2 * lb, hw, hw, c)).astype(np.float32),
        rng.integers(0, int(cfg.get("num_classes", 4)),
                     (2 * lb, hw, hw)).astype(np.int32), lb)
    if "unlabel_batch_size" not in cfg:
        return (labelled, []), lb
    ub = int(cfg["unlabel_batch_size"])
    unlabelled = ArrayLoader(
        rng.normal(size=(2 * ub, hw, hw, c)).astype(np.float32),
        np.zeros((2 * ub, hw, hw), np.int32), ub)
    return (labelled, unlabelled, []), lb + ub


def build_run(config: str, label: str, dev, **overrides):
    """The config's algorithm on the card in its precision and a Trainer on
    in-memory batches (metrics read once, at the end of each fit);
    ``overrides`` set config keys. Returns (cfg, algorithm, trainer,
    loaders, images a step)."""
    import numpy as np
    import torch

    from hpfg_tpu_torch.train.algorithms import build_algorithm
    from hpfg_tpu_torch.train.trainer import Trainer

    cfg = load_config(config)
    cfg.update(save_path=os.path.join(OUT_DIR, f"run_{label}"), **overrides)
    dtype = torch.bfloat16 if cfg.get("precision") == "bf16" else torch.float32
    loaders, images = make_loaders(cfg, np.random.default_rng(0))
    algo = build_algorithm(cfg["algorithm"], cfg, dtype=dtype, device=dev)
    trainer = Trainer(cfg, algo, loaders=loaders, workdir=cfg["save_path"],
                      log_every=10 ** 6)
    return cfg, algo, trainer, loaders, images


def run_main_path(rep: Report, dev, card: str, path: MainPath):
    """Train ``STEPS`` timed steps (after ``WARMUP``) of the config's
    algorithm through Trainer.fit with SDPA forbidden and F.conv2d allowed
    only inside the forwards of ``path.conv2d_model``, check the losses and
    launch counts, trace one more step. Checkpoint writes are left out
    (``trainer.save`` is a no-op). Returns (launches, algorithm,
    summary)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    label = path.label
    cfg, algo, trainer, _, images = build_run(path.config, label, dev)
    trainer.save = lambda tag: None
    saved = (F.conv2d, torch.conv2d, F.scaled_dot_product_attention)
    in_conv2d_model = []  # non-empty while such a model's forward runs

    def conv2d(*args, **kwargs):
        if in_conv2d_model:
            return saved[0](*args, **kwargs)
        raise RuntimeError("F.conv2d called on the main path outside "
                           f"{path.conv2d_model or 'a model allowed it'}")

    def sdpa(*_a, **_k):
        raise RuntimeError("F.scaled_dot_product_attention called on the "
                           "main path")

    hooks = []
    for name in path.conv2d_model:
        model = getattr(algo, name)
        hooks += [model.register_forward_pre_hook(
                      lambda *_: in_conv2d_model.append(True)),
                  model.register_forward_hook(
                      lambda *_: in_conv2d_model.clear())]
    F.conv2d = torch.conv2d = conv2d
    F.scaled_dot_product_attention = sdpa
    try:
        trainer.total_itrs = WARMUP
        trainer.fit(eval_enabled=False)
        torch.cuda.synchronize()
        for fn in counters().values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.total_itrs = WARMUP + STEPS
        t0 = time.perf_counter()
        trainer.fit(eval_enabled=False)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters().items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        F.conv2d, torch.conv2d, F.scaled_dot_product_attention = saved
        for h in hooks:
            h.remove()
        in_conv2d_model.clear()

    losses = [m["loss"] for _, m in trainer.metrics_log]
    if len(losses) != WARMUP + STEPS or not all(np.isfinite(losses)):
        rep.fail(f"{label} path losses not all finite: {losses}")
    print(f"{label} path: losses {[round(v, 5) for v in losses]}", flush=True)
    expected = predicted_launches(
        getattr(algo, path.unet) if path.unet else None, STEPS,
        path.forwards, path.backwards, path.inner_backwards)
    expected.update(predicted_attention(algo, STEPS, path.attn_fwd,
                                        path.attn_bwd))
    for k, n in launches.items():
        print(f"{label} launches {k}: {n} (predicted {expected[k]} = {STEPS}"
              f" steps x {expected[k] // STEPS})", flush=True)
        if n != expected[k]:
            rep.fail(f"{label} launch count {k}: {n} != predicted "
                     f"{expected[k]}")
    for name, meta in KERNELS.items():
        if (label in meta.get("paths", CONV_PATHS)
                and sum(launches[c] for c in meta["counters"]) == 0):
            rep.fail(f"{label} path: kernel {name} was not launched")
    busy, conv, bn, step_launches = profile_step(trainer, card, label)
    ms = elapsed / STEPS * 1e3
    imgs = images * STEPS / elapsed
    print(f"{label} path: {algo.name} {crop(cfg)}^2 {images} images a step "
          f"{str(algo.dtype).split('.')[-1]}: "
          f"{ms:.2f} ms/step, {imgs:.1f} img/s, peak {peak:.2f} GiB "
          f"allocated ({card})", flush=True)
    summary = dict(ms_per_step=ms, img_per_s=imgs, images_per_step=images,
                   peak_gib=peak, traced_busy_ms=busy, traced_conv_ms=conv,
                   traced_bn_ms=bn, traced_device_launches=step_launches,
                   busy_share=(busy / ms if busy is not None else None))
    return launches, algo, summary


def profile_step(trainer, card: str, label: str):
    """One more step under torch.profiler: device time by kernel name and
    the device's busy share of the step's wall time (profiler on). Returns
    (busy ms, ms of the conv kernels A, B and K8-K11, ms of kernels C and D,
    device kernels, copies and memsets in the step), or Nones when the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer.total_itrs += 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(eval_enabled=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device work only: a range annotation (the optimizer's step) spans
    # kernels that are counted on their own
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print("profile: the profiler saw no device time", flush=True)
        return None, None, None, None
    by_name: dict[str, list] = {}
    for e in kernels:
        row = by_name.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += e.time_range.end - e.time_range.start
    busy = sum(v[1] for v in by_name.values())
    # the port's conv kernels by name (cuDNN's, on the CTCT path's
    # SegFormer, have "wgrad" in theirs too)
    conv = sum(v[1] for k, v in by_name.items()
               if re.search(r"\b(conv3x3|wgrad)(_bf16)?_kernel\b", k))
    bn = sum(v[1] for k, v in by_name.items()
             if any(f"bn_{n}_kernel" in k for n in ("act", "reduce", "dpre")))
    launches = sum(v[0] for v in by_name.values())
    lines = [f"profile of one {label} step ({card}): wall "
             f"{wall_us / 1e3:.2f} ms with the profiler on, device busy "
             f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), conv "
             f"kernels {conv / 1e3:.2f} ms, C and D {bn / 1e3:.3f} ms; "
             f"{launches} device kernels, copies and memsets in the step"]
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {us / 1e3:8.3f} ms {100 * us / busy:5.1f}% "
                     f"x{n:<4} {name[:110]}")
    with open(os.path.join(OUT_DIR, f"profile_{label}.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    prof.export_chrome_trace(os.path.join(OUT_DIR,
                                          f"step_trace_{label}.json"))
    print("\n".join(lines[:25]), flush=True)
    return busy / 1e3, conv / 1e3, bn / 1e3, launches


# ---------------------------------------------------------------------------
# phase 4: eval forward of a volume
# ---------------------------------------------------------------------------

def check_eval(rep: Report, dev, model, label: str, hw: int = HW,
               zoom_order: int = 0, num_classes: int = 4,
               reference=None) -> None:
    """One synthetic volume through ``predict_volume`` (its slices zoomed to
    ``hw`` with ``zoom_order``) and the card's ``val`` logits of the zoomed
    slices against the CPU's (``reference``, else a CPU copy of ``model``);
    with the cubic zoom (Synapse) also two volumes through
    ``evaluate_volumes``, as the trainer evaluates them."""
    import copy

    import numpy as np
    import torch

    from hpfg_tpu_torch.evals.volume import (
        _resize_volume,
        evaluate_volumes,
        predict_volume,
    )

    rng = np.random.default_rng(3)
    volume = rng.normal(size=(4, 256, 216)).astype(np.float32)
    pred = predict_volume(model, volume, (hw, hw), dev, zoom_order)
    if pred.shape != volume.shape:
        rep.fail(f"eval prediction shape {pred.shape} != {volume.shape}")
    x = torch.from_numpy(np.ascontiguousarray(
        _resize_volume(volume, (hw, hw), zoom_order)[..., None]))
    cpu_model = (copy.deepcopy(model).cpu() if reference is None
                 else reference)
    with torch.no_grad():
        logits = model.val(x.to(dev)).cpu()
        ref = cpu_model.val(x)
    rel = rep.compare("eval forward", f"{label} val logits vs CPU plain",
                      "bfloat16", logits, ref, tol=MODEL_TOL)
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"eval {label}: volume {volume.shape} -> pred {pred.shape} (zoom "
          f"order {zoom_order}); logits rel err {rel:.2e} (tol {MODEL_TOL}); "
          f"argmax agreement {agree:.4f} (min {MODEL_AGREE})", flush=True)
    if agree < MODEL_AGREE:
        rep.fail(f"eval {label} argmax agreement {agree:.4f} < "
                 f"{MODEL_AGREE}")
    if zoom_order == 3:
        volumes = [(rng.normal(size=(3, 200, 180)).astype(np.float32),
                    rng.integers(0, num_classes, (3, 200, 180)))
                   for _ in range(2)]
        dice, hd95, per_class = evaluate_volumes(
            model, volumes, num_classes, (hw, hw), dev, zoom_order=3)
        if not (np.isfinite(per_class).all() and 0 <= dice <= 1):
            rep.fail(f"eval {label}: evaluate_volumes gave dice {dice}, "
                     f"hd95 {hd95}")
        print(f"eval {label}: evaluate_volumes over 2 volumes [3, 200, 180] "
              f"(zoom order 3, {num_classes} classes): dice {dice:.4f} hd95 "
              f"{hd95:.4f}", flush=True)


def check_eval_images(rep: Report, dev, model, label: str, hw: int,
                      channels: int, reference=None) -> None:
    """``evaluate_images`` (both forms) on the card and on the CPU (plain
    versions; ``reference``, else a CPU copy of ``model``) over batches of
    2, 2 and 1 image (2 and 1 at 512^2): the last smaller than the others,
    as a loader that keeps its last batch gives it; the card's ``val``
    logits of those batches against the CPU's, within MODEL_TOL, argmax
    agreement at least MODEL_AGREE."""
    import copy

    import numpy as np
    import torch

    from hpfg_tpu_torch.evals.volume import evaluate_images

    rng = np.random.default_rng(4)
    n, bs = (3, 2) if hw >= 512 else (5, 2)
    images = rng.uniform(size=(n, hw, hw, channels)).astype(np.float32)
    labels = np.zeros((n, hw, hw), np.int32)
    labels[:, hw // 4:hw // 2, hw // 3:2 * hw // 3] = 1
    loader = [(images[i:i + bs], labels[i:i + bs]) for i in range(0, n, bs)]
    cpu_model = (copy.deepcopy(model).cpu() if reference is None
                 else reference)
    cpu = torch.device("cpu")
    got = [evaluate_images(model, loader, dev, full) for full in (False, True)]
    want = [evaluate_images(cpu_model, loader, cpu, full)
            for full in (False, True)]
    with torch.no_grad():
        logits = torch.cat([model.val(torch.from_numpy(x).to(dev)).cpu()
                            for x, _ in loader])
        ref = torch.cat([cpu_model.val(torch.from_numpy(x))
                         for x, _ in loader])
    rel = rep.compare("eval forward", f"{label} val logits vs CPU plain",
                      "bfloat16", logits, ref, tol=MODEL_TOL)
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    if not all(np.isfinite(m).all() and 0 <= m[0] <= 1 for m in got):
        rep.fail(f"eval {label}: evaluate_images gave {got}")
    if agree < MODEL_AGREE:
        rep.fail(f"eval {label} argmax agreement {agree:.4f} < "
                 f"{MODEL_AGREE}")
    print(f"eval {label}: evaluate_images over batches "
          f"{[len(x) for x, _ in loader]} of {hw}^2 x {channels}: card "
          f"(dice, hd95) {tuple(round(v, 4) for v in got[0])}, full "
          f"{tuple(round(v, 4) for v in got[1])}; CPU "
          f"{tuple(round(v, 4) for v in want[0])}, full "
          f"{tuple(round(v, 4) for v in want[1])}; logits rel err "
          f"{rel:.2e} (tol {MODEL_TOL}); argmax agreement {agree:.4f} (min "
          f"{MODEL_AGREE})", flush=True)


def fp32_twin(model, cfg: dict):
    """A CPU copy of ``model`` in fp32: the registry's model of ``cfg`` with
    ``model``'s parameters and statistics."""
    import torch

    from hpfg_tpu_torch.models import build_model

    twin = build_model(cfg, dtype=torch.float32)
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return twin


# ---------------------------------------------------------------------------
# phase 5: resume
# ---------------------------------------------------------------------------

def check_resume(rep: Report, dev, card: str, config: str,
                 label: str) -> dict:
    """On the ``label`` path: two steps through Trainer.fit (which saves
    ``last`` at its end), one more ``save("last")`` timed on the host, then
    a fresh algorithm (built from another seed) and Trainer restored from
    it. Every tensor and generator state (SS-Net's memory bank and its
    validity too) must be bitwise equal to the checkpoint, and the next
    step's loss on one batch bitwise equal to the uninterrupted run's: the
    loss is a function of the restored state that backward atomics cannot
    move (SS-Net's holds VAT's input gradient, whose upsample backward is
    the deterministic one). The checkpoints are deleted at the end."""
    import shutil

    import torch

    from hpfg_tpu_torch.train.algorithms import build_algorithm
    from hpfg_tpu_torch.train.trainer import Trainer
    from hpfg_tpu_torch.utils.checkpoint import state_mismatches

    cfg, algo, trainer, loaders, _ = build_run(config, f"resume_{label}",
                                               dev)
    try:
        trainer.total_itrs = 2
        trainer.fit(eval_enabled=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.save("last")
        save_ms = (time.perf_counter() - t0) * 1e3
        path = os.path.join(trainer.ckpt.directory, "last.pt")
        size_mib = os.path.getsize(path) / 2 ** 20
        saved = trainer.ckpt.restore("last")["algorithm"]

        fresh_cfg = dict(cfg, seed=int(cfg["seed"]) + 1)
        fresh = build_algorithm(cfg["algorithm"], fresh_cfg,
                                dtype=algo.dtype, device=dev)
        before = len(state_mismatches(fresh.state_dict(), saved))
        t0 = time.perf_counter()
        Trainer(fresh_cfg, fresh, loaders=loaders,
                workdir=cfg["save_path"]).resume("last", strict=True)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        bad = state_mismatches(fresh.state_dict(), saved)
        if bad or fresh.step_count != 2:
            rep.fail(f"resume ({label}): step {fresh.step_count}, {len(bad)} "
                     f"fields differ from the checkpoint: {bad[:5]}")
        memory = slots = None
        if hasattr(algo, "memory"):  # SS-Net's bank, explicitly
            memory = (torch.equal(fresh.memory, algo.memory)
                      and torch.equal(fresh.memory_valid, algo.memory_valid))
            slots = int(algo.memory_valid.sum())
            if not memory:
                rep.fail(f"resume ({label}): the memory bank differs")
        stream = algo.batches(loaders)
        batch = [next(stream) for _ in range(3)][-1]
        loss = algo.step(batch)["loss"]
        loss_resumed = fresh.step(batch)["loss"]
        same_loss = torch.equal(loss, loss_resumed)
        if not same_loss:
            rep.fail(f"resume ({label}): step 3 loss {loss_resumed.item()!r} "
                     f"after the restore != {loss.item()!r} uninterrupted")
        after = len(state_mismatches(fresh.state_dict(), algo.state_dict()))
        n_fields = sum(1 for _ in _leaves(saved))
    finally:
        shutil.rmtree(cfg["save_path"], ignore_errors=True)
    print(f"resume ({label}): save('last') {save_ms:.1f} ms on the host "
          f"({size_mib:.1f} MiB), restore {restore_ms:.1f} ms ({card}); "
          f"{n_fields} saved leaves, {before} differ before the restore, "
          f"{len(bad)} after" + ("" if memory is None else
                                 f"; memory bank ({slots} valid slots) "
                                 f"bitwise equal: {memory}")
          + f"; step 3 loss {loss.item()!r} resumed "
          f"{loss_resumed.item()!r}: "
          f"{'bitwise equal' if same_loss else 'DIFFER'}; after step 3, "
          f"{after} leaves differ from the uninterrupted run (backward "
          "atomics may move them)", flush=True)
    return dict(save_ms=save_ms, restore_ms=restore_ms, size_mib=size_mib,
                leaves=n_fields, loss_bitwise_equal=same_loss,
                memory_bitwise_equal=memory, memory_valid_slots=slots,
                leaves_differing_after_step=after)


# ---------------------------------------------------------------------------
# phase 6: the Swin-MAE -> SwinUNet encoder transfer
# ---------------------------------------------------------------------------

def predicted_transfer(mae_keys, target_keys) -> dict:
    """The transfer report the depth mismatch predicts, from the keys alone:
    a MAE encoder key ``layer{i}.block{j}.*`` lands where the target's
    stage i has a block j, every other encoder key (``patch_embed.*``, the
    patch merges, the stage norms) where the target has the same key; the
    shapes match (one embed width, head count and window). Returns the
    counts and the target encoder keys left at their init."""
    enc = [k for k in mae_keys if k.startswith("patch_embed.")
           or re.match(r"layer\d+\.", k)]
    targets = {k[len("encoder."):] for k in target_keys
               if k.startswith("encoder.")}
    hit = [k for k in enc if k in targets]
    return {"transferred": len(hit), "skipped_shape": 0,
            "missing_target": len(enc) - len(hit),
            "untouched": sorted(targets - set(hit))}


def check_pretrain(rep: Report, dev, card: str) -> dict:
    """Two Swin-MAE steps through Trainer.fit (``last`` saved at its end),
    then an S4CVNet algorithm and a Trainer built with ``pretrain_ckpt`` on
    that run's checkpoints: the transfer goes into model2 and the EMA
    teacher (the SwinUNets; model1 is a UNet). Every transferred tensor must
    be bitwise equal to the MAE's, the counts those ``predicted_transfer``
    gives, and the target's encoder keys left at their init exactly the
    third stage's blocks 2 to 5 (depths 2/2/2/2 into 2/2/6/2)."""
    import shutil

    import torch

    from hpfg_tpu_torch.utils.pretrain import extract_mae_params

    _, _, mae_trainer, _, _ = build_run(MAE_CONFIG, "pretrain_mae", dev)
    ckpt_dir = mae_trainer.ckpt.directory
    s4_dir = os.path.join(OUT_DIR, "run_pretrain_s4cvnet")
    try:
        mae_trainer.total_itrs = 2
        mae_trainer.fit(eval_enabled=False)
        mae = extract_mae_params(mae_trainer.ckpt.restore("last"))
        t0 = time.perf_counter()
        _, algo, trainer, _, _ = build_run(S4_CONFIG, "pretrain_s4cvnet", dev,
                                           pretrain_ckpt=ckpt_dir)
        build_s = time.perf_counter() - t0
        reports = trainer.pretrain_reports
        if sorted(reports) != ["ema", "model2"]:
            rep.fail(f"pretrain: transferred into {sorted(reports)}, not "
                     "model2 and ema")
        counts = {}
        for name, report in reports.items():
            state = getattr(algo, name).state_dict()
            want = predicted_transfer(list(mae), list(state))
            got = {k: len(v) for k, v in report.items()}
            counts[name] = got
            if got != {k: want[k] for k in got}:
                rep.fail(f"pretrain {name}: report counts {got} != "
                         f"predicted {want}")
            unequal = [k for k in report["transferred"] if not torch.equal(
                state[f"encoder.{k}"],
                mae[k].to(state[f"encoder.{k}"].device))]
            if unequal:
                rep.fail(f"pretrain {name}: {len(unequal)} transferred "
                         f"tensors differ from the MAE's: {unequal[:3]}")
            left = sorted({k[len("encoder."):] for k in state
                           if k.startswith("encoder.")}
                          - set(report["transferred"]))
            stray = [k for k in left
                     if not re.match(r"layer2\.block[2-5]\.", k)]
            if left != want["untouched"] or stray or not left:
                rep.fail(f"pretrain {name}: encoder keys left at init "
                         f"{len(left)}, outside layer2.block2-5: "
                         f"{stray[:3]}")
            print(f"pretrain -> {name}: {got} (predicted "
                  f"{ {k: want[k] for k in got} }), {len(left)} encoder "
                  f"tensors left at init (layer2.block2-5), "
                  f"{len(unequal)} transferred tensors differ", flush=True)
    finally:
        shutil.rmtree(os.path.dirname(ckpt_dir), ignore_errors=True)
        shutil.rmtree(s4_dir, ignore_errors=True)
    print(f"pretrain: S4CVNet algorithm + Trainer with the transfer built in "
          f"{build_s:.1f} s ({card})", flush=True)
    return dict(counts=counts, build_s=build_s)


# ---------------------------------------------------------------------------
# phase 7: the CLI from a data tree
# ---------------------------------------------------------------------------

#: images of the CLI's synthetic LIDC tree: 3/4 train (42: 8 labelled, 34
#: unlabelled at label_num 0.2, enough for batches of 8 and 24), 14 test
CLI_IMAGES = 56
CLI_LINES = ("iter 2 model1 dice", "iter 4 model1 dice", "done: 4 iters")


def check_cli(rep: Report, card: str) -> dict:
    """A synthetic LIDC tree (96^2 PNGs) in a temporary directory, then the
    port's CLI in a subprocess on the card with the unmodified LIDC
    Mean-Teacher config for 4 iterations, evaluating at 2 and 4: its log
    must show both evaluations and ``done: 4 iters``, and ``last.pt`` must
    exist. The tree and the run's checkpoints are deleted at the end."""
    import shutil
    import tempfile

    from hpfg_tpu_torch.data.synthetic import make_synthetic_lidc

    tmp = tempfile.mkdtemp(prefix="hpfg_cli_")
    root, save = os.path.join(tmp, "lidc"), os.path.join(tmp, "run")
    try:
        t0 = time.perf_counter()
        make_synthetic_lidc(root, n=CLI_IMAGES, hw=(96, 96))
        tree_s = time.perf_counter() - t0
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "hpfg_tpu_torch.run", "--config",
             LIDC_MT_CONFIG, "--set", f"data_path={root}", "--set",
             f"save_path={save}", "--set", "total_itrs=4", "--set",
             "step_size=2"], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=600)
        run_s = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        last = os.path.exists(os.path.join(save, "model", "last.pt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    shown = [line for line in log.splitlines()
             if any(k in line for k in ("dice", "done:", "Error", "error"))]
    print(f"cli: tree of {CLI_IMAGES} 96^2 PNG pairs in {tree_s:.1f} s; "
          f"python -m hpfg_tpu_torch.run {LIDC_MT_CONFIG} (4 iters, eval "
          f"every 2) exit {proc.returncode} in {run_s:.1f} s ({card}); "
          f"last.pt {'written' if last else 'MISSING'}", flush=True)
    for line in shown[-12:]:
        print(f"  cli: {line[-160:]}", flush=True)
    missing = [k for k in CLI_LINES if k not in log]
    if proc.returncode != 0 or missing or not last:
        rep.fail(f"cli: exit {proc.returncode}, log lines missing {missing}, "
                 f"last.pt {'found' if last else 'missing'}; log tail: "
                 f"{log[-1500:]}")
    return dict(exit=proc.returncode, run_s=run_s, tree_s=tree_s,
                last_pt=last, lines=shown[-12:])


# ---------------------------------------------------------------------------
# phase 8: the models no config names; phase 9: the config both packages
# refuse
# ---------------------------------------------------------------------------

def check_zoo(rep: Report, dev, card: str, name: str) -> dict:
    """``name`` in place of the UNet of SUP_CONFIG (as ``--set model=``
    would put it): ``ZOO_STEPS`` timed supervised steps after
    ``ZOO_WARMUP`` through Trainer.fit (24 images at 224^2, bf16, F = 4;
    no checkpoint writes), finite losses; the card's ``val`` of two
    images against the same weights on the CPU in fp32, within MODEL_TOL.
    The argmax agreement is printed, not gated: after three steps from a
    random init the classes' logits lie within bf16's rounding of each
    other at a few percent of the pixels (CMT_S: 98.5%)."""
    import numpy as np
    import torch

    cfg, algo, trainer, _, images = build_run(SUP_CONFIG, f"zoo_{name}", dev,
                                              model=name)
    trainer.save = lambda tag: None
    trainer.total_itrs = ZOO_WARMUP
    trainer.fit(eval_enabled=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.total_itrs = ZOO_WARMUP + ZOO_STEPS
    t0 = time.perf_counter()
    trainer.fit(eval_enabled=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / ZOO_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["loss"] for _, m in trainer.metrics_log]
    if len(losses) != ZOO_WARMUP + ZOO_STEPS or not all(np.isfinite(losses)):
        rep.fail(f"zoo {name}: losses not all finite: {losses}")
    model = algo.model
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, crop(cfg), crop(cfg), 1)).astype(np.float32))
    with torch.no_grad():
        got = model.val(x.to(dev)).cpu()
        ref = fp32_twin(model, cfg).val(x)
    rel = rep.compare("eval forward", f"zoo {name} val vs CPU fp32",
                      "bfloat16", got, ref, tol=MODEL_TOL)
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    params = sum(p.numel() for p in model.parameters())
    print(f"zoo {name}: {type(model).__name__} {params / 1e6:.2f} M params, "
          f"{images} images of {crop(cfg)}^2 a step, losses "
          f"{[round(v, 5) for v in losses]}; {ms:.2f} ms/step, "
          f"{images * 1e3 / ms:.1f} img/s, peak {peak:.2f} GiB allocated; "
          f"val vs CPU fp32 rel err {rel:.2e}, argmax agreement {agree:.4f} "
          f"({card})", flush=True)
    return dict(model=type(model).__name__, params=params, losses=losses,
                ms_per_step=ms, img_per_s=images * 1e3 / ms, peak_gib=peak,
                val_rel_err=rel, argmax_agreement=agree)


def check_refused(rep: Report, dev) -> str | None:
    """CCNET_TRANSUNET_CONFIG must raise the ValueError of HPFG's
    construction (its students must be *_plus models), as in the JAX
    package, and build nothing."""
    import torch

    from hpfg_tpu_torch.train.algorithms import build_algorithm

    cfg = load_config(CCNET_TRANSUNET_CONFIG)
    try:
        build_algorithm(cfg["algorithm"], cfg, dtype=torch.bfloat16,
                        device=dev)
    except ValueError as exc:
        print(f"refused: {CCNET_TRANSUNET_CONFIG}: ValueError: {exc}",
              flush=True)
        return str(exc)
    rep.fail(f"{CCNET_TRANSUNET_CONFIG} built an algorithm; it must raise")
    return None


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def kernel_line(rep: Report, paths: dict) -> list[dict]:
    """The per-kernel summary: launches on each main path's timed run and
    their sum over the paths (``launches``), the largest error over every
    check, and the bf16 times and bounds summed over the timed shapes of
    the ACDC main paths, and in ``at_geometries`` over those of each new
    path (phase 2d)."""
    kernels = []
    for name, meta in KERNELS.items():
        rows = [r for r in rep.rows if r["kernel"] == name]
        timed = [r for r in rows if r["ms"] is not None and r["main"]
                 and r["dtype"] == "bfloat16" and r["geometry"] is None]
        t_ops = sum(r["flops"] / BF16_FLOPS_PER_S * 1e3 for r in timed)
        t_bytes = sum(r["bytes"] / HBM_BYTES_PER_S * 1e3 for r in timed)
        lib = [r["library_ms"] for r in timed]
        by_path = {p: sum(launches.get(c, 0) for c in meta["counters"])
                   for p, launches in paths.items()}
        at = {}
        for geo in sorted({r["geometry"] for r in rows} - {None}):
            g = [r for r in rows if r["geometry"] == geo and r["main"]
                 and r["ms"] is not None and r["dtype"] == "bfloat16"]
            if not g:
                continue
            g_lib = [r["library_ms"] for r in g]
            g_ops = sum(r["flops"] / BF16_FLOPS_PER_S for r in g)
            g_bytes = sum(r["bytes"] / HBM_BYTES_PER_S for r in g)
            at[geo] = dict(
                ms=sum(r["ms"] for r in g),
                plain_ms=sum(r["plain_ms"] for r in g),
                bound_ms=sum(r["bound_ms"] for r in g),
                bound_by="bytes" if g_bytes >= g_ops else "operations",
                library_ms=sum(g_lib) if None not in g_lib else None,
                timed_shapes=len(g))
        kernels.append(dict(
            name=name, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], also_replaces=meta["also_replaces"],
            launches=sum(by_path.values()), launches_by_path=by_path,
            paths=[p for p, n in by_path.items() if n],
            max_abs_err=max((r["max_abs_err"] for r in rows), default=None),
            max_rel_err=max((r["rel_err"] for r in rows), default=None),
            ms=sum(r["ms"] for r in timed),
            plain_ms=sum(r["plain_ms"] for r in timed),
            bound_ms=sum(r["bound_ms"] for r in timed),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=(sum(lib) if lib and None not in lib else None),
            **({"library_note": meta["library_note"]}
               if "library_note" in meta else {}),
            timed_shapes=len(timed), at_geometries=at))
    return kernels


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's -Xptxas=-v log: its name
    (with its template arguments), registers, and spill stores/loads."""

    def demangle(sym: str) -> str:
        for i, ch in enumerate(sym):  # <length><name> with name *_kernel
            if not ch.isdigit():
                continue
            j = i
            while j < len(sym) and sym[j].isdigit():
                j += 1
            name = sym[j:j + int(sym[i:j])]
            if name.endswith("_kernel") and name[0].isalpha():
                rest = sym[j + len(name):]
                args = [("float" if rest.startswith("If") else
                         "bf16" if rest.startswith("I13__nv_bfloat16") else
                         "")] + re.findall(r"L[ib](\d+)E",
                                           rest[:rest.find("Ev")])
                args = [a for a in args if a]
                return name + (f"<{', '.join(args)}>" if args else "")
        return sym

    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = demangle(m.group(1))
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {spill}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from hpfg_tpu_torch.ops._cuda import library
        from hpfg_tpu_torch.train.trainer import VOLUME_DATASETS
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rep = Report()
    t_start = time.perf_counter()

    card = nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    lib = library()
    print(f"build: {lib.path.name} in {lib.build_seconds:.1f} s", flush=True)
    for line in ptxas_summary(lib.build_log):
        print(f"  ptxas: {line}")

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            return fn()
        except Exception as exc:  # a phase failure is reported, not fatal
            rep.fail(f"phase {name} raised {type(exc).__name__}: {exc}")
            return None
        finally:
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s",
                  flush=True)

    phase("kernels", lambda: check_kernels(rep, dev))
    phase("pair kernels", lambda: check_pair_kernels(rep, dev))
    # the supervised path's batch and ICT's: every shape again, untimed
    for b in (SUP_BATCH, *ICT_BATCHES):
        phase(f"kernels batch {b}", lambda: check_kernels(
            rep, dev, b, timed=False))
        phase(f"pair kernels batch {b}", lambda: check_pair_kernels(
            rep, dev, b, timed=False))
    phase("attention kernels", lambda: check_attention_kernels(rep, dev))
    phase(f"attention kernels batch {MAE_BATCH}",
          lambda: check_attention_kernels(rep, dev, MAE_BATCH))
    # the new paths' geometries (phase 2d): their rows carry the path's label
    for geo in GEOMETRIES:
        rep.geometry = geo.label
        phase(f"kernels {geo.label}", lambda: check_kernels(
            rep, dev, geo.batch, blocks=geo.blocks, plain=geo.plain))
        phase(f"pair kernels {geo.label}", lambda: check_pair_kernels(
            rep, dev, geo.batch, blocks=geo.blocks))
    rep.geometry = "lidc_swin"
    phase("attention kernels lidc_swin", lambda: check_attention_kernels(
        rep, dev, LIDC_SWIN_BATCH, LIDC_ATTN_STAGES, LIDC_WS))
    rep.geometry = None
    phase("functions", lambda: check_functions(rep, dev))
    paths, summaries = {}, {}
    for path in PATHS:
        out = phase(f"main path {path.label}",
                    lambda: run_main_path(rep, dev, card, path))
        if out is None:
            continue
        # out must not keep this path's algorithm alive into the next path
        # (its peak memory would count it)
        (paths[path.label], algo, summaries[path.label]), out = out, None
        if path.eval_model:  # the model the path adds
            model = getattr(algo, path.eval_model)
            cfg = load_config(path.config)
            what = f"{path.label}.{path.eval_model}"
            ref = fp32_twin(model, cfg) if path.eval_fp32 else None
            if cfg["datasets"] in VOLUME_DATASETS:
                phase(f"eval {path.label}", lambda: check_eval(
                    rep, dev, model, what, crop(cfg),
                    3 if "synapse" in cfg["datasets"] else 0,
                    int(cfg.get("num_classes", 4)), ref))
            else:
                phase(f"eval {path.label}", lambda: check_eval_images(
                    rep, dev, model, what, crop(cfg),
                    int(cfg.get("in_channels", 1)), ref))
            del ref
            del model
        del algo
        torch.cuda.empty_cache()
    resume = {label: phase(f"resume {label}", lambda: check_resume(
        rep, dev, card, config, label))
        for label, config in (("ctct", CTCT_CONFIG), ("ssnet", SSNET_CONFIG))}
    pretrain = phase("pretrain", lambda: check_pretrain(rep, dev, card))
    cli = phase("cli", lambda: check_cli(rep, card))
    zoo = {}
    for name in ZOO_MODELS:
        zoo[name] = phase(f"zoo {name}", lambda: check_zoo(rep, dev, card,
                                                           name))
        torch.cuda.empty_cache()
    refused = phase("refused", lambda: check_refused(rep, dev))
    rep.close()

    if set(paths) != set(ALL_PATHS):
        rep.fail(f"main paths that ran: {sorted(paths)}")
    if None in zoo.values() or refused is None:
        rep.fail("a zoo model did not train, or ccnet_transunet was not "
                 "refused")
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] in
                      ("jax", "jaxlib", "flax", "hpfg_tpu"))
    if jax_side:
        rep.fail(f"JAX-side modules were imported: {jax_side[:5]}")
    kernels = kernel_line(rep, paths)
    with open(os.path.join(OUT_DIR, "summary.json"), "w",
              encoding="utf-8") as f:
        json.dump({"card": card, "paths": summaries, "resume": resume,
                   "pretrain": pretrain, "cli": cli, "zoo": zoo,
                   "refused": refused, "kernels": kernels}, f, indent=1)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if rep.failures:
        print(f"chip_smoke: {len(rep.failures)} failure(s):", file=sys.stderr)
        for msg in rep.failures:
            print(f"  {msg}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
