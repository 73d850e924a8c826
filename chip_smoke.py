#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``hpfg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and exits non-zero without one. It imports neither jax
nor the JAX package. The ``--dp-worker``, ``--nccl-worker`` and
``--eval-worker`` modes are the processes phases 15, 16 and 18 start.
Phases, each of which fails the run on error:

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
     A, B and K8 to K11 in bf16 take their wgmma/TMA kernels
     (csrc/conv3x3_sm90.cu; ops/conv_block.py conv_route, pair_route)
     where C and F (and K9's split) are multiples of 8 (A without an
     output mask), but for conv_route's static rule: each such shape
     also checks the mma.sync route (the wrappers' launchers for fp32,
     the stems, the heads and odd splits) against the plain version, A's
     y and statistics, B's and K10's dW, K8's statistics and y, K9's two
     outputs and K11's dd and sums bitwise the same in two runs, and
     times beside the wrapper's host-inclusive ms the device-only ms of
     both routes and of cuDNN, the mma route's host-inclusive ms and both
     routes' enqueue µs (the ``route_times`` keys of kernels.jsonl; K9's
     and K11's at the ACDC shapes); K11's output mask bit-exact on both
     routes; the build's SASS (cuobjdump) must show wgmma (HGMMA) and TMA
     (UTMALDG) and no mma.sync (HMMA) in every instantiation of both
     kernels (conv_sm90_kernel: A, K8, K9 and K11; wgrad_sm90_kernel: B
     and K10), of K13's and K14's, and of K12's; D's cooperative kernel
     bulk copies (UBLKCP) and no mma.sync (``sass_rule``);
     K12, the bf16 stem (C = 1 or 3, ``conv_route``'s "stem": its own
     kernel, csrc/stem_sm90.cu), is its own entry of the kernels line
     (``conv3x3_stem``): its forward checked against the plain version
     (statistics at fp32's tolerance, bitwise the same in two runs) and
     on the mma route, timed on the device beside it and cuDNN; D (``bn_act_bwd``: one launch of
     the cooperative kernel, csrc/bn_act.cu ``bn_coop_kernel``, in its
     "hold" or "stream" form) checked in its other form and against PR
     6's two kernels ("walk"), dpre bitwise the plain version from the
     kernel's own sums, each timed on the device (``bn_forms``), and C
     beside it;
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
     phases 2 and 2c (the plain versions of A to D and K8 to K11 timed by
     one call there): A to D and K8 to K11 at every conv shape of the
     LIDC Mean-Teacher UNet (96^2, C = 3 stem, F = 2 head, batch 32:
     stages 96 down to 6), the ISIC HPFG UNet_Plus (224^2, C = 3, F = 2,
     batch 40) and the Building UNet_Plus (512^2, C = 3, F = 2, batch 12),
     the Synapse UNet's F = 9 head (224^2, batch 24), and K13 and K14 at
     the four stages of the LIDC SwinUNet (96^2, patch 2, window 3: L = 9,
     shifted by 1; batch 24);
  3. the Mean-Teacher main path through ``Trainer.fit`` (batches through
     its prefetcher, pinned copies on a side stream) with the values of
     configs/mean_teacher_unet_30k_224x224_ACDC.yaml (full-width UNet,
     224^2, 8 labelled + 24 unlabelled images, bf16) on numpy-made batches
     in the ACDC layout, 2 warm-up and 5 timed steps, with ``F.conv2d`` /
     ``torch.conv2d`` patched to raise; the launch counters must rise by
     what the model's structure predicts, every K8 and K10 launch
     must take the wgmma route and A's, B's, K9's and K11's launches
     split between the routes as ``predicted_routes`` says (their
     ``routes`` counters: wgmma wherever C and F are multiples of 8, but
     for the static rule); one more step traced (device busy time, the
     conv kernels' and C's and D's time, and the count of device
     kernels, copies and memsets in the step), whose launches of the
     wgmma conv kernel (and of its K11 form), of PR 4's conv kernels, of
     K12's kernel and of D's cooperative kernel (and of PR 6's reduce and
     dpre) must equal the route counters' of a step; every D a step one
     cooperative launch, and no column sum right after a stem kernel;
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
  10. ``h5``: the committed h5 fixtures (``hpfg_tpu_torch/data/
     h5_fixtures``, written by h5py: a gzip slice, a gzip + shuffle volume
     with edge chunks, a contiguous file) read by the port's HDF5 reader,
     each dataset's sha256 as ``fixtures.json`` lists it; the reader's
     decode rate on the gzip volume and on a contiguous ACDC volume; a
     synthetic ACDC tree (160 slices, 2 + 2 volumes of 6 x 256 x 216)
     written by the port's writer and read back;
  11. ``cli acdc``: ``python -m hpfg_tpu_torch.run`` in a process where
     h5py cannot import, from that tree, with
     configs/mean_teacher_unet_30k_224x224_ACDC.yaml and
     configs/hpfg_unet_plus_30k_224x224_ACDC.yaml unmodified but for
     data_path, save_path, total_itrs = 4 and step_size = 2 (so prefetch
     2, async eval, bf16, 224^2): every eval model's dice at 2 and 4,
     ``done: 4 iters``, ``last``, ``last_a`` / ``last_b`` and ``best_*``,
     a TensorBoard event file (or the no-op writer's line); then
     ``--validate-data`` exits 0 on the tree and 1 on a copy in which one
     slice lost its label;
  12. ``prefetch``: the Mean-Teacher UNet 6 steps with prefetch 0 and 2
     from one state (the UpBlocks' deterministic upsample backward on
     both): losses bitwise equal, every prefetched batch on the card,
     ms/step of each; the step's ``count_flops`` and MFU; ``count_flops``
     of a UNet forward + backward on the card (the kernels' reported
     FLOPs) against the same on a CPU copy; then the Mean-Teacher,
     ``building_sup`` and ``synapse_sup`` paths in turns with prefetch 0,
     2, 2, 0 over 20-step fits (ms/step, the steady state, the fit's own
     start and end);
  13. ``async eval``: HPFG from the tree, 4 iterations, eval every 2: one
     run evaluates each boundary inline and then overlapped, beside the
     next steps (one trajectory; the step has backward atomics), histories
     equal and the ``best_*`` / ``last_a`` / ``last_b`` checkpoints bitwise
     equal; then, on a tree whose test split has ACDC's size (40 volumes of
     10 slices), one run with ``async_eval`` on and one off, one boundary
     each: how long it blocks the loop, how long the eval takes, and the
     step times before, beside and after it;
  14. ``multi eval``: HPFG's three models through one
     ``evaluate_volumes_multi`` call and each through ``evaluate_volumes``
     (its one-model call) on that ACDC-size split: exactly equal, both
     times;
  15. ``dp``: data parallelism over processes on this one card. Two
     one-process steps of ten paths at the configs' full width and global
     batches (bf16): Mean-Teacher, HPFG, UAMT, ICT, SS-Net, S4CVNet (8 + 24
     at 224^2), Swin-MAE (24), CMT and UniFormer HPFG (8 + 24) and the
     LIDC TransUNet (24 at 96^2), the state saved after each step; then the
     same global batches over 2 ranks (``python3 chip_smoke.py
     --dp-worker``, gloo on cuda:0, each rank its contiguous half; the rows
     of a batch differ in mean and scale, so the halves do), each step
     taken from the one process's state before it: each step's loss within
     1e-4 relative, the parameters and BN buffers after it within 1e-3 of
     each model's largest magnitude (tighter than tests/test_sharding.py's
     2e-3 and the bf16 kernel bound, which a rank hashing its local image
     index passes), SS-Net's memory bank bitwise equal on the ranks, its
     validity equal to one process's and its rows within the state bound;
     SS-Net, S4CVNet and TransUNet again in fp32; both
     ranks' launch counters as the structure predicts under W = 2 (the
     UNet's A, C, D's reduce alone and its dpre, K8 to K11: ``bn_act_bwd``
     gives way to ``bn_reduce`` + all-reduce + dpre; K13 and K14 on
     S4CVNet's SwinUNet and on Swin-MAE, with the image-id map; 0 on the
     kernel-free paths), the step time at W = 1 and per rank at W = 2, the
     collectives' calls and bytes a step and their time in the last step,
     where each is timed alone, and which gloo collectives take CUDA
     tensors;
  16. ``nccl``: a 1-rank NCCL group initialises and all-reduces on cuda:0
     (``--nccl-worker``);
  17. ``cli dp``: the HPFG CLI from phase 10's tree through ``python -m
     torch.distributed.run --nproc-per-node 2`` (``distributed=true``,
     ``device=cuda:0``, ``dist_backend=gloo``), 4 iterations, one eval
     boundary, in which every rank evaluates its share of the test set
     (the log's ``eval over 2 rank(s)`` line): rank 0 alone writes the log
     (each eval line once), the TensorBoard events (one file) and the
     checkpoints;
  18. ``sharded eval`` (after phase 14): Mean-Teacher's student and EMA
     teacher, and S4CVNet's SwinUNet and EMA SwinUNet (K13 in their
     forwards; its UNet is Mean-Teacher's student at this seed), over a
     test split of 10 volumes of 10 slices (phase 13's ACDC-size one cut
     for time: the ranks' shares are 5 and 5) in one process and on 2
     gloo ranks on the card (``--eval-worker``), each rank its share:
     per-class dice and HD95 bitwise equal to the one process's; the
     eval's wall time in one process and on each rank;
  19. ``losses`` (after phase 4): the loss library's functions that no
     algorithm calls (``ops/losses.py``: soft-target, binary and
     per-sample dice, KL with softmax and with sigmoid, symmetric MSE,
     entropy and its map, focal with and without alpha and
     ``size_average``, BCE + dice, BCE + dice + smooth L1) on the card on
     the Mean-Teacher UNet's logits (8 + 24 images at 224^2, 4 classes, the
     student's train-mode forward through the kernels, the EMA teacher's
     as the target), in fp32 and on the bf16 logits: each value and its
     gradient with respect to the logits against the same loss on a CPU
     copy, fp32 within 1e-5 and bf16 within 2e-2 of the largest magnitude,
     and each loss's forward + backward time on the card; then their sum
     back through the student, which must launch A, B, C and D.

Phase 2e checks A, B and K11 with a two-segment image-id map (the hash
dropout of a data-parallel rank: each image hashes its index in the global
batch) against their plain versions, A's masks and K11's (on both
routes) bit-exact, and D's reduce alone, and times each with and without
the ids; then K13 and K14 with
that map (each window hashes its index in the global batch's windows) at
the SwinUNet's first and last stage, their attention-dropout masks
bit-exact against the full batch's, and times each with and without the
ids. Its rows stay out of the kernels' totals.

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

``bn_stem_kernel_times`` times K12 (both forms, the mma route, cuDNN) at
the four stems and C and D (both forms, PR 6's two kernels) at the five
ACDC stages on the device; ``dgrad_kernel_times``, ``conv_kernel_times``
and ``pair_kernel_times`` run alone (``python3 -c "import chip_smoke as c;
c.dgrad_kernel_times()"``) time K9 and K11, A and B, K8 and K10 on both
routes and cuDNN at the main path's shapes, device-only and
host-inclusive; a copy of this file run from an earlier tree's root
times that tree's kernels.
"""

from __future__ import annotations

import inspect
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
CU90 = "hpfg_tpu_torch/csrc/conv3x3_sm90.cu"
ATTN_CU = "hpfg_tpu_torch/csrc/window_attention.cu"
ATTN_CU90 = "hpfg_tpu_torch/csrc/window_attention_sm90.cu"
BN_CU = "hpfg_tpu_torch/csrc/bn_act.cu"
STEM_CU90 = "hpfg_tpu_torch/csrc/stem_sm90.cu"
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
    "conv3x3_nhwc": dict(route="cuda", source=CU90,
                         replaces=f"{PALLAS}:734",
                         also_replaces=[f"{PALLAS}:785", f"{PALLAS}:1176"],
                         counters=["conv3x3_nhwc"],
                         routes={"wgmma": CU90, "mma": CU,
                                 "stem": STEM_CU90}),
    # K12: A's calls on the stem route (its launches: that route's count)
    "conv3x3_stem": dict(route="cuda", source=STEM_CU90,
                         replaces=f"{PALLAS}:746", also_replaces=[],
                         counters=[], route_of=("conv3x3_nhwc", "stem"),
                         routes={"stem": STEM_CU90},
                         library_note="F.conv2d alone: no statistics"),
    "conv3x3_wgrad_nhwc": dict(route="cuda", source=CU90,
                               replaces=f"{PALLAS}:1192", also_replaces=[],
                               counters=["conv3x3_wgrad_nhwc"],
                               routes={"wgmma": CU90, "mma": CU}),
    "bn_act": dict(route="cuda", source=BN_CU, replaces=f"{PALLAS}:810",
                   also_replaces=[], counters=["bn_act"]),
    "bn_act_bwd": dict(route="cuda", source=BN_CU,
                       replaces=f"{PALLAS}:1151",
                       also_replaces=[f"{PALLAS}:1166"],
                       counters=["bn_act_bwd", "bn_act_dpre", "bn_reduce"],
                       routes={"hold": BN_CU, "stream": BN_CU,
                               "walk": BN_CU}),
    "conv3x3_pair_nhwc": dict(route="cuda", source=CU90,
                              replaces=f"{PALLAS}:772", also_replaces=[],
                              counters=["conv3x3_pair_nhwc"],
                              routes={"wgmma": CU90, "mma": CU}),
    "conv3x3_dgrad_pair": dict(route="cuda", source=CU90,
                               replaces=f"{PALLAS}:1364", also_replaces=[],
                               counters=["conv3x3_dgrad_pair"],
                               routes={"wgmma": CU90, "mma": CU}),
    "conv3x3_wgrad_pair": dict(route="cuda", source=CU90,
                               replaces=f"{PALLAS}:1453", also_replaces=[],
                               counters=["conv3x3_wgrad_pair"],
                               routes={"wgmma": CU90, "mma": CU}),
    "conv3x3_dgrad_reduce": dict(route="cuda", source=CU90,
                                 replaces=f"{PALLAS}:1525", also_replaces=[],
                                 counters=["conv3x3_dgrad_reduce"],
                                 routes={"wgmma": CU90, "mma": CU},
                                 library_note="conv2d_input alone: the dgrad"
                                 " without the reduce, less work"),
    "window_attention_fwd": dict(
        route="cuda", source=ATTN_CU90, replaces=f"{ATTN_PALLAS}:66",
        also_replaces=[], counters=["window_attention_fwd"],
        paths=ATTN_PATHS, routes={"wgmma": ATTN_CU90, "mma": ATTN_CU},
        library_note="F.scaled_dot_product_attention on [Bn, H, L, D] with "
        "attn_mask = bias + mask"),
    "window_attention_bwd": dict(
        route="cuda", source=ATTN_CU90, replaces=f"{ATTN_PALLAS}:153",
        also_replaces=[], counters=["window_attention_bwd"],
        paths=ATTN_PATHS, routes={"wgmma": ATTN_CU90, "mma": ATTN_CU},
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
                work=None, main=True, **extra) -> float:
        """``work``: (FLOPs, bytes) of the timed call; ``main``: the timed
        call is one the main path makes (it enters the kernel's totals);
        ``extra``: more timings of the row (``route_times``)."""
        tol = TOL[dtype] if tol is None else tol
        got, ref = got.float(), ref.float()
        err = (got - ref).abs().max().item()
        scale = max(ref.abs().max().item(), 1e-30)
        rel = err / scale
        row = dict(kernel=kernel, what=what, dtype=dtype, max_abs_err=err,
                   rel_err=rel, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, main=main, geometry=self.geometry,
                   **extra)
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


def plain_timer(timed: bool, geometry):
    """The plain versions' clock: ``timer``'s at the ACDC shapes; one call
    (``cuda_ms`` of one rep, one round) at a new path's geometry, where the
    fp32 plain versions at 512^2 x 12 would take most of phase 2d."""
    if timed and geometry is not None:
        return lambda fn: cuda_ms(fn, reps=1, rounds=1)
    return timer(timed)


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
    itself (one product each: in bf16 the fp32 mask rounded to bf16); so
    does A's output mask, and K11's on the wrapper's route and on the
    mma.sync route."""
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
            # K11's output mask (the identity dgrad of ones): the wrapper's
            # route and, in bf16, the mma.sync route beside it
            unit = (x, ones, zeros, zeros, ones)
            got_k11 = cb.conv3x3_dgrad_reduce(x, eye, *unit, out_drop=drop)[0]
            got_k11_mma = torch.empty_like(x)
            cb._launch_conv(x, eye, got_k11_mma, out_drop=drop, reduce=unit,
                            want_sums=True)
            for what, got in (("prologue", got_in), ("output", got_out),
                              ("K11 output", got_k11),
                              ("K11 output mma route", got_k11_mma)):
                if not torch.equal(got, ref):
                    rep.fail(f"hash mask ({what}) keep={keep} {hh}x{hh}x{c} "
                             f"{dt}: {(got != ref).sum().item()} elements "
                             f"differ")
    print("hash masks: bit-exact check done (prologue and output masks, "
          "K11's on both routes, keep 0.95..0.5, float32 and bfloat16)",
          flush=True)


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
    pclock = plain_timer(timed, geometry)
    sfx = (f" {geometry} batch {batch}" if geometry else
           "" if batch == BATCH else f" batch {batch}")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    if timed and geometry is None:
        check_hash_masks(rep, dev)
    # the routes side by side (route_times) at the ACDC shapes only: the
    # geometries' rows keep the wrapper's times
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
            both_routes = timed and dt == torch.bfloat16 and geometry is None
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
            pms = pclock(lambda: cb.conv3x3_reference(x, w, **args))
            # the conv alone (no prologue, statistics or mask) by cuDNN
            w_c, bias_c = oihw(w), bias.to(dt)
            cms = lib(lambda: F.conv2d(nchw(x), w_c, bias_c, padding=1))
            work = conv_work(hh, c, f, es, 2 * f, batch=batch)
            route = cb.conv_route(c, f, dt, True,
                                  "conv" if keep is None else "prologue",
                                  width=hh)
            pro = cb._prologue_args(args.get("affine"), args.get("drop"), c,
                                    batch, dev)
            y_m = torch.empty_like(y)

            def a_mma():  # the mma.sync route, which fp32 and the stems keep
                return y_m, cb._launch_conv(x, w, y_m, bias=bias, pro=pro,
                                            want_sums=True)

            extra = route_times(both_routes,
                                lambda: cb.conv3x3_nhwc(x, w, **args), a_mma,
                                lambda: F.conv2d(nchw(x), w_c, bias_c,
                                                 padding=1))
            # K12 (the stem route) is its own kernel in the kernels line
            kname = "conv3x3_stem" if route == "stem" else "conv3x3_nhwc"
            r1 = rep.compare(kname, f"{name} fwd{sfx}", dname, y,
                             y_r, ms, pms, library_ms=cms,
                             main=timed and not concat, work=work,
                             route=route, **extra)
            r2 = rep.compare(kname, f"{name} stats{sfx}", dname, st,
                             st_r, tol=TOL["float32"] if route == "stem"
                             else None)
            same_twice(rep, f"{kname} {name} y, stats {dname}{sfx}",
                       lambda: cb.conv3x3_nhwc(x, w, **args))
            if route in ("wgmma", "stem"):  # the other routes, same shape
                got_m, st_m = a_mma()
                r2 = max(r2, rep.compare(
                    kname, f"{name} fwd mma route{sfx}", dname,
                    got_m, y_r, main=False), rep.compare(
                    kname, f"{name} stats mma route{sfx}", dname,
                    st_m, st_r, main=False))
            line.append(f"{'K12' if route == 'stem' else 'A'} {route} fwd "
                        f"{max(r1, r2):.1e}"
                        f"{perf(ms, pms, cms, work)}{route_note(extra)}")

            wf = cb.flip_transpose(w)
            odrop = args.get("drop")
            dx, _ = cb.conv3x3_nhwc(dp, wf, out_drop=odrop)
            dx_r, _ = cb.conv3x3_reference(dp, wf, out_drop=odrop)
            ms = clock(lambda: cb.conv3x3_nhwc(dp, wf, out_drop=odrop))
            pms = pclock(lambda: cb.conv3x3_reference(dp, wf, out_drop=odrop))
            wf_c = oihw(wf)
            cms = lib(lambda: F.conv2d(nchw(dp), wf_c, padding=1))
            work = conv_work(hh, f, c, es, batch=batch)
            route = cb.conv_route(f, c, dt, True,
                                  "conv" if odrop is None else "out_drop")
            dx_m = torch.empty_like(dx)

            def dgrad_mma():
                cb._launch_conv(dp, wf, dx_m, out_drop=odrop)
                return dx_m

            extra = route_times(both_routes,
                                lambda: cb.conv3x3_nhwc(dp, wf,
                                                        out_drop=odrop),
                                dgrad_mma,
                                lambda: F.conv2d(nchw(dp), wf_c, padding=1))
            # a conv2's dgrad runs as K11; the stem's (into F = 1) runs in
            # SS-Net's VAT inner gradient
            r = rep.compare("conv3x3_nhwc", f"{name} dgrad{sfx}", dname, dx,
                            dx_r, ms, pms, library_ms=cms,
                            main=timed and not (concat or conv2 or new_stem),
                            work=work, route=route, **extra)
            if route == "wgmma":
                r = max(r, rep.compare(
                    "conv3x3_nhwc", f"{name} dgrad mma route{sfx}", dname,
                    dgrad_mma(), dx_r, main=False))
            line.append(f"A {route} dgrad"
                        f"{f' into F = {c}' if c < 16 else ''} {r:.1e}"
                        f"{perf(ms, pms, cms, work)}{route_note(extra)}")

            wargs = {k: args[k] for k in ("affine", "drop") if k in args}
            dw = cb.conv3x3_wgrad_nhwc(x, dp, **wargs)
            dw_r = cb.conv3x3_wgrad_reference(x, dp, **wargs)
            ms = clock(lambda: cb.conv3x3_wgrad_nhwc(x, dp, **wargs))
            pms = pclock(lambda: cb.conv3x3_wgrad_reference(x, dp, **wargs))

            def b_cudnn():
                return torch.nn.grad.conv2d_weight(
                    nchw(x), (f, c, 3, 3), nchw(dp), padding=1)

            cms = lib(b_cudnn)
            work = conv_work(hh, c, f, es, w_es=4, batch=batch)
            route = cb.conv_route(c, f, dt, True, "wgrad_prologue" if wargs
                                  else "wgrad")

            def b_mma():
                return cb._launch_wgrad(x, dp, pro=pro)

            extra = route_times(both_routes,
                                lambda: cb.conv3x3_wgrad_nhwc(x, dp, **wargs),
                                b_mma, b_cudnn)
            r = rep.compare("conv3x3_wgrad_nhwc", f"{name} wgrad{sfx}", dname,
                            dw, dw_r, ms, pms, library_ms=cms,
                            main=timed and not concat, work=work,
                            route=route, **extra)
            same_twice(rep, f"conv3x3_wgrad_nhwc {name} {dname}{sfx}",
                       lambda: (cb.conv3x3_wgrad_nhwc(x, dp, **wargs),))
            if route == "wgmma":
                r = max(r, rep.compare(
                    "conv3x3_wgrad_nhwc", f"{name} wgrad mma route{sfx}",
                    dname, b_mma().view_as(dw_r), dw_r, main=False))
            line.append(f"B {route} {r:.1e}{perf(ms, pms, cms, work)}"
                        f"{route_note(extra)}")

            if keep is not None:  # block output: BN2 + LeakyReLU fwd / bwd
                n = batch * hh * hh * f
                g = randn(batch, hh, hh, f).to(dt)
                a2, b2 = 1.0 + randn(f, scale=0.1), randn(f, scale=0.1)
                y = ba.bn_act(g, a2, b2)
                ms = clock(lambda: ba.bn_act(g, a2, b2))
                pms = pclock(lambda: ba.bn_act_reference(g, a2, b2))
                y_r = ba.bn_act_reference(g, a2, b2)
                work = (3 * n, 2 * es * n)
                c_extra = (dict(device_ms=device_ms(
                    lambda: ba.bn_act(g, a2, b2))) if both_routes else {})
                r = rep.compare("bn_act", f"{name} bn_act{sfx}", dname, y,
                                y_r, ms, pms, work=work, main=timed,
                                **c_extra)
                if not torch.equal(y, y_r):
                    rep.fail(f"bn_act {name} {dname}{sfx}: not bitwise equal "
                             f"to the plain version")
                line.append(f"C {r:.1e} bitwise{perf(ms, pms, work=work)}")
                m, inv = randn(f, scale=0.1), 1.0 + randn(f, scale=0.1).abs()
                s, d = ba.bn_act_bwd(dp, g, a2, b2, m, inv)
                s_r, d_r = ba.bn_act_bwd_reference(dp, g, a2, b2, m, inv)
                ms = clock(lambda: ba.bn_act_bwd(dp, g, a2, b2, m, inv))
                pms = pclock(lambda: ba.bn_act_bwd_reference(dp, g, a2, b2,
                                                            m, inv))
                work = (17 * n, 3 * es * n)
                d_extra, forms = bn_forms(both_routes, dp, g, a2, b2, m, inv)
                # the sums are fp32 in both dtypes: the fp32 tolerance
                r1 = rep.compare("bn_act_bwd", f"{name} sums{sfx}", dname, s,
                                 s_r, ms, pms, tol=TOL["float32"], work=work,
                                 main=timed, route=bn_form(dp, g, a2, b2, m,
                                                           inv), **d_extra)
                r2 = rep.compare("bn_act_bwd", f"{name} dpre{sfx}", dname, d,
                                 d_r)
                if not torch.equal(d, ba.bn_act_dpre_reference(
                        dp, g, a2, b2, m, inv, s)):
                    rep.fail(f"bn_act_bwd {name} {dname}{sfx}: dpre not "
                             f"bitwise the plain version from its sums")
                same_twice(rep, f"bn_act_bwd {name} sums {dname}{sfx}",
                           lambda: (ba.bn_act_bwd(dp, g, a2, b2, m, inv)[0],))
                for form, (s_f, d_f) in forms.items():  # the other forms
                    r2 = max(r2, rep.compare(
                        "bn_act_bwd", f"{name} sums {form} form{sfx}", dname,
                        s_f, s_r, tol=TOL["float32"], main=False),
                        rep.compare("bn_act_bwd", f"{name} dpre {form} "
                                    f"form{sfx}", dname, d_f, d_r,
                                    main=False))
                line.append(f"D {max(r1, r2):.1e}{perf(ms, pms, work=work)}"
                            f"{bn_note(d_extra)}")
                d = ba.bn_act_dpre(dp, g, a2, b2, m, inv, s_r)
                ms = clock(lambda: ba.bn_act_dpre(dp, g, a2, b2, m, inv, s_r))
                pms = pclock(lambda: ba.bn_act_dpre_reference(
                    dp, g, a2, b2, m, inv, s_r))
                work = (9 * n, 3 * es * n)
                # K5 alone on the device (its row in the kernels line's
                # by_tpu_kernel split)
                p_extra = (dict(device_ms=device_ms(lambda: ba.bn_act_dpre(
                    dp, g, a2, b2, m, inv, s_r))) if both_routes else {})
                r = rep.compare("bn_act_bwd", f"{name} dpre-only{sfx}", dname,
                                d, ba.bn_act_dpre_reference(dp, g, a2, b2, m,
                                                            inv, s_r),
                                ms, pms, work=work, main=timed, **p_extra)
                line.append(f"D dpre {r:.1e}{perf(ms, pms, work=work)}")
            print(" | ".join(line), flush=True)
            del x, w, dp, y, y_r, dx, dx_r
            torch.cuda.empty_cache()


def bn_form(dy, pre, a, b, mean, inv) -> str:
    """The route D's wrapper takes for these tensors: "walk" (PR 6's two
    kernels) or the cooperative kernel's form, "hold" or "stream"."""
    from hpfg_tpu_torch.ops import bn_act as ba

    route = ba._route(dy, pre, a, b, mean, inv)
    return route if route == "walk" else ba._plan(dy, False).form


def bn_forms(timed: bool, dy, pre, a, b, mean, inv) -> tuple[dict, dict]:
    """D beside the wrapper's own call: the cooperative kernel's other form
    (the hold form where it fits) and PR 6's two kernels ("walk": reduce,
    then dpre from its sums). Returns (timings: device-only ms of the
    wrapper's call and of each form, "walk" also host-inclusive; empty
    untimed, {form: (sums, dpre)} of the forms the wrapper did not
    take)."""
    import torch

    from hpfg_tpu_torch.ops import bn_act as ba

    args = (dy, pre, a, b, mean, inv)
    own = bn_form(*args)

    def coop(form):
        def run():
            d = torch.empty_like(dy)
            return ba._coop(*args, d, form=form)[0], d
        return run

    def walk():
        s = ba._reduce(*args)
        return s, ba._dpre(*args, s)

    calls = {"walk": walk}
    if own != "walk":
        calls["stream"] = coop("stream")
        try:
            ba._plan(dy, False, "hold")
            calls["hold"] = coop("hold")
        except ValueError:  # dy and pre do not fit the resident CTAs
            pass
    forms = {k: fn() for k, fn in calls.items() if k != own}
    extra = {}
    if timed:
        extra["device_ms"] = device_ms(lambda: ba.bn_act_bwd(*args))
        for k, fn in calls.items():
            extra[f"{k}_device_ms"] = device_ms(fn)
        extra["walk_ms"] = cuda_ms(walk)
    return extra, forms


def bn_note(extra: dict) -> str:
    """' device call/hold/stream/walk ms (walk host ...)' of ``bn_forms``."""
    if not extra:
        return ""
    parts = [f"{extra[k]:.4f}" if k in extra else "n/a"
             for k in ("device_ms", "hold_device_ms", "stream_device_ms",
                       "walk_device_ms")]
    return (f" device call/hold/stream/walk {'/'.join(parts)}ms (walk host "
            f"{extra['walk_ms']:.4f}ms)")


def check_pair_kernels(rep: Report, dev, batch: int = BATCH,
                       timed: bool = True, blocks=BLOCKS) -> None:
    """K8, K9 and K10 at the four UpBlock shapes of ``blocks``, and K11 at
    every ConvBlock's conv2 (the encoder's with and without its dropout),
    against their plain versions at ``batch``; ``timed`` as in
    check_kernels, in bf16 beside the library call that computes the same
    conv. Where the wrapper takes the wgmma route, the mma.sync route too
    against the plain version; K8's, K10's, K9's and K11's outputs (and
    sums) bitwise the same in two runs; in bf16 each row's
    ``route_times`` (K9's and K11's at the ACDC shapes only)."""
    import torch
    import torch.nn.functional as F

    from hpfg_tpu_torch.ops import conv_block as cb

    gen = torch.Generator(device=dev).manual_seed(2)
    clock = timer(timed)
    geometry = rep.geometry
    pclock = plain_timer(timed, geometry)
    sfx = (f" {geometry} batch {batch}" if geometry else
           "" if batch == BATCH else f" batch {batch}")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        es = dt.itemsize
        lib = clock if dt == torch.bfloat16 else (lambda fn: None)
        bf16_timed = timed and dt == torch.bfloat16
        # K9's and K11's routes side by side at the ACDC shapes only
        both_routes = bf16_timed and geometry is None
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

            y_m = xa.new_empty((batch, hh, hh, f))

            def k8_mma():  # PR 4's route, which the wrapper keeps for fp32
                return y_m, cb._launch_conv(xa, w, y_m, x2=xb, bias=bias,
                                            want_sums=True)

            def k8_cudnn():
                return F.conv2d(nchw(cat), w_c, bias.to(dt), padding=1)

            route = cb.pair_route(ca, cbh, f, dt, True)
            (y, st), (y_r, st_r) = k8(), k8_plain()
            ms, pms = clock(k8), pclock(k8_plain)
            lms = lib(k8_cudnn)
            work = conv_work(hh, c, f, es, 2 * f, batch=batch)
            extra = route_times(bf16_timed, k8, k8_mma, k8_cudnn)
            r = max(rep.compare("conv3x3_pair_nhwc", f"{name} fwd{sfx}",
                                dname, y, y_r, ms, pms, library_ms=lms,
                                work=work, main=timed, route=route, **extra),
                    rep.compare("conv3x3_pair_nhwc", f"{name} stats{sfx}",
                                dname, st, st_r))
            same_twice(rep, f"conv3x3_pair_nhwc {name} {dname}{sfx}", k8)
            if route == "wgmma":  # the other route at the same shape
                got_m, st_m = k8_mma()
                r = max(r, rep.compare(
                    "conv3x3_pair_nhwc", f"{name} fwd mma route{sfx}", dname,
                    got_m, y_r, main=False),
                    rep.compare("conv3x3_pair_nhwc",
                                f"{name} stats mma route{sfx}", dname, st_m,
                                st_r, main=False))
            line.append(f"K8 {route} {r:.1e}{perf(ms, pms, lms, work)}"
                        f"{route_note(extra)}")

            wf = cb.flip_transpose(w)

            def k9():
                return cb.conv3x3_dgrad_pair(dp, wf, ca)

            dxa_m, dxb_m = torch.empty_like(xa), torch.empty_like(xb)

            def k9_mma():  # PR 4's route, which the wrapper keeps for fp32
                cb._launch_conv(dp, wf, dxa_m, y2=dxb_m)
                return dxa_m, dxb_m

            def k9_cudnn():
                return torch.nn.grad.conv2d_input((batch, c, hh, hh), w_c,
                                                  nchw(dp), padding=1)

            got = k9()
            ref = cb.conv3x3_dgrad_pair_reference(dp, wf, ca)
            ms = clock(k9)
            pms = pclock(lambda: cb.conv3x3_dgrad_pair_reference(dp, wf, ca))
            lms = lib(k9_cudnn)
            work = conv_work(hh, f, c, es, batch=batch)
            k9_route = cb.conv_route(f, c, dt, True, "dgrad_pair", ca)
            extra = route_times(both_routes, k9, k9_mma, k9_cudnn)
            r = max(rep.compare("conv3x3_dgrad_pair", f"{name} dx_skip{sfx}",
                                dname, got[0], ref[0], ms, pms,
                                library_ms=lms, work=work, main=timed,
                                route=k9_route, **extra),
                    rep.compare("conv3x3_dgrad_pair", f"{name} dx_up{sfx}",
                                dname, got[1], ref[1]))
            if not (got[0].is_contiguous() and got[1].is_contiguous()):
                rep.fail(f"conv3x3_dgrad_pair {name}{sfx}: outputs not "
                         f"contiguous")
            same_twice(rep, f"conv3x3_dgrad_pair {name} {dname}{sfx}", k9)
            if k9_route == "wgmma":  # the other route at the same shape
                for half, g_m, g_r in zip(("dx_skip", "dx_up"), k9_mma(),
                                          ref):
                    r = max(r, rep.compare(
                        "conv3x3_dgrad_pair", f"{name} {half} mma route{sfx}",
                        dname, g_m, g_r, main=False))
            line.append(f"K9 {k9_route} {r:.1e}{perf(ms, pms, lms, work)}"
                        f"{route_note(extra)}")

            def k10():
                return cb.conv3x3_wgrad_pair(xa, xb, dp)

            def k10_mma():
                return cb._launch_wgrad(xa, dp, src2=xb)

            def k10_cudnn():
                return torch.nn.grad.conv2d_weight(
                    nchw(cat), (f, c, 3, 3), nchw(dp), padding=1)

            got = k10()
            ref = cb.conv3x3_wgrad_pair_reference(xa, xb, dp)
            ms = clock(k10)
            pms = pclock(lambda: cb.conv3x3_wgrad_pair_reference(xa, xb, dp))
            lms = lib(k10_cudnn)
            work = conv_work(hh, c, f, es, w_es=4, batch=batch)
            extra = route_times(bf16_timed, k10, k10_mma, k10_cudnn)
            r = max(rep.compare("conv3x3_wgrad_pair", f"{name} dw_skip{sfx}",
                                dname, got[0], ref[0], ms, pms,
                                library_ms=lms, work=work, main=timed,
                                route=route, **extra),
                    rep.compare("conv3x3_wgrad_pair", f"{name} dw_up{sfx}",
                                dname, got[1], ref[1]))
            same_twice(rep, f"conv3x3_wgrad_pair {name} {dname}{sfx}", k10)
            if route == "wgmma":
                dw_m = k10_mma()
                r = max(r, rep.compare(
                    "conv3x3_wgrad_pair", f"{name} dw mma route{sfx}", dname,
                    dw_m, torch.cat([ref[0].reshape(-1), ref[1].reshape(-1)]),
                    main=False))
            line.append(f"K10 {route} {r:.1e}{perf(ms, pms, lms, work)}"
                        f"{route_note(extra)}")
            print(" | ".join(line), flush=True)
            del xa, xb, cat, dp, y, y_r, y_m, got, ref, dxa_m, dxb_m
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

            dd_m = torch.empty_like(dp)

            def k11_mma():  # PR 4's route, which the wrapper keeps for fp32
                return dd_m, cb._launch_conv(
                    dp, wf, dd_m, out_drop=drop, reduce=(pre, a, b, m, inv),
                    want_sums=True)

            def k11_cudnn():
                return torch.nn.grad.conv2d_input((batch, f, hh, hh), w2_c,
                                                  nchw(dp), padding=1)

            (dd, s), (dd_r, s_r) = k11(), k11_plain()
            # timed where the main path makes the call: the encoder's
            # shapes without their dropout are checked alone
            main = timed and (hh, f, kp) in main_cases
            ms, pms = (clock(k11), pclock(k11_plain)) if main else (None,
                                                                    None)
            lms = lib(k11_cudnn) if main else None
            n = batch * hh * hh * f
            flops, nbytes = conv_work(hh, f, f, es, n, batch=batch)
            work = (flops + 8 * n, nbytes)
            what = f"{name}.conv2 {'keep ' + str(kp) if kp else 'no drop'}"
            k11_route = cb.conv_route(f, f, dt, True, "dgrad_reduce")
            extra = route_times(both_routes and main, k11, k11_mma,
                                k11_cudnn)
            r = max(rep.compare("conv3x3_dgrad_reduce", f"{what} dd{sfx}",
                                dname, dd, dd_r, ms, pms, library_ms=lms,
                                work=work, main=main, route=k11_route,
                                **extra),
                    rep.compare("conv3x3_dgrad_reduce", f"{what} sums{sfx}",
                                dname, s, s_r))
            same_twice(rep, f"conv3x3_dgrad_reduce {what} dd, sums "
                       f"{dname}{sfx}", k11)
            if k11_route == "wgmma":  # the other route at the same shape
                dd_o, s_o = k11_mma()
                r = max(r, rep.compare(
                    "conv3x3_dgrad_reduce", f"{what} dd mma route{sfx}",
                    dname, dd_o, dd_r, main=False), rep.compare(
                    "conv3x3_dgrad_reduce", f"{what} sums mma route{sfx}",
                    dname, s_o, s_r, main=False))
            print(f"{dname} {what:>24} {hh:>3}^2 {f}->{f}{sfx}: K11 "
                  f"{k11_route} {r:.1e}{perf(ms, pms, lms, work)}"
                  f"{route_note(extra)}" + (" (library: the dgrad alone)"
                                            if main else ""), flush=True)
            del dp, pre, dd, dd_r, dd_m
            torch.cuda.empty_cache()


def device_ms(fn, reps: int = 10, rounds: int = 3) -> float:
    """ms per call on the device alone: as ``cuda_ms``, with each round's
    calls enqueued behind a sleep kernel of about 10 ms, so the events time
    the device's work and not the host's enqueue."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(rounds):
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def masked_kernel_times() -> dict:
    """The kernels whose dropout mask hashes an image or window index, bf16,
    batch 32, at phase 2's main-path shapes: K11 (``conv3x3_dgrad_reduce``)
    at the nine conv2 shapes (the encoder's with their dropout, the
    decoder's without), A with the masked prologue (conv2's forward,
    ``A2``) and B with it (conv2's wgrad, ``B2``) at the five encoder
    shapes, K13 and K14 with attention dropout (keep 0.9) at the
    SwinUNet's four stages (shifted where a stage has more than one
    window). ms per call
    by phase 2's method (``cuda_ms``, the host's cost included) and on the
    device alone (``device_ms``), each shape and summed; printed as one
    JSON line. It calls only the wrappers' long-standing arguments, so a
    copy of this file run from an earlier tree's root times that tree's
    kernels: ``python3 -c 'import <copy>; <copy>.masked_kernel_times()'``,
    trees in turns."""
    import torch

    from hpfg_tpu_torch.models.swinunet import _shift_attention_mask
    from hpfg_tpu_torch.ops import conv_block as cb
    from hpfg_tpu_torch.ops import window_attention as wa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    dt = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    out = {k: {"host": {}, "device": {}}
           for k in ("K11", "A2", "B2", "K13", "K14")}
    for name, hh, _, f, keep in BLOCKS:
        dp = randn(BATCH, hh, hh, f).to(dt)
        w = randn(3, 3, f, f, scale=(9 * f) ** -0.5).to(dt)
        wf = cb.flip_transpose(w)
        h = randn(BATCH, hh, hh, f).to(dt)
        bias = randn(f, scale=0.1)
        a, b = 1.0 + randn(f, scale=0.1), randn(f, scale=0.1)
        m, inv = randn(f, scale=0.1), 1.0 + randn(f, scale=0.1).abs()
        drop = cb.HashDropout(88, keep) if keep else None
        calls = {"K11": lambda: cb.conv3x3_dgrad_reduce(
            dp, wf, h, a, b, m, inv, out_drop=drop)}
        if drop is not None:
            calls["A2"] = lambda: cb.conv3x3_nhwc(
                h, w, bias, affine=(a, b), drop=drop, want_stats=True)
            calls["B2"] = lambda: cb.conv3x3_wgrad_nhwc(
                h, dp, affine=(a, b), drop=drop)
        for kernel, fn in calls.items():
            out[kernel]["host"][name] = cuda_ms(fn)
            out[kernel]["device"][name] = device_ms(fn)
    l = ATTN_WS * ATTN_WS
    for stage, side, heads in ATTN_STAGES:
        nw = (side // ATTN_WS) ** 2
        c = heads * ATTN_D
        qkv = randn(BATCH * nw, l, 3 * c).to(dt)
        do = randn(BATCH * nw, l, c).to(dt)
        bias = randn(heads, l, l, scale=0.02)
        mask = (torch.from_numpy(_shift_attention_mask(
            side, side, ATTN_WS, ATTN_WS // 2)).to(dev) if nw > 1 else None)
        drop = cb.HashDropout(66 + stage, 0.9)
        calls = {"K13": lambda: wa.window_attention_fwd(qkv, bias, mask,
                                                        heads, drop),
                 "K14": lambda: wa.window_attention_bwd(qkv, bias, mask, do,
                                                        heads, drop)}
        for kernel, fn in calls.items():
            out[kernel]["host"][f"stage{stage}"] = cuda_ms(fn)
            out[kernel]["device"][f"stage{stage}"] = device_ms(fn)
    for row in out.values():
        for kind in ("host", "device"):
            row[f"{kind}_total"] = sum(row[kind].values())
    print("MASKED " + json.dumps(out), flush=True)
    return out


def route_times(timed: bool, call, mma, library,
                library_device=None, enqueue: bool = True) -> dict:
    """Phase 2's rows of the kernels with two routes beside the wrapper's
    host-inclusive ms (``cuda_ms``): ms on the device alone
    (``device_ms``) of the wrapper's call, of the mma.sync route at the
    same shape and of the library call (or ``library_device``, its
    device-only ms taken already), the mma route's host-inclusive ms, and
    the µs the wrapper's call and the mma route take to enqueue (the wgmma
    route encodes its tensor maps on the host at every call). Empty when
    untimed. A library of None: ``library_device`` (None where it
    failed); ``enqueue`` False: no enqueue times (None)."""
    if not timed:
        return {}
    return dict(device_ms=device_ms(call), mma_ms=cuda_ms(mma),
                mma_device_ms=device_ms(mma),
                library_device_ms=(library_device if library is None
                                   else device_ms(library)),
                enqueue_us=enqueue_us(call) if enqueue else None,
                mma_enqueue_us=enqueue_us(mma) if enqueue else None)


def route_note(extra: dict) -> str:
    """' device call/mma/library ms, enqueue call/mma µs' of
    ``route_times``."""
    if not extra:
        return ""
    lib, enq = extra["library_device_ms"], extra["enqueue_us"]
    return (f" device {extra['device_ms']:.4f}/{extra['mma_device_ms']:.4f}/"
            f"{'n/a' if lib is None else f'{lib:.4f}'}ms (mma host "
            f"{extra['mma_ms']:.4f}ms)" + (
                "" if enq is None else
                f" enqueue {enq:.0f}/{extra['mma_enqueue_us']:.0f}us"))


def enqueue_us(fn, reps: int = 20, rounds: int = 3) -> float:
    """µs of host time to enqueue one call of ``fn``: ``reps`` calls timed
    on the host clock behind a sleep kernel of about 30 ms, so the device's
    queue never pushes back on the host; the least of ``rounds`` rounds
    (the host's other work only adds)."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda._sleep(60_000_000)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        best = min(best, (t1 - t0) / reps * 1e6)
    return best


def pair_kernel_times(batch: int = BATCH) -> dict:
    """K8 (``conv3x3_pair_nhwc`` with its statistics) and K10
    (``conv3x3_wgrad_pair`` with its column sum) in bf16 at the four
    UpBlock shapes, beside the cuDNN call phase 2 times for each (F.conv2d
    and conv2d_weight on the materialised concat): ms per call on the
    device alone (``device_ms``) and by phase 2's host-inclusive method
    (``cuda_ms``), and µs of host time to enqueue one call
    (``enqueue_us``). Routes: ``call`` is the wrapper as a user calls it;
    ``mma`` PR 4's mma.sync kernels through the launchers the wrappers use
    for the other calls (``_launch_conv``, ``_launch_wgrad``), the same as
    ``call`` on a tree without the wgmma route. Printed as one ``PAIR``
    JSON line and returned."""
    import torch
    import torch.nn.functional as F

    from hpfg_tpu_torch.ops import conv_block as cb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    dt = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    out = {}
    for name, hh, c, f, _ in BLOCKS:
        if not name.startswith("up"):
            continue
        ca = c // 2
        xa = randn(batch, hh, hh, ca).to(dt)
        xb = randn(batch, hh, hh, c - ca).to(dt)
        w = randn(3, 3, c, f, scale=(9 * c) ** -0.5).to(dt)
        bias = randn(f, scale=0.1)
        dp = randn(batch, hh, hh, f).to(dt)
        cat, w_c = torch.cat([xa, xb], dim=-1), oihw(w)
        y = torch.empty((batch, hh, hh, f), dtype=dt, device=dev)
        calls = {
            "K8 call": lambda: cb.conv3x3_pair_nhwc(xa, xb, w, bias,
                                                    want_stats=True),
            "K8 mma": lambda: cb._launch_conv(xa, w, y, x2=xb, bias=bias,
                                              want_sums=True),
            "K8 cudnn": lambda: F.conv2d(nchw(cat), w_c, bias.to(dt),
                                         padding=1),
            "K10 call": lambda: cb.conv3x3_wgrad_pair(xa, xb, dp),
            "K10 mma": lambda: cb._launch_wgrad(xa, dp, src2=xb),
            "K10 cudnn": lambda: torch.nn.grad.conv2d_weight(
                nchw(cat), (f, c, 3, 3), nchw(dp), padding=1)}
        row = {}
        for what, fn in calls.items():
            row[what] = dict(device_ms=device_ms(fn), host_ms=cuda_ms(fn),
                             enqueue_us=enqueue_us(fn))
        out[f"{name} {hh}^2 {ca}+{c - ca}->{f}"] = row
        del xa, xb, dp, cat, y
        torch.cuda.empty_cache()
    totals = {}
    for row in out.values():
        for what, t in row.items():
            acc = totals.setdefault(what, dict(device_ms=0.0, host_ms=0.0))
            acc["device_ms"] += t["device_ms"]
            acc["host_ms"] += t["host_ms"]
    out["total"] = totals
    print("PAIR " + json.dumps(out), flush=True)
    return out


def conv_cases(blocks=BLOCKS, plain=PLAIN) -> list[tuple]:
    """The main path's calls of kernels A and B at ``blocks`` and ``plain``
    (the UNet's ConvBlocks and plain convs): (kernel, form, name, H=W, C
    in, F out, keep). A's forms: "identity" (conv1 forward with bias and
    statistics; a plain conv's forward with bias alone), "prologue"
    (conv2's forward through BN1 + LeakyReLU + the dropout of ``keep``,
    None: no dropout, with bias and statistics) and "dgrad" (conv1's or a
    plain conv's input gradient on the flip-transposed weights: C is the
    output cotangent's channels, F the input's); B's: "identity" (conv1's
    and the plain convs' weight gradients) and "prologue" (conv2's,
    recomputing its operand from h). The UpBlocks' conv1 runs K8 to K10,
    and the stem's dgrad only in SS-Net's VAT: neither is here."""
    out = []
    for name, hh, c, f, keep in blocks:
        if not name.startswith("up"):
            out.append(("A", "identity", f"{name}.conv1", hh, c, f, None))
            if name != "in_conv":
                out.append(("A", "dgrad", f"{name}.conv1", hh, f, c, None))
            out.append(("B", "identity", f"{name}.conv1", hh, c, f, None))
        out.append(("A", "prologue", f"{name}.conv2", hh, f, f, keep))
        out.append(("B", "prologue", f"{name}.conv2", hh, f, f, keep))
    for name, hh, c, f, _ in plain:
        out.append(("A", "identity", name, hh, c, f, None))
        out.append(("A", "dgrad", name, hh, f, c, None))
        out.append(("B", "identity", name, hh, c, f, None))
    return out


#: conv_cases' (kernel, form) as ops/conv_block.py conv_route's form
ROUTE_FORMS = {("A", "identity"): "conv", ("A", "dgrad"): "conv",
               ("A", "prologue"): "prologue", ("B", "identity"): "wgrad",
               ("B", "prologue"): "wgrad_prologue"}


def conv_kernel_times(batch: int = BATCH, cases=None) -> dict:
    """Kernels A (``conv3x3_nhwc``) and B (``conv3x3_wgrad_nhwc``) in bf16
    at each of the main path's calls (``conv_cases``, ACDC shapes at
    ``batch``): ms per call on the device alone (``device_ms``) and by
    phase 2's host-inclusive method (``cuda_ms``), and µs of host time to
    enqueue one call (``enqueue_us``), of the wrapper as a user calls it
    ("call", with the route it takes), of the mma.sync kernels through
    the launchers (``_launch_conv``, ``_launch_wgrad``: "mma"), of the
    wgmma kernels' launchers where the tree has them and C and F are
    multiples of 8 ("wgmma"), and of
    cuDNN ("cudnn": F.conv2d, conv2d_input's equal F.conv2d on the
    flipped weights, conv2d_weight, on channels_last views; for the
    prologue forms on the already-transformed operand, which is less
    work), each beside the bound (``conv_work``). It calls only the
    wrappers' long-standing arguments, so a copy of this file run from an
    earlier tree's root times that tree's kernels. Printed as one ``CONV``
    JSON line (with totals by kernel and form) and returned."""
    import torch
    import torch.nn.functional as F

    from hpfg_tpu_torch.ops import conv_block as cb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    dt = torch.bfloat16
    route_of = getattr(cb, "conv_route", None)
    sm90_conv = getattr(cb, "_launch_conv_sm90", None)
    sm90_wgrad = getattr(cb, "_launch_wgrad_sm90", None)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    out = {}
    for kernel, form, name, hh, c, f, keep in cases or conv_cases():
        x = randn(batch, hh, hh, c).to(dt)
        w = randn(3, 3, c, f, scale=(9 * c) ** -0.5).to(dt)
        bias = None if form == "dgrad" else randn(f, scale=0.1)
        stats = form == "prologue" or ".conv1" in name and form != "dgrad"
        affine = drop = None
        if form == "prologue":
            affine = (1.0 + randn(c, scale=0.1), randn(c, scale=0.1))
            drop = cb.HashDropout(99, keep) if keep else None
        z = cb._source(x, affine, drop).to(dt)  # the operand cuDNN is given
        pro = cb._prologue_args(affine, drop, c, batch, dev)
        y = torch.empty((batch, hh, hh, f), dtype=dt, device=dev)
        w_c = oihw(w)
        if kernel == "A":
            calls = {
                "call": lambda: cb.conv3x3_nhwc(x, w, bias, affine, drop,
                                                want_stats=stats),
                "mma": lambda: cb._launch_conv(x, w, y, bias=bias, pro=pro,
                                               want_sums=stats),
                "cudnn": lambda: F.conv2d(nchw(z), w_c, None if bias is None
                                          else bias.to(dt), padding=1)}
            if sm90_conv is not None and c % 8 == 0 and f % 8 == 0:
                calls["wgmma"] = lambda: sm90_conv(x, w, y, bias=bias,
                                                   pro=pro, want_sums=stats)
            work = conv_work(hh, c, f, 2, 2 * f if stats else 0, batch=batch)
        else:
            dp = randn(batch, hh, hh, f).to(dt)
            calls = {
                "call": lambda: cb.conv3x3_wgrad_nhwc(x, dp, affine, drop),
                "mma": lambda: cb._launch_wgrad(x, dp, pro=pro),
                "cudnn": lambda: torch.nn.grad.conv2d_weight(
                    nchw(z), (f, c, 3, 3), nchw(dp), padding=1)}
            if sm90_wgrad is not None and c % 8 == 0 and f % 8 == 0:
                calls["wgmma"] = lambda: sm90_wgrad(x, dp, pro=pro)
            work = conv_work(hh, c, f, 2, w_es=4, batch=batch)
        b_ms, b_by = bound(*work)
        # an earlier tree's rule may not take the width (K12's stem route)
        wide = ({"width": hh} if route_of and "width" in
                inspect.signature(route_of).parameters else {})
        row = dict(kernel=kernel, form=form, hh=hh, c=c, f=f, keep=keep,
                   route=(route_of(c, f, dt, True, ROUTE_FORMS[kernel, form],
                                   **wide) if route_of else "mma"),
                   bound_ms=b_ms, bound_by=b_by)
        for what, fn in calls.items():
            row[what] = dict(device_ms=device_ms(fn), host_ms=cuda_ms(fn),
                             enqueue_us=enqueue_us(fn))
        out[f"{kernel} {form} {name} {hh}^2 {c}->{f}"] = row
        del x, w, y, z, calls
        torch.cuda.empty_cache()
    totals = {}
    for row in list(out.values()):
        for key in (row["kernel"], f"{row['kernel']} {row['form']}"):
            acc = totals.setdefault(key, {"bound_ms": 0.0})
            acc["bound_ms"] += row["bound_ms"]
            for what in ("call", "mma", "wgmma", "cudnn"):
                if what in row:
                    t = acc.setdefault(what, dict(device_ms=0.0, host_ms=0.0))
                    t["device_ms"] += row[what]["device_ms"]
                    t["host_ms"] += row[what]["host_ms"]
    out["total"] = totals
    print("CONV " + json.dumps(out), flush=True)
    return out


def dgrad_cases(blocks=BLOCKS) -> list[tuple]:
    """The main path's K9 and K11 calls at ``blocks``: (kernel, name, H=W,
    F = the cotangent's channels, (Ca, Cb) of K9's two outputs or K11's C,
    keep of K11's output mask or None). K9 runs once per UpBlock backward
    (conv1's input gradient, split into skip and up), K11 once per
    ConvBlock backward (conv2's input gradient with the dropout of the
    encoder's blocks and BN1's backward sums)."""
    out = [("K9", name, hh, f, (c // 2, c - c // 2), None)
           for name, hh, c, f, _ in blocks if name.startswith("up")]
    out += [("K11", name, hh, f, f, keep) for name, hh, _, f, keep in blocks]
    return out


def dgrad_kernel_times(batch: int = BATCH, cases=None) -> dict:
    """K9 (``conv3x3_dgrad_pair``) and K11 (``conv3x3_dgrad_reduce``) in
    bf16 at each of the main path's calls (``dgrad_cases``, ACDC shapes at
    ``batch``): ms per call on the device alone (``device_ms``) and by
    phase 2's host-inclusive method (``cuda_ms``), and µs of host time to
    enqueue one call (``enqueue_us``), of the wrapper as a user calls it
    ("call", with the route it takes), of PR 4's mma.sync kernel through
    ``_launch_conv`` with its column sum ("mma"), of the wgmma launchers
    where the tree has them ("wgmma"), and of cuDNN's conv2d_input on
    channels_last views ("cudnn": the dgrad alone, without K9's split or
    K11's mask and reduce), each beside the bound (``conv_work``). It
    calls only the wrappers' long-standing arguments and
    ``_launch_conv``, so a copy of this file run from an earlier tree's
    root times that tree's kernels. Printed as one ``DGRAD`` JSON line
    (with totals by kernel) and returned."""
    import torch

    from hpfg_tpu_torch.ops import conv_block as cb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    dt = torch.bfloat16
    forms = getattr(cb, "CONV_FORMS", ())
    pair_sm90 = getattr(cb, "_launch_dgrad_pair_sm90", None)
    reduce_sm90 = getattr(cb, "_launch_dgrad_reduce_sm90", None)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    out = {}
    for kernel, name, hh, f, c, keep in cases or dgrad_cases():
        cs = sum(c) if kernel == "K9" else c
        dp = randn(batch, hh, hh, f).to(dt)
        w = randn(3, 3, cs, f, scale=(9 * cs) ** -0.5).to(dt)
        wf = cb.flip_transpose(w)
        w_c = oihw(w)
        calls = {"cudnn": lambda: torch.nn.grad.conv2d_input(
            (batch, cs, hh, hh), w_c, nchw(dp), padding=1)}
        if kernel == "K9":
            ca = c[0]
            dxa = torch.empty((batch, hh, hh, ca), dtype=dt, device=dev)
            dxb = torch.empty((batch, hh, hh, c[1]), dtype=dt, device=dev)
            calls["call"] = lambda: cb.conv3x3_dgrad_pair(dp, wf, ca)
            calls["mma"] = lambda: cb._launch_conv(dp, wf, dxa, y2=dxb)
            if pair_sm90 is not None and ca % 8 == 0 and c[1] % 8 == 0:
                calls["wgmma"] = lambda: pair_sm90(dp, wf, dxa, dxb)
            work = conv_work(hh, f, cs, 2, batch=batch)
            form, split = "dgrad_pair", ca
        else:
            pre = randn(batch, hh, hh, cs).to(dt)
            a, b = 1.0 + randn(cs, scale=0.1), randn(cs, scale=0.1)
            m, inv = randn(cs, scale=0.1), 1.0 + randn(cs, scale=0.1).abs()
            drop = cb.HashDropout(88, keep) if keep else None
            dd = torch.empty((batch, hh, hh, cs), dtype=dt, device=dev)
            red = (pre, a, b, m, inv)
            calls["call"] = lambda: cb.conv3x3_dgrad_reduce(
                dp, wf, pre, a, b, m, inv, out_drop=drop)
            calls["mma"] = lambda: cb._launch_conv(
                dp, wf, dd, out_drop=drop, reduce=red, want_sums=True)
            if reduce_sm90 is not None and cs % 8 == 0:
                calls["wgmma"] = lambda: reduce_sm90(dp, wf, dd, red, drop)
            n = batch * hh * hh * cs
            flops, nbytes = conv_work(hh, f, cs, 2, n, batch=batch)
            work = (flops + 8 * n, nbytes)
            form, split = "dgrad_reduce", None
        b_ms, b_by = bound(*work)
        row = dict(kernel=kernel, hh=hh, f=f, c=c, keep=keep,
                   route=(cb.conv_route(f, cs, dt, True, form, split)
                          if form in forms else "mma"),
                   bound_ms=b_ms, bound_by=b_by)
        for what, fn in calls.items():
            row[what] = dict(device_ms=device_ms(fn), host_ms=cuda_ms(fn),
                             enqueue_us=enqueue_us(fn))
        out[f"{kernel} {name} {hh}^2 {f}->{c}"] = row
        del dp, w, wf, calls
        torch.cuda.empty_cache()
    totals = {}
    for row in list(out.values()):
        acc = totals.setdefault(row["kernel"], {"bound_ms": 0.0})
        acc["bound_ms"] += row["bound_ms"]
        for what in ("call", "mma", "wgmma", "cudnn"):
            if what in row:
                t = acc.setdefault(what, dict(device_ms=0.0, host_ms=0.0))
                t["device_ms"] += row[what]["device_ms"]
                t["host_ms"] += row[what]["host_ms"]
    out["total"] = totals
    print("DGRAD " + json.dumps(out), flush=True)
    return out


def attention_cases() -> list[tuple]:
    """The main path's K13 and K14 shapes: (label, batch, stage, token
    side, heads, window, shifted). The ACDC SwinUNet's four stages at
    batch 32 (S4CVNet) and at Swin-MAE's 24, the LIDC SwinUNet's four at
    its 24 (L = 9); unshifted, and shifted where a stage has more than one
    window."""
    out = []
    for label, batch, stages, ws in (("acdc", BATCH, ATTN_STAGES, ATTN_WS),
                                     ("mae", MAE_BATCH, ATTN_STAGES, ATTN_WS),
                                     ("lidc", LIDC_SWIN_BATCH,
                                      LIDC_ATTN_STAGES, LIDC_WS)):
        for stage, side, heads in stages:
            for shifted in ((False, True) if side > ws else (False,)):
                out.append((label, batch, stage, side, heads, ws, shifted))
    return out


def attention_kernel_times(cases=None) -> dict:
    """K13 (``window_attention_fwd``) and K14 (``window_attention_bwd``) in
    bf16 with attention dropout at keep 0.9, at every main-path shape
    (``attention_cases``): ms per call on the device alone (``device_ms``)
    and by phase 2's host-inclusive method (``cuda_ms``), and µs of host
    time to enqueue one call (``enqueue_us``), of the wrapper as a user
    calls it ("call", with the route it takes where the tree routes) and,
    where the tree has them, of each route forced ("wgmma", "mma"); beside
    one SDPA call on the device alone (forward, and its autograd backward
    with the bias gradient; no dropout) and the bound (``attn_work``). It
    calls only the wrappers' long-standing arguments (and the route
    launchers where they exist), so a copy of this file run from an earlier
    tree's root times that tree's kernels. Printed as one ``ATTN`` JSON
    line (with totals by kernel and group) and returned."""
    import torch

    from hpfg_tpu_torch.models.swinunet import _shift_attention_mask
    from hpfg_tpu_torch.ops import window_attention as wa
    from hpfg_tpu_torch.ops.conv_block import HashDropout

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    dt = torch.bfloat16
    forced = getattr(wa, "_launch", None)
    route_of = getattr(wa, "attn_route", None)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    out = {}
    for label, batch, stage, side, heads, ws, shifted in (
            cases or attention_cases()):
        l, nw = ws * ws, (side // ws) ** 2
        bn, c = batch * nw, heads * ATTN_D
        qkv = randn(bn, l, 3 * c).to(dt)
        do = randn(bn, l, c).to(dt)
        bias = randn(heads, l, l, scale=0.02)
        mask = (torch.from_numpy(_shift_attention_mask(
            side, side, ws, ws // 2)).to(dev) if shifted else None)
        drop = HashDropout(66 + stage, 0.9)
        n_mask = 0 if mask is None else mask.shape[0]
        q, k, v = qkv.split(c, dim=-1)
        s_fwd, s_bwd = sdpa_ms(q, k, v, bias, mask, do, heads, device_ms)
        for kernel, backward in (("K13", False), ("K14", True)):
            args = ((qkv, bias, mask, do, heads, drop) if backward
                    else (qkv, bias, mask, heads, drop))
            fn = wa.window_attention_bwd if backward else \
                wa.window_attention_fwd
            calls = {"call": lambda fn=fn, args=args: fn(*args)}
            if forced is not None:
                for route in ("wgmma", "mma"):
                    if route == "mma" or route_of(
                            qkv.dtype, ATTN_D, l, True) == "wgmma":
                        calls[route] = (lambda route=route, args=args,
                                        backward=backward:
                                        forced(route, backward, *args))
            b_ms, b_by = bound(*attn_work(bn, heads, l, ATTN_D, 2, n_mask,
                                          backward))
            row = dict(kernel=kernel, group=label, batch=batch, stage=stage,
                       bn=bn, heads=heads, l=l, shifted=shifted,
                       route=(route_of(qkv.dtype, ATTN_D, l, True)
                              if route_of else "mma"),
                       sdpa_device_ms=s_bwd if backward else s_fwd,
                       bound_ms=b_ms, bound_by=b_by)
            for what, f in calls.items():
                row[what] = dict(device_ms=device_ms(f), host_ms=cuda_ms(f),
                                 enqueue_us=enqueue_us(f))
            out[f"{kernel} {label} stage {stage} "
                f"{'shifted' if shifted else 'unshifted'}"] = row
        del qkv, do, q, k, v
        torch.cuda.empty_cache()
    totals = {}
    for row in list(out.values()):
        for key in (row["kernel"], f"{row['kernel']} {row['group']}"):
            acc = totals.setdefault(key, {"bound_ms": 0.0,
                                          "sdpa_device_ms": 0.0})
            acc["bound_ms"] += row["bound_ms"]
            acc["sdpa_device_ms"] += row["sdpa_device_ms"] or 0.0
            for what in ("call", "wgmma", "mma"):
                if what in row:
                    t = acc.setdefault(what, dict(device_ms=0.0,
                                                  host_ms=0.0))
                    t["device_ms"] += row[what]["device_ms"]
                    t["host_ms"] += row[what]["host_ms"]
    out["total"] = totals
    print("ATTN " + json.dumps(out), flush=True)
    return out


#: K12's main-path shapes: (label, batch, side, C) of the bf16 stems,
#: F = 16 (ACDC and Synapse 224^2 at 32; LIDC 96^2 at 32; ISIC 224^2 at
#: 40; Building 512^2 at 12)
STEM_CASES = (("acdc", BATCH, HW, 1), ("lidc", 32, 96, 3),
              ("isic", 40, 224, 3), ("building", 12, 512, 3))


def bn_stem_kernel_times() -> dict:
    """K12 and C and D in bf16 at their main-path shapes: ms per call on
    the device alone (``device_ms``), host-inclusive (``cuda_ms``) and the
    µs to enqueue one wrapper call. K12 at ``STEM_CASES`` with its
    statistics: the wrapper ("call": K12's own kernel where the tree has
    it) and PR 4's mma.sync route ("mma"), beside cuDNN's F.conv2d alone
    and the bound; C (``bn_act``) and D
    (``bn_act_bwd``) at the five ACDC stages at batch 32: D's wrapper,
    PR 6's two kernels ("walk"), and where the tree has the cooperative
    kernel its forms ("hold" where dy and pre fit, "stream"), beside the
    bound (D: three passes). It calls the wrappers' long-standing
    arguments and the launchers a tree has, so a copy of this file run
    from an earlier tree's root times that tree's kernels. Printed as one
    ``BNSTEM`` JSON line (with totals) and returned."""
    import torch
    import torch.nn.functional as F

    from hpfg_tpu_torch.ops import bn_act as ba
    from hpfg_tpu_torch.ops import conv_block as cb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    dt = torch.bfloat16
    coop = getattr(ba, "_coop", None)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def timed(calls: dict, row: dict) -> dict:
        for what, fn in calls.items():
            row[what] = dict(device_ms=device_ms(fn), host_ms=cuda_ms(fn))
        row["call"]["enqueue_us"] = enqueue_us(calls["call"])
        return row

    out = {}
    for label, b, hw, c in STEM_CASES:
        f = 16
        x = randn(b, hw, hw, c).to(dt)
        w = randn(3, 3, c, f, scale=(9 * c) ** -0.5).to(dt)
        bias = randn(f, scale=0.1)
        y = torch.empty((b, hw, hw, f), device=dev, dtype=dt)
        calls = {"call": lambda: cb.conv3x3_nhwc(x, w, bias,
                                                 want_stats=True),
                 "mma": lambda: cb._launch_conv(x, w, y, bias=bias,
                                                want_sums=True)}
        xc, wc, bc = nchw(x), oihw(w), bias.to(dt)
        b_ms, b_by = bound(*conv_work(hw, c, f, 2, 2 * f, batch=b))
        out[f"K12 {label}"] = timed(calls, dict(
            kernel="K12", batch=b, side=hw, c=c, f=f,
            cudnn_device_ms=device_ms(lambda: F.conv2d(xc, wc, bc,
                                                       padding=1)),
            bound_ms=b_ms, bound_by=b_by))
        del x, y, xc
        torch.cuda.empty_cache()
    for name, hh, _, f, _ in BLOCKS[:5]:
        shape = (BATCH, hh, hh, f)
        n = BATCH * hh * hh * f
        g, dy = randn(*shape).to(dt), randn(*shape).to(dt)
        a, bb = 1.0 + randn(f, scale=0.1), randn(f, scale=0.1)
        m, inv = randn(f, scale=0.1), 1.0 + randn(f, scale=0.1).abs()
        args = (dy, g, a, bb, m, inv)
        out[f"C {name}"] = timed(
            {"call": lambda: ba.bn_act(g, a, bb)},
            dict(kernel="C", stage=name, bound_ms=2 * 2 * n / HBM_BYTES_PER_S
                 * 1e3))

        def walk():
            return ba._dpre(*args, ba._reduce(*args))

        calls = {"call": lambda: ba.bn_act_bwd(*args), "walk": walk}
        form = "walk"
        if coop is not None:
            form = bn_form(*args)
            for what in ("hold", "stream"):
                try:
                    ba._plan(dy, False, what)
                except ValueError:  # hold: does not fit
                    continue
                calls[what] = (lambda what=what: coop(
                    *args, torch.empty_like(dy), form=what))
        out[f"D {name}"] = timed(calls, dict(
            kernel="D", stage=name, route=form,
            bound_ms=3 * 2 * n / HBM_BYTES_PER_S * 1e3))
        del g, dy
        torch.cuda.empty_cache()
    totals = {}
    for row in list(out.values()):
        acc = totals.setdefault(row["kernel"], {"bound_ms": 0.0})
        acc["bound_ms"] += row["bound_ms"]
        if "cudnn_device_ms" in row:
            acc["cudnn_device_ms"] = (acc.get("cudnn_device_ms", 0.0)
                                      + row["cudnn_device_ms"])
        for what in ("call", "mma", "walk", "hold",
                     "stream"):
            if what in row:
                t = acc.setdefault(what, dict(device_ms=0.0, host_ms=0.0,
                                              shapes=0))
                t["device_ms"] += row[what]["device_ms"]
                t["host_ms"] += row[what]["host_ms"]
                t["shapes"] += 1
    out["total"] = totals
    print("BNSTEM " + json.dumps(out), flush=True)
    return out


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

                    def fwd_mma():  # the mma route, which fp32 keeps
                        return wa._launch("mma", False, qkv, bias, mask,
                                          heads, drop)

                    def bwd_mma():
                        return wa._launch("mma", True, qkv, bias, mask, do,
                                          heads, drop)

                    # timed in bf16 without dropout, where SDPA computes
                    # the same function
                    timed = bf16 and drop is None
                    ms = pms = lms = bms = bpms = blms = None
                    fx = bx = {}
                    if timed:
                        ms, pms = cuda_ms(fwd), cuda_ms(fwd_plain)
                        bms, bpms = cuda_ms(bwd), cuda_ms(bwd_plain)
                        lms, blms = sdpa_ms(q, k, v, bias, mask, do, heads)
                        dlms, dblms = sdpa_ms(q, k, v, bias, mask, do, heads,
                                              device_ms)
                        # (enqueue µs: attention_kernel_times)
                        fx = route_times(True, fwd, fwd_mma, None, dlms,
                                         enqueue=False)
                        bx = route_times(True, bwd, bwd_mma, None, dblms,
                                         enqueue=False)
                    route = wa.attn_route(dt, ATTN_D, l, True)
                    r = rep.compare("window_attention_fwd", f"{what} {tag}",
                                    dname, fwd(), fwd_plain(), ms, pms,
                                    library_ms=lms, main=timed,
                                    work=attn_work(bn, heads, l, ATTN_D, es,
                                                   n_mask, False),
                                    route=route, **fx)
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
                                        True) if g == "dbias" else None),
                        route=route, **(bx if g == "dbias" else {}))
                        for g in got)
                    if not torch.equal(bwd()[1], dbias):
                        rep.fail(f"window_attention_bwd {what} {tag} "
                                 f"{dname}: dbias differs between two runs")
                    if route == "wgmma":  # the mma route beside it
                        r = max(r, rep.compare(
                            "window_attention_fwd", f"{what} {tag} mma",
                            dname, fwd_mma(), fwd_plain(), main=False))
                        (dqkv, dbias) = bwd_mma()
                        rb = max(rb, *(rep.compare(
                            "window_attention_bwd", f"{what} {tag} {g} mma",
                            dname, a, want[g], main=False)
                            for g, a in zip(got, (*dqkv.split(c, -1),
                                                  dbias))))
                    line.append(f"{tag}: K13 {route} {r:.1e} K14 {rb:.1e}"
                                + (f" {times(ms, pms, lms)} / "
                                   f"{times(bms, bpms, blms)}ms" if timed
                                   else ""))
                    if timed:
                        rates = ("  K13 " + rate(attn_work(
                            bn, heads, l, ATTN_D, es, n_mask, False), ms)
                            + route_note(fx) + "; K14 " + rate(attn_work(
                                bn, heads, l, ATTN_D, es, n_mask, True), bms)
                            + route_note(bx))
                print(" | ".join(line), flush=True)
                if bf16:
                    print(rates, flush=True)
            del qkv, do, q, k, v
            torch.cuda.empty_cache()


def sdpa_ms(q, k, v, bias, mask, do, heads, clock=None):
    """The library yardstick of K13 and K14 in ms (by ``clock``: phase 2's
    ``cuda_ms`` by default, or ``device_ms``): one
    F.scaled_dot_product_attention call on [Bn, H, L, D] with attn_mask =
    bias + mask, and the autograd backward of that call for q, k, v and the
    bias (the attn_mask gradient summed over windows). (None, None) if the
    call fails."""
    import torch
    import torch.nn.functional as F

    bn, l, c = q.shape

    def heads_first(t):
        return t.reshape(bn, l, heads, c // heads).transpose(1, 2).contiguous()

    clock = clock or cuda_ms
    try:
        qh, kh, vh, doh = (heads_first(t) for t in (q, k, v, do))
        full = bias[None] if mask is None else (
            bias[None] + mask.repeat(bn // mask.shape[0], 1, 1)[:, None])
        am = full.to(q.dtype)
        fwd_ms = clock(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=am))
        leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
        b_leaf = bias.detach().to(q.dtype).requires_grad_(True)
        am_g = b_leaf[None] if mask is None else (
            b_leaf[None] + mask.repeat(bn // mask.shape[0], 1, 1)[:, None]
            .to(q.dtype))
        out = F.scaled_dot_product_attention(*leaves, attn_mask=am_g)
        bwd_ms = clock(lambda: torch.autograd.grad(
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


def predicted_attention(algo, steps: int, fwd_models, bwd_models,
                        by_route: bool = False) -> dict:
    """K13 and K14 launches per run: one K13 for each WindowAttention of the
    models that forward a step (``fwd_models``), one K14 for each of those
    that also backward (``bwd_models``). ``by_route``: the launches by
    route, each WindowAttention's by ``attn_route`` of the algorithm's
    compute dtype, its head width and window (wgmma for every bf16 one of
    the configs: D = 32; the tensors are aligned)."""
    from hpfg_tpu_torch.models.swinunet import WindowAttention
    from hpfg_tpu_torch.ops import window_attention as wa

    def mods(attr):
        return [m for m in getattr(algo, attr).modules()
                if isinstance(m, WindowAttention)]

    def count(models):
        if not by_route:
            return steps * sum(len(mods(a)) for a in models)
        out = dict.fromkeys(wa.ROUTES, 0)
        for a in models:
            for m in mods(a):
                out[wa.attn_route(algo.dtype, m.dim // m.heads,
                                  m.ws * m.ws, True)] += steps
        return out

    return {"window_attention_fwd": count(fwd_models),
            "window_attention_bwd": count(bwd_models)}


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
            "bn_reduce": ba.bn_reduce,
            "window_attention_fwd": wa.window_attention_fwd,
            "window_attention_bwd": wa.window_attention_bwd}


def route_counters() -> dict:
    """The wrappers whose launches each route counts too (A, B, K8 to
    K11, K13, K14, D): ``fn.routes[route].launches``."""
    from hpfg_tpu_torch.ops import bn_act as ba
    from hpfg_tpu_torch.ops import conv_block as cb
    from hpfg_tpu_torch.ops import window_attention as wa

    return {"bn_act_bwd": ba.bn_act_bwd, "bn_reduce": ba.bn_reduce,
            "window_attention_fwd": wa.window_attention_fwd,
            "window_attention_bwd": wa.window_attention_bwd,
            "conv3x3_nhwc": cb.conv3x3_nhwc,
            "conv3x3_wgrad_nhwc": cb.conv3x3_wgrad_nhwc,
            "conv3x3_pair_nhwc": cb.conv3x3_pair_nhwc,
            "conv3x3_wgrad_pair": cb.conv3x3_wgrad_pair,
            "conv3x3_dgrad_pair": cb.conv3x3_dgrad_pair,
            "conv3x3_dgrad_reduce": cb.conv3x3_dgrad_reduce}


def predicted_routes(model, dtype, steps: int, forwards: int, backwards: int,
                     inner_backwards: int = 0, width: int = HW) -> dict:
    """A's, B's, K9's and K11's launches by route per run, walking the
    convs that ``predicted_launches`` counts: a call takes wgmma where its
    compute dtype is bf16 and its C and F (and K9's split) are multiples
    of 8, else mma (the C = 1 and 3 stems, the F = 4, 2 and 9 heads and
    their dgrads, fp32), and B's prologue form (conv2's) below
    WGRAD_PROLOGUE_MIN_C channels mma (ops/conv_block.py's static rule
    from the card's timings: the 224^2 stage). A forward runs A on each
    ConvBlock's conv1 (not an UpBlock's, which is K8) and conv2 and on
    each plain conv (an UpBlock's 1x1, the
    head); a backward K11 on each ConvBlock's conv2, K9 on each UpBlock's
    conv1, A's dgrad on the other conv1s (but the stem's) and each plain
    conv, and B on each conv1 (not an UpBlock's), conv2 and plain conv; a
    backward to the input K11 and K9 as a backward does, A's dgrad on
    every other conv1 (the stem's too) and plain conv. A stem's forward
    (C = 1 or 3 into 16 or 32, bf16, rows of ``width`` pixels in whole
    16-byte units) takes "stem", K12's kernel (``stem_ok``)."""
    import torch

    from hpfg_tpu_torch.models.layers import ConvBlock, UpBlock
    from hpfg_tpu_torch.ops.conv_block import WGRAD_PROLOGUE_MIN_C, stem_ok

    a, b = "conv3x3_nhwc", "conv3x3_wgrad_nhwc"
    k9, k11 = "conv3x3_dgrad_pair", "conv3x3_dgrad_reduce"
    out = {k: {"wgmma": 0, "mma": 0} for k in (a, b, k9, k11)}
    out[a]["stem"] = 0
    if model is None:
        return out
    bf16 = dtype == torch.bfloat16

    def add(kernel, c, f, n, prologue=False, split=0):
        route = ("stem" if kernel == a and stem_ok(c, f, dtype, True, width)
                 else
                 "wgmma" if bf16 and c % 8 == 0 and f % 8 == 0
                 and split % 8 == 0
                 and not (prologue and kernel == b
                          and c < WGRAD_PROLOGUE_MIN_C)
                 else "mma")
        out[kernel][route] += steps * n

    ups = [m for m in model.modules() if isinstance(m, UpBlock)]
    in_up = {id(u.conv): u for u in ups}
    blocks = [m for m in model.modules() if isinstance(m, ConvBlock)]
    stem = next(b for b in blocks if id(b) not in in_up)
    heads = [m for n, m in model.named_modules()
             if n.split(".")[-1] == "out_conv"]
    plain = [u.conv1x1.kernel.shape[2:] for u in ups] + [
        h.kernel.shape[2:] for h in heads]
    grads = backwards + inner_backwards  # backwards that reach K9 and K11
    for blk in blocks:
        c, f = blk.conv1.kernel.shape[2:]
        add(a, f, f, forwards)
        add(b, f, f, backwards, prologue=True)
        add(k11, f, f, grads)
        if id(blk) in in_up:
            skip = c - in_up[id(blk)].conv1x1.kernel.shape[3]
            add(k9, f, c, grads, split=skip)
        else:
            add(a, c, f, forwards)
            add(b, c, f, backwards)
            add(a, f, c, inner_backwards + (backwards if blk is not stem
                                            else 0))
    for c, f in plain:
        add(a, c, f, forwards)
        add(a, f, c, backwards + inner_backwards)
        add(b, c, f, backwards)
    return out


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
        for fn in route_counters().values():
            for c in fn.routes.values():
                c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.total_itrs = WARMUP + STEPS
        t0 = time.perf_counter()
        trainer.fit(eval_enabled=False)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters().items()}
        routes = {k: {r: c.launches for r, c in fn.routes.items()}
                  for k, fn in route_counters().items()}
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
                and launched(meta, launches, routes) == 0):
            rep.fail(f"{label} path: kernel {name} was not launched")
    # every K8 and K10 launch of the path on the wgmma route (bf16,
    # aligned), and every A and B launch whose C and F are multiples of 8
    want = predicted_routes(getattr(algo, path.unet) if path.unet else None,
                            algo.dtype, STEPS, path.forwards,
                            path.backwards, path.inner_backwards,
                            width=crop(cfg))
    want.update(predicted_attention(algo, STEPS, path.attn_fwd,
                                    path.attn_bwd, by_route=True))
    for name, by_route in routes.items():
        print(f"{label} routes {name}: {by_route}"
              + (f" (predicted {want[name]})" if name in want else ""),
              flush=True)
        if name in want:
            if by_route != want[name]:
                rep.fail(f"{label} path: {name} launches by route "
                         f"{by_route} != predicted {want[name]}")
        elif name in ("bn_act_bwd", "bn_reduce"):
            # D: one cooperative launch a call (hold or stream), never PR
            # 6's two (the UNets' F are multiples of 8)
            if by_route["walk"] or (by_route["hold"] + by_route["stream"]
                                    != launches[name]):
                rep.fail(f"{label} path: {name} launches off the "
                         f"cooperative kernel: {by_route} of "
                         f"{launches[name]}")
        elif by_route["wgmma"] != launches[name] or by_route["mma"]:
            rep.fail(f"{label} path: {name} launches off the wgmma route: "
                     f"{by_route} of {launches[name]}")
    busy, conv, bn, step_launches, families = profile_step(trainer, card,
                                                           label)
    if families is not None and path.unet:
        # the traced step's device launches of the conv kernels by route
        # against the wrappers' route counts of a step
        want_dev = {
            fam: sum(routes[k][r] for k in kernels for r in rs) // STEPS
            for fam, rs, kernels in (
                ("conv_sm90", ("wgmma",), ("conv3x3_nhwc",
                                           "conv3x3_pair_nhwc",
                                           "conv3x3_dgrad_pair",
                                           "conv3x3_dgrad_reduce")),
                ("conv_sm90 reduce", ("wgmma",), ("conv3x3_dgrad_reduce",)),
                ("conv3x3", ("mma",), ("conv3x3_nhwc", "conv3x3_pair_nhwc",
                                       "conv3x3_dgrad_pair",
                                       "conv3x3_dgrad_reduce")),
                # K12 and D: one launch a call, PR 6's kernels for none
                ("stem_sm90", ("stem",), ("conv3x3_nhwc",)),
                ("bn_coop", ("hold", "stream"), ("bn_act_bwd",
                                                 "bn_reduce")),
                ("bn_reduce", ("walk",), ("bn_act_bwd", "bn_reduce")))}
        want_dev["bn_dpre"] = (launches["bn_act_dpre"]
                               + routes["bn_act_bwd"]["walk"]) // STEPS
        # the stem's statistics are summed in its kernel
        want_dev["colsum after stem"] = 0
        print(f"{label} traced device launches by family: {families} "
              f"(predicted {want_dev}; {step_launches} in all)", flush=True)
        for fam, n in want_dev.items():
            if families[fam] != n:
                rep.fail(f"{label} path: the traced step launched "
                         f"{families[fam]} {fam} kernels, predicted {n}")
    if families is not None and path.attn_fwd:
        # the traced step's K13 and K14 launches by route against the
        # wrappers' route counts of a step; K14 on wgmma sums dbias in the
        # kernel, so a path without a UNet launches no column sum
        att = ("window_attention_fwd", "window_attention_bwd")
        want_att = {fam: sum(routes[k][r] for k in att) // STEPS
                    for fam, r in (("attn_sm90", "wgmma"),
                                   ("attn mma", "mma"))}
        if not path.unet and not routes["window_attention_bwd"]["mma"]:
            want_att["colsum"] = 0
        print(f"{label} traced attention launches: "
              f"{ {k: families[k] for k in want_att} } (predicted "
              f"{want_att}; {step_launches} in all)", flush=True)
        for fam, n in want_att.items():
            if families[fam] != n:
                rep.fail(f"{label} path: the traced step launched "
                         f"{families[fam]} {fam} kernels, predicted {n}")
    ms = elapsed / STEPS * 1e3
    imgs = images * STEPS / elapsed
    print(f"{label} path: {algo.name} {crop(cfg)}^2 {images} images a step "
          f"{str(algo.dtype).split('.')[-1]}: "
          f"{ms:.2f} ms/step, {imgs:.1f} img/s, peak {peak:.2f} GiB "
          f"allocated ({card})", flush=True)
    summary = dict(ms_per_step=ms, img_per_s=imgs, images_per_step=images,
                   peak_gib=peak, traced_busy_ms=busy, traced_conv_ms=conv,
                   traced_bn_ms=bn, traced_device_launches=step_launches,
                   traced_launches_by_family=families,
                   busy_share=(busy / ms if busy is not None else None),
                   launches_by_route=routes)
    return launches, algo, summary


def profile_step(trainer, card: str, label: str):
    """One more step under torch.profiler: device time by kernel name and
    the device's busy share of the step's wall time (profiler on). Returns
    (busy ms, ms of the conv kernels A, B, K8-K12, ms of kernels C and D,
    device kernels, copies and memsets in the step, launches by family:
    "conv_sm90" the wgmma conv (A, K8, K9, K11), "conv_sm90 reduce" its
    K11 instantiations, "conv3x3" PR 4's conv kernels, "colsum" the column
    sums, "stem_sm90" K12's kernel, "bn_coop" D's cooperative kernel,
    "bn_reduce" and "bn_dpre" PR 6's, "colsum after stem" the column sums
    that follow a stem kernel), or Nones when the profiler saw no device
    time."""
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
        return None, None, None, None, None
    by_name: dict[str, list] = {}
    for e in kernels:
        row = by_name.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += e.time_range.end - e.time_range.start
    busy = sum(v[1] for v in by_name.values())
    # the port's conv kernels by name (cuDNN's, on the CTCT path's
    # SegFormer, have "wgrad" in theirs too)
    conv = sum(v[1] for k, v in by_name.items()
               if re.search(r"\b(conv3x3|wgrad|conv_sm90|wgrad_sm90|stem_sm90)"
                            r"(_bf16)?_kernel\b", k))
    bn = sum(v[1] for k, v in by_name.items()
             if any(f"bn_{n}_kernel" in k
                    for n in ("act", "reduce", "dpre", "coop")))
    launches = sum(v[0] for v in by_name.values())
    families = {fam: sum(v[0] for k, v in by_name.items()
                         if re.search(pattern, k))
                for fam, pattern in (
                    ("conv_sm90", r"\bconv_sm90_kernel<"),
                    # EPI_REDUCE (2), csrc/conv3x3_sm90.cu's K11 epilogue
                    ("conv_sm90 reduce",
                     r"\bconv_sm90_kernel<\d+, \w+, \w+, 2>"),
                    ("conv3x3", r"\bconv3x3(_bf16)?_kernel\b"),
                    ("colsum", r"\bcolsum_kernel\b"),
                    # K13 and K14: csrc/window_attention_sm90.cu's, and
                    # csrc/window_attention.cu's (bf16 and fp32)
                    ("attn_sm90", r"\battn_(fwd|bwd)_sm90_kernel<"),
                    ("attn mma", r"\battn_(fwd|bwd)(_bf16)?_kernel<"),
                    # K12's kernel; D's cooperative kernel and PR 6's two
                    ("stem_sm90", r"\bstem_sm90_kernel<"),
                    ("bn_coop", r"\bbn_coop_kernel<"),
                    ("bn_reduce", r"\bbn_reduce_kernel<"),
                    ("bn_dpre", r"\bbn_dpre_kernel<"))}
    # a column sum launched right after a stem kernel (its statistics'
    # second pass, which K12's kernel has no more)
    order = sorted(kernels, key=lambda e: e.time_range.start)
    families["colsum after stem"] = sum(
        1 for e, nxt in zip(order, order[1:])
        if "stem_sm90_kernel" in e.name and "colsum_kernel" in nxt.name)
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
    return busy / 1e3, conv / 1e3, bn / 1e3, launches, families


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
# phase 19: the loss library on the card
# ---------------------------------------------------------------------------

#: the losses of ``ops/losses.py`` that no algorithm calls, and
#: ``softmax_kl_loss``: label -> (function, first argument, other arguments,
#: keywords); the arguments are derived from the logits (``loss_inputs``)
LOSS_CASES = {
    "dice_loss_from_probs": ("dice_loss_from_probs", "probs",
                             ("target_probs",), {}),
    "softmax_dice_loss": ("softmax_dice_loss", "logits", ("target",), {}),
    "dice_loss_binary": ("dice_loss_binary", "probs1", ("mask",), {}),
    "softmax_kl_loss": ("softmax_kl_loss", "logits", ("target",), {}),
    "softmax_kl_loss sigmoid": ("softmax_kl_loss", "logits", ("target",),
                                {"sigmoid": True}),
    "symmetric_mse_loss": ("symmetric_mse_loss", "logits", ("target",), {}),
    "entropy_loss": ("entropy_loss", "probs", (), {"num_classes": 4}),
    "entropy_loss_map": ("entropy_loss_map", "probs", (),
                         {"num_classes": 4}),
    "focal_loss": ("focal_loss", "logits", ("labels",), {}),
    "focal_loss alpha sum": ("focal_loss", "logits", ("labels",),
                             {"alpha": [0.1, 0.2, 0.3, 0.4],
                              "size_average": False}),
    "bce_dice_loss": ("bce_dice_loss", "logits1", ("mask",), {}),
    "bce_dice_l1_loss": ("bce_dice_l1_loss", "logits1", ("mask",), {}),
}
#: the losses' tolerance against the CPU, relative to the largest
#: magnitude: fp32 another summation order over 6.4M elements; bf16 logits
#: rounded once more where a gradient is cast back to them
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def loss_inputs(logits, target, labels, mask) -> dict:
    """Every argument of ``LOSS_CASES`` from the student's ``logits`` (the
    gradient's leaf), the teacher's ``target`` logits, the labels and a
    binary mask: probabilities by softmax, the binary losses on the first
    class's channel."""
    import torch

    return {"logits": logits, "target": target, "labels": labels,
            "mask": mask, "probs": torch.softmax(logits.float(), dim=-1),
            "target_probs": torch.softmax(target.float(), dim=-1),
            "logits1": logits[..., :1],
            "probs1": torch.sigmoid(logits[..., :1].float())}


def run_loss(case: str, leaf, fixed: dict):
    """(value, gradient of ``leaf``) of one loss on a fresh copy of the
    logits ``leaf``; a map's gradient is that of its mean."""
    from hpfg_tpu_torch.ops import losses

    fn, first, rest, kwargs = LOSS_CASES[case]
    x = leaf.detach().clone().requires_grad_(True)
    args = loss_inputs(x, **fixed)
    out = getattr(losses, fn)(args[first], *(args[k] for k in rest),
                              **kwargs)
    (out.mean() if out.dim() else out).backward()
    return out.detach(), x.grad


def check_losses(rep: Report, dev, card: str) -> dict:
    """The loss library on the card in fp32 and bf16 on the Mean-Teacher
    UNet's logits (configs/mean_teacher_unet_30k_224x224_ACDC.yaml, bf16,
    8 + 24 images at 224^2, 4 classes: the student's train-mode forward
    through A, C and K8, the EMA teacher's as the target), each value and
    gradient against the same loss on a CPU copy of its inputs; then the
    sum of the losses back through the student (B, D, K9 to K11), every
    one of A to D launched. Returns each loss's card ms (forward and
    backward, the derivation of its inputs included) by dtype."""
    import numpy as np
    import torch

    from hpfg_tpu_torch.ops import losses
    from hpfg_tpu_torch.train.algorithms import build_algorithm

    cfg = load_config(MT_CONFIG)
    algo = build_algorithm(cfg["algorithm"], cfg, dtype=torch.bfloat16,
                           device=dev)
    rng = np.random.default_rng(19)
    n = algo.label_bs + algo.unlabel_bs
    x = torch.from_numpy(rng.normal(size=(n, HW, HW, 1)).astype(
        np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 4, (n, HW, HW))).to(dev)
    mask = (torch.rand(n, HW, HW, 1, generator=torch.Generator().manual_seed(
        19)) < 0.4).float().to(dev)
    for fn in counters().values():
        fn.launches = 0
    kw = algo.train_kwargs(algo.label_bs, algo.unlabel_bs)
    with torch.no_grad():
        target = algo.ema(x, **kw)
    logits = algo.model(x, **kw)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        leaf = logits.detach().to(dtype)
        fixed = dict(target=target.to(dtype), labels=labels, mask=mask)
        fixed_cpu = {k: v.cpu() for k, v in fixed.items()}
        tol = LOSS_TOL[name]
        for case in LOSS_CASES:
            value, grad = run_loss(case, leaf, fixed)
            ref, ref_grad = run_loss(case, leaf.cpu(), fixed_cpu)
            errs = [((got.cpu().float() - want.float()).abs().max()
                     / want.float().abs().max().clamp(min=1e-30)).item()
                    for got, want in ((value, ref), (grad, ref_grad))]
            finite = bool(value.isfinite().all() and grad.isfinite().all())
            ms = cuda_ms(lambda: run_loss(case, leaf, fixed))
            out.setdefault(name, {})[case] = dict(
                value_err=errs[0], grad_err=errs[1], ms=ms)
            shown = (f"{value.item():.6g} (cpu {ref.item():.6g})"
                     if value.dim() == 0 else f"map {tuple(value.shape)}")
            print(f"losses {case} {name}: value {shown}, value rel err "
                  f"{errs[0]:.2e}, grad rel err {errs[1]:.2e} (tol {tol}); "
                  f"{ms:.3f} ms forward + backward on the card ({card})",
                  flush=True)
            if not finite or max(errs) > tol:
                rep.fail(f"losses {case} {name}: value err {errs[0]:.3e}, "
                         f"grad err {errs[1]:.3e} > {tol} or not finite")
    args = loss_inputs(logits, target, labels, mask)
    total = sum(getattr(losses, fn)(
        args[first], *(args[k] for k in rest), **kwargs).float().mean()
        for fn, first, rest, kwargs in LOSS_CASES.values())
    total.backward()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    print(f"losses: the Mean-Teacher UNet's forwards and the losses' "
          f"backward launched {launches}", flush=True)
    for kernel in ("conv3x3_nhwc", "conv3x3_wgrad_nhwc", "bn_act",
                   "bn_act_bwd"):
        if launches[kernel] == 0:
            rep.fail(f"losses: kernel {kernel} was not launched")
    out["launches"] = launches
    return out


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
# phases 10-14: the HDF5 trees, the ACDC CLI, the prefetcher, the overlapped
# eval and the multi-model volume eval
# ---------------------------------------------------------------------------

#: the synthetic ACDC tree of phases 10-13: 160 slices (label_num 0.05 of
#: the configs: 8 labelled, enough for batch 8, and 152 unlabelled for 24),
#: 2 test and 2 val volumes of 6 slices, at ACDC's 256 x 216
ACDC_SLICES, ACDC_VOLUMES, ACDC_DEPTH, ACDC_HW = 160, 2, 6, (256, 216)
#: the test split of the tree that phases 13 and 14 time the eval on, at
#: the size of ACDC's as the configs read it (SSL4MIS preparation: 20 test
#: patients, end-diastolic and end-systolic frames, so 40 volumes; 10
#: slices a volume, the 1,312 training slices of 140 volumes rounded)
ACDC_EVAL_VOLUMES, ACDC_EVAL_DEPTH = 40, 10
#: phase 18's own test split: fewer volumes (its check is the ranks'
#: results bitwise against one process's, which 10 volumes, shared 5 / 5,
#: test as well as 40; the ACDC-size split stays with phases 13-14)
SHARDED_EVAL_VOLUMES = 10
#: the eval models each ACDC CLI run must log at both boundaries
CLI_ACDC = {MT_CONFIG: ("model1", "model2"),
            HPFG_CONFIG: ("model1", "model2", "ema")}
#: a CLI run in which h5py cannot import
NO_H5PY = ("import runpy, sys; sys.modules['h5py'] = None; "
           "runpy.run_module('hpfg_tpu_torch.run', run_name='__main__', "
           "alter_sys=True)")
PREFETCH_STEPS = 6
ASYNC_ITERS, ASYNC_EVERY = 4, 2
#: the timing runs of phase 13: one boundary after ASYNC_BEFORE steps, then
#: steps until the eval is over and ASYNC_AFTER more (at most ASYNC_CAP in
#: all)
ASYNC_BEFORE, ASYNC_AFTER, ASYNC_CAP = 10, 10, 4000


def check_h5(rep: Report, card: str, root: str) -> dict:
    """The committed h5 fixtures through the port's reader (each dataset's
    shape, dtype and sha256 as listed), the decode rate on the gzip +
    shuffle volume and on a contiguous ACDC volume, and the synthetic ACDC
    tree of phases 11-14 written by the port's writer into ``root`` and
    read back."""
    import numpy as np

    from hpfg_tpu_torch.data import h5
    from hpfg_tpu_torch.data.synthetic import make_synthetic_acdc

    rows = h5.check_fixtures()
    for r in rows:
        print(f"h5 fixture {r['file']}/{r['dataset']} {r['dtype']}"
              f"{r['shape']}: sha256 {r['sha256'][:16]}... "
              f"{'as listed' if r['ok'] else 'DIFFERS'}", flush=True)
    if len(rows) != 6 or not all(r["ok"] for r in rows):
        rep.fail(f"h5 fixtures: {rows}")

    def rate(path, reps):
        f = h5.File(path)
        nbytes = f["image"][()].nbytes + f["label"][()].nbytes
        t0 = time.perf_counter()
        for _ in range(reps):
            f = h5.File(path)
            f["image"][()], f["label"][()]
        return nbytes, nbytes * reps / (time.perf_counter() - t0) / 1e6

    t0 = time.perf_counter()
    make_synthetic_acdc(root, n_train_slices=ACDC_SLICES,
                        n_test_volumes=ACDC_VOLUMES, depth=ACDC_DEPTH,
                        hw=ACDC_HW)
    write_s = time.perf_counter() - t0
    files = [os.path.join(d, n) for d, _, names in os.walk(root)
             for n in names if n.endswith(".h5")]
    t0 = time.perf_counter()
    bad = []
    for path in files:
        f = h5.File(path)
        image, label = f["image"][()], f["label"][()]
        ndim = 2 if os.sep + "slices" + os.sep in path else 3
        if (image.dtype != np.float32 or label.dtype != np.uint8
                or image.shape != label.shape or image.ndim != ndim
                or tuple(image.shape[-2:]) != ACDC_HW
                or not np.isfinite(image).all() or label.max() > 3):
            bad.append(path)
    read_s = time.perf_counter() - t0
    probe = np.random.default_rng(0).normal(size=(3, 5, 7)).astype(np.float32)
    mask = (probe > 0).astype(np.uint8)
    h5.write(os.path.join(root, "probe.h5"), {"image": probe, "label": mask})
    back = h5.File(os.path.join(root, "probe.h5"))
    round_trip = (np.array_equal(back["image"][()], probe)
                  and np.array_equal(back["label"][()], mask))
    os.remove(os.path.join(root, "probe.h5"))
    if bad or not round_trip or len(files) != ACDC_SLICES + 2 * ACDC_VOLUMES:
        rep.fail(f"h5: {len(files)} files, unreadable or wrong: {bad[:3]}, "
                 f"round trip {round_trip}")
    gz_bytes, gz_rate = rate(h5.FIXTURES / "gzip_shuffle_volume.h5", 50)
    with open(os.path.join(root, "test.list")) as f:
        vol = os.path.join(root, "data", f.readline().strip() + ".h5")
    vol_bytes, vol_rate = rate(vol, 20)
    print(f"h5: ACDC tree of {len(files)} files ({ACDC_SLICES} slices, "
          f"{2 * ACDC_VOLUMES} volumes of {ACDC_DEPTH} x {ACDC_HW}) written "
          f"in {write_s:.1f} s, read back in {read_s:.1f} s; round trip "
          f"{'bitwise' if round_trip else 'DIFFERS'}; decode "
          f"{gz_rate:.1f} MB/s on the gzip + shuffle volume ({gz_bytes} "
          f"bytes decoded), {vol_rate:.1f} MB/s on a contiguous volume "
          f"({vol_bytes} bytes) ({card})", flush=True)
    return dict(fixtures=rows, files=len(files), write_s=write_s,
                read_s=read_s, gzip_mb_per_s=gz_rate, gzip_bytes=gz_bytes,
                contiguous_mb_per_s=vol_rate, contiguous_bytes=vol_bytes)


def write_eval_tree(card: str, root: str,
                    volumes: int = ACDC_EVAL_VOLUMES) -> str:
    """The synthetic ACDC tree with a test split of ``volumes`` volumes of
    ACDC_EVAL_DEPTH slices (by default ACDC's size), through the port's
    writer; returns ``root``."""
    from hpfg_tpu_torch.data.synthetic import make_synthetic_acdc

    t0 = time.perf_counter()
    make_synthetic_acdc(root, n_train_slices=ACDC_SLICES,
                        n_test_volumes=volumes,
                        depth=ACDC_EVAL_DEPTH, hw=ACDC_HW)
    print(f"acdc eval tree: {ACDC_SLICES} slices, {volumes} test "
          f"and {volumes} val volumes of {ACDC_EVAL_DEPTH} x "
          f"{ACDC_HW} written in {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    return root


def _cli(args: list, timeout: int = 600):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", NO_H5PY, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    return proc, time.perf_counter() - t0


def check_cli_acdc(rep: Report, card: str, root: str, tmp: str) -> dict:
    """The ACDC Mean-Teacher and HPFG configs, unmodified but for
    data_path, save_path, total_itrs = 4 and step_size = 2, through
    ``python -m hpfg_tpu_torch.run`` on the card from the h5 tree, in a
    process where h5py cannot import: every eval model's dice at 2 and 4,
    ``done: 4 iters``, ``last.pt``, ``last_a`` / ``last_b``, ``best_*`` of
    each model whose dice rose above 0, and a TensorBoard event file or the
    writer's no-op line; then ``--validate-data``: exit 0 on the tree, 1 on
    a copy in which one slice lost its label."""
    import shutil

    from hpfg_tpu_torch.data import h5

    out = {}
    for config, models in CLI_ACDC.items():
        save = os.path.join(tmp, "run_" + os.path.basename(config)[:-5])
        proc, run_s = _cli(["--config", config, "--set",
                            f"data_path={root}", "--set",
                            f"save_path={save}", "--set", "total_itrs=4",
                            "--set", "step_size=2"])
        log = proc.stdout + proc.stderr
        ckpts = sorted(f[:-3] for f in os.listdir(os.path.join(save, "model"))
                       ) if os.path.isdir(os.path.join(save, "model")) else []
        tb_dir = os.path.join(save, "tensorboardX")
        events = [f for f in (os.listdir(tb_dir) if os.path.isdir(tb_dir)
                              else []) if f.startswith("events.out")]
        backend = re.search(r"TensorBoard: (\S+)", log)
        noop = "the writer is a no-op" in log
        dice = {m: [float(x) for x in re.findall(
            rf"iter \d+ {m} dice ([0-9.]+)", log)] for m in models}
        want = [f"iter {i} {m} dice" for i in (2, 4) for m in models]
        want.append("done: 4 iters")
        missing = [k for k in want if k not in log]
        need = {"last", "last_a", "last_b"} | {
            f"best_{m}" for m in models if max(dice[m], default=0) > 0}
        lacking = sorted(need - set(ckpts))
        if (proc.returncode != 0 or missing or lacking
                or not any(c.startswith("best_") for c in ckpts)
                or not (events or noop)):
            rep.fail(f"cli acdc {config}: exit {proc.returncode}, missing "
                     f"{missing}, checkpoints {ckpts} lack {lacking}, TB "
                     f"events {events}, no-op line {noop}; log tail: "
                     f"{log[-1500:]}")
        print(f"cli acdc: {config} (4 iters, eval every 2, prefetch 2, "
              f"async eval, h5py blocked) exit {proc.returncode} in "
              f"{run_s:.1f} s ({card}); checkpoints {ckpts}; TensorBoard "
              f"{backend.group(1) if backend else 'no-op' if noop else '?'}"
              f" ({len(events)} event file(s))", flush=True)
        for line in log.splitlines():
            if " dice " in line or "done:" in line or "Error" in line:
                print(f"  cli acdc: {line[-150:]}", flush=True)
        out[config] = dict(exit=proc.returncode, run_s=run_s,
                           checkpoints=ckpts, dice=dice,
                           tensorboard=backend.group(1) if backend else None,
                           event_files=len(events))
        shutil.rmtree(save, ignore_errors=True)
    broken = os.path.join(tmp, "acdc_broken")
    shutil.copytree(root, broken)
    with open(os.path.join(broken, "train_slices.list")) as f:
        first = os.path.join(broken, "data", "slices",
                             f.readline().strip() + ".h5")
    h5.write(first, {"image": h5.File(first)["image"][()]})
    codes = {}
    for name, tree in (("synthetic", root), ("broken", broken)):
        proc, _ = _cli(["--config", MT_CONFIG, "--set", f"data_path={tree}",
                        "--validate-data"], timeout=300)
        codes[name] = proc.returncode
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[validate-data]")]
        print(f"cli acdc: --validate-data on the {name} tree: exit "
              f"{proc.returncode}; " + " | ".join(lines)[-300:], flush=True)
    shutil.rmtree(broken, ignore_errors=True)
    if codes != {"synthetic": 0, "broken": 1}:
        rep.fail(f"cli acdc --validate-data exit codes {codes}, expected "
                 "0 on the tree and 1 on the broken copy")
    out["validate_data"] = codes
    return out


def deterministic_resize(model, on: bool = True) -> None:
    """Give every UpBlock of ``model`` the upsample whose backward is two
    matmuls (as SS-Net's), or torch's again: torch's bilinear backward
    scatters with atomic adds, so two runs from one state would drift apart
    in the last bits whatever else they share."""
    from hpfg_tpu_torch.models.layers import UpBlock

    for m in model.modules():
        if isinstance(m, UpBlock):
            m.deterministic_resize = on


def check_prefetch(rep: Report, dev, card: str) -> dict:
    """The Mean-Teacher UNet (full width, 224^2, bf16) for PREFETCH_STEPS
    steps with prefetch 0 and with prefetch 2, each from the same initial
    state and batches: the losses bitwise equal, every prefetched batch on
    the card; ms/step of the last four steps of each; then the step's FLOPs
    (``count_flops``) and its MFU at the prefetched step time, and
    ``count_flops`` of a batch-2 UNet forward and backward on the card
    against the same on a CPU copy (the kernels' reported FLOPs against
    FlopCounterMode's count of the plain versions)."""
    import torch

    from hpfg_tpu_torch.utils.profiling import chip_peak_flops, count_flops
    from hpfg_tpu_torch.utils.profiling import mfu as model_flops_util

    out, losses = {}, {}
    for depth in (0, 2):
        cfg, algo, trainer, loaders, images = build_run(
            MT_CONFIG, f"prefetch{depth}", dev, prefetch=depth)
        trainer.save = lambda tag: None
        deterministic_resize(algo.model)
        deterministic_resize(algo.ema)
        seen = []
        step = algo.step

        def recording_step(batch, step=step, seen=seen):
            seen.append(sorted({v.device.type if torch.is_tensor(v)
                                else "host" for v in batch.values()}))
            return step(batch)

        algo.step = recording_step
        trainer.total_itrs = 2
        trainer.fit(eval_enabled=False)
        torch.cuda.synchronize()
        trainer.total_itrs = PREFETCH_STEPS
        t0 = time.perf_counter()
        trainer.fit(eval_enabled=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (PREFETCH_STEPS - 2)
        losses[depth] = [m["loss"] for _, m in trainer.metrics_log]
        devices = sorted({d for s in seen for d in s})
        out[depth] = dict(ms_per_step=ms, batch_devices=devices)
        print(f"prefetch {depth}: Mean-Teacher {crop(cfg)}^2 {images} images"
              f" a step: {ms:.2f} ms/step over steps 3-{PREFETCH_STEPS}; "
              f"batches arrive as {devices} ({card})", flush=True)
        if depth == 2 and devices != ["cuda"]:
            rep.fail(f"prefetch 2: batches arrived as {devices}")
        if depth == 2:
            algo.step = step
            batch = next(algo.batches(loaders))
            flops = count_flops(algo.step, batch)
            util = model_flops_util(flops, ms / 1e3, dev)
            out["step_flops"], out["mfu"] = flops, util
            print(f"prefetch 2: count_flops of one Mean-Teacher step "
                  f"{flops / 1e12:.3f} TFLOP; MFU at {ms:.2f} ms/step "
                  f"{'n/a' if util is None else f'{100 * util:.2f}%'} of "
                  f"{chip_peak_flops(dev)} FLOP/s bf16 ({card})", flush=True)
            model = algo.model
        del algo, trainer
        torch.cuda.empty_cache()
    same = losses[0] == losses[2] and len(losses[0]) == PREFETCH_STEPS
    print(f"prefetch: losses with prefetch 0 and 2 "
          f"{'bitwise equal' if same else 'DIFFER'}: {losses[0]} / "
          f"{losses[2]}", flush=True)
    if not same:
        rep.fail(f"prefetch: losses differ: {losses[0]} vs {losses[2]}")
    out["losses_bitwise_equal"] = same

    cfg = load_config(MT_CONFIG)
    deterministic_resize(model, False)
    twin = fp32_twin(model, cfg)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, HW, HW, 1, generator=gen)

    def fwd_bwd(m, inp):
        m.zero_grad()
        m(inp, train=True).float().square().mean().backward()

    card_flops = count_flops(fwd_bwd, model, x.to(dev))
    cpu_flops = count_flops(fwd_bwd, twin, x)
    rel = abs(card_flops - cpu_flops) / cpu_flops
    print(f"count_flops of a batch-2 UNet forward + backward at {HW}^2: "
          f"{card_flops:.4e} on the card (the kernels' reports), "
          f"{cpu_flops:.4e} on the CPU (the plain versions), rel diff "
          f"{rel:.2e}", flush=True)
    if rel > 0.01:
        rep.fail(f"count_flops: card {card_flops} vs CPU {cpu_flops}")
    out["flops_card_vs_cpu"] = [card_flops, cpu_flops]
    del model, twin
    torch.cuda.empty_cache()
    out["breakdown"] = {label: prefetch_breakdown(dev, card, label, config)
                        for label, config in PREFETCH_TURNS}
    return out


PREFETCH_TIMED = 20
#: the paths timed in turns with and without the prefetcher: the main path
#: and the two whose batches are largest
PREFETCH_TURNS = (("mean_teacher", MT_CONFIG),
                  ("building_sup", BUILDING_CONFIG),
                  ("synapse_sup", SYNAPSE_CONFIG))


def prefetch_breakdown(dev, card: str, label: str, config: str) -> list:
    """The config's path (in-memory batches, its default upsample) in turns
    with prefetch 0, 2, 2, 0, PREFETCH_TIMED steps a fit: ms/step, and of
    it the host time inside ``algorithm.step`` (the enqueue) and between
    steps; the median time from one step's start to the next (the steady
    state); and the fit's own start (``fit()`` to the first step: with
    prefetch, the worker's start and the first batch's pinned upload) and
    end (the last step's return to ``fit()``'s: the device draining the
    queued steps, closing the prefetcher)."""
    import numpy as np
    import torch

    cfg, algo, trainer, _, _ = build_run(config, f"prefetch_turns_{label}",
                                         dev)
    trainer.save = lambda tag: None
    marks, step = [], algo.step

    def timed_step(batch):
        t0 = time.perf_counter()
        out = step(batch)
        marks.append((t0, time.perf_counter()))
        return out

    algo.step = timed_step
    trainer.total_itrs = 2
    trainer.fit(eval_enabled=False)
    rows = []
    for depth in (0, 2, 2, 0):
        trainer.prefetch = depth
        marks.clear()
        trainer.total_itrs += PREFETCH_TIMED
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(eval_enabled=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wall = (t1 - t0) * 1e3 / PREFETCH_TIMED
        enq = sum(b - a for a, b in marks) * 1e3 / PREFETCH_TIMED
        steady = float(np.median(np.diff([a for a, _ in marks]))) * 1e3
        rows.append(dict(prefetch=depth, ms_per_step=wall,
                         step_host_ms=enq, between_ms=wall - enq,
                         steady_ms=steady,
                         fit_start_ms=(marks[0][0] - t0) * 1e3,
                         fit_end_ms=(t1 - marks[-1][1]) * 1e3))
    print(f"prefetch turns ({label}, {crop(cfg)}^2, {PREFETCH_TIMED} steps "
          "a fit; ms/step = inside step() + between steps; steady = median "
          "step start to step start; the fit's start and end): " + "; ".join(
              f"prefetch {r['prefetch']}: {r['ms_per_step']:.2f} = "
              f"{r['step_host_ms']:.2f} + {r['between_ms']:.2f}, steady "
              f"{r['steady_ms']:.2f}, start {r['fit_start_ms']:.2f}, end "
              f"{r['fit_end_ms']:.2f}" for r in rows) + f" ({card})",
          flush=True)
    del algo, trainer
    torch.cuda.empty_cache()
    return rows


def _hpfg_trainer(dev, root: str, workdir: str, **sets):
    """HPFG from the h5 tree through the port's loaders, for ASYNC_ITERS
    iterations with an eval every ASYNC_EVERY (``sets`` override config
    keys, these too)."""
    import torch

    from hpfg_tpu_torch.data.builder import build_loader
    from hpfg_tpu_torch.train.algorithms import build_algorithm
    from hpfg_tpu_torch.train.trainer import Trainer

    cfg = load_config(HPFG_CONFIG)
    cfg.update({"data_path": root, "save_path": workdir,
                "total_itrs": ASYNC_ITERS, "step_size": ASYNC_EVERY, **sets})
    dtype = torch.bfloat16 if cfg.get("precision") == "bf16" else torch.float32
    algo = build_algorithm(cfg["algorithm"], cfg, dtype=dtype, device=dev)
    return Trainer(cfg, algo, loaders=build_loader(cfg), workdir=workdir)


def check_async_eval(rep: Report, dev, card: str, root: str, eval_root: str,
                     tmp: str):
    """HPFG (full width, 224^2, bf16) through the port's loaders.

    Equality, on the small tree: 4 iterations with an eval every 2, one run
    with ``async_eval`` on whose every boundary is first evaluated and
    saved inline, as ``async_eval`` off does it, by a second Trainer over
    the same algorithm, and then dispatched to the worker, so that the
    overlapped eval runs beside the next steps, which change the live
    weights (one trajectory: the HPFG step has backward atomics, so two
    runs would differ in the last bits whatever the eval does): the
    histories equal and the ``best_*`` and ``last_a`` / ``last_b``
    checkpoints bitwise equal.

    Timing, on ``eval_root`` (an ACDC-size test split): one run with
    ``async_eval`` on and one with it off, one boundary after ASYNC_BEFORE
    steps, then steps until the eval is over and ASYNC_AFTER more: how long
    the boundary blocks the loop, how long the eval takes, and the times of
    the steps before it, beside it and after it (each step synchronized).
    Returns (summary, the equality run's algorithm)."""
    import shutil

    import numpy as np
    import torch

    from hpfg_tpu_torch.train.trainer import Trainer
    from hpfg_tpu_torch.utils.checkpoint import state_mismatches

    a_dir, b_dir = os.path.join(tmp, "async"), os.path.join(tmp, "inline")
    trainer = _hpfg_trainer(dev, root, a_dir)
    inline = Trainer(dict(trainer.cfg, async_eval=False), trainer.algorithm,
                     loaders=trainer.loaders, workdir=b_dir)
    dispatch = trainer._dispatch_eval

    def both(cur):
        inline._dispatch_eval(cur)
        dispatch(cur)

    trainer._dispatch_eval = both
    trainer.fit()
    torch.cuda.synchronize()
    tags = sorted(f[:-3] for f in os.listdir(inline.ckpt.directory))
    bad = {t: state_mismatches(trainer.ckpt.restore(t),
                               inline.ckpt.restore(t))[:3] for t in tags}
    bad = {t: v for t, v in bad.items() if v}
    same = trainer.history == inline.history and not bad and \
        {"last_a", "last_b"} <= set(tags)
    print(f"async eval: history {trainer.history} (inline "
          f"{'equal' if trainer.history == inline.history else 'DIFFERS'}); "
          f"checkpoints {tags} {'bitwise equal' if not bad else bad}",
          flush=True)
    if not same:
        rep.fail(f"async eval: history {trainer.history} vs inline "
                 f"{inline.history}; checkpoints {tags}, differing {bad}")
    algo = trainer.algorithm
    shutil.rmtree(a_dir, ignore_errors=True)
    shutil.rmtree(b_dir, ignore_errors=True)

    def median(xs):
        return float(np.median(xs)) if xs else None

    timing = {}
    for mode in (True, False):
        wd = os.path.join(tmp, f"timing_{mode}")
        t = _hpfg_trainer(dev, eval_root, wd, async_eval=mode,
                          total_itrs=ASYNC_CAP, step_size=ASYNC_BEFORE)
        blocks, evals, steps = [], [], {"before": [], "beside": [],
                                        "after": []}
        dispatch_t, task, step = (t._dispatch_eval, t._eval_task,
                                  t.algorithm.step)

        def timed_dispatch(cur, fn=dispatch_t, blocks=blocks, t=t):
            t0 = time.perf_counter()
            fn(cur)
            blocks.append((time.perf_counter() - t0) * 1e3)
            t.step_size = 10 ** 9  # one boundary

        def timed_task(*args, fn=task, evals=evals):
            t0 = time.perf_counter()
            fn(*args)
            evals.append((time.perf_counter() - t0) * 1e3)

        def timed_step(batch, fn=step, steps=steps, blocks=blocks, t=t,
                       evals=evals):
            phase = ("before" if not blocks else "after" if evals
                     else "beside")
            t0 = time.perf_counter()
            out = fn(batch)
            torch.cuda.current_stream().synchronize()
            steps[phase].append((time.perf_counter() - t0) * 1e3)
            if len(steps["after"]) >= ASYNC_AFTER:
                t.total_itrs = t.algorithm.step_count
            return out

        t._dispatch_eval, t._eval_task = timed_dispatch, timed_task
        t.algorithm.step = timed_step
        t.fit()
        torch.cuda.synchronize()
        row = dict(boundary_ms=blocks[0], eval_ms=evals[0],
                   volumes=ACDC_EVAL_VOLUMES, depth=ACDC_EVAL_DEPTH,
                   steps={k: len(v) for k, v in steps.items()},
                   median_step_ms={k: median(v) for k, v in steps.items()})
        timing["on" if mode else "off"] = row
        med = row["median_step_ms"]
        print(f"async eval {'on' if mode else 'off'} ({ACDC_EVAL_VOLUMES} "
              f"test volumes of {ACDC_EVAL_DEPTH} x {ACDC_HW}, "
              f"{sorted(t.algorithm.eval_models())}): the boundary blocks "
              f"the loop {blocks[0]:.1f} ms, the eval takes {evals[0]:.1f} "
              f"ms; steps before / beside / after the eval: "
              + " / ".join(f"{row['steps'][k]} at median "
                           + (f"{med[k]:.2f}" if med[k] is not None else "-")
                           for k in ("before", "beside", "after"))
              + f" ms (each synchronized) ({card})", flush=True)
        del t
        shutil.rmtree(wd, ignore_errors=True)
        torch.cuda.empty_cache()
    return dict(bitwise_equal=same, history=trainer.history,
                checkpoints=tags, timing=timing), algo


def check_multi_eval(rep: Report, dev, card: str, algo, root: str) -> dict:
    """HPFG's three eval models through one ``evaluate_volumes_multi`` call
    and each through ``evaluate_volumes`` (its one-model call) on the test
    volumes of ``root`` (the ACDC-size split): the results exactly equal
    (sharing the upload and the ground truth's EDT changes no model's
    result); both times, in turns (multi, per-model)."""
    import numpy as np
    import torch

    from hpfg_tpu_torch.data.acdc import ACDCDataset
    from hpfg_tpu_torch.data.loader import VolumeLoader
    from hpfg_tpu_torch.evals.volume import (
        evaluate_volumes,
        evaluate_volumes_multi,
    )

    vols = VolumeLoader(ACDCDataset(root, "test"))
    models = algo.eval_models()
    list(vols)  # cache the volumes: both sides time the eval alone

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    def run_multi():
        return evaluate_volumes_multi(models, vols, 4, (HW, HW), dev)

    def run_per():
        return {n: evaluate_volumes(m, vols, 4, (HW, HW), dev)
                for n, m in models.items()}

    multi, multi_ms = timed(run_multi)
    per, per_ms = timed(run_per)
    same = all(multi[n][:2] == per[n][:2]
               and np.array_equal(multi[n][2], per[n][2]) for n in models)
    print(f"multi eval: {sorted(models)} over {len(vols)} volumes of "
          f"{ACDC_EVAL_DEPTH} x {ACDC_HW}: evaluate_volumes_multi "
          f"{multi_ms:.1f} ms, per-model evaluate_volumes {per_ms:.1f} ms "
          f"({card}); results "
          f"{'exactly equal' if same else 'DIFFER'}: "
          + ", ".join(f"{n} {multi[n][0]:.4f}/{multi[n][1]:.4f}"
                      for n in models), flush=True)
    if not same:
        pairs = [(n, multi[n][:2], per[n][:2]) for n in models]
        rep.fail(f"multi eval differs: {pairs}")
    return dict(multi_ms=multi_ms, per_model_ms=per_ms, equal=same,
                volumes=len(vols), depth=ACDC_EVAL_DEPTH,
                results={n: multi[n][:2] for n in models})


# ---------------------------------------------------------------------------
# phase 18: the eval over every rank
# ---------------------------------------------------------------------------

#: the eval over ranks, (label, config, eval models): Mean-Teacher's
#: student and EMA teacher, and S4CVNet's SwinUNet and its EMA teacher
#: (its UNet, built from the same seed, is Mean-Teacher's student)
EVAL_RUNS = (("mean_teacher", MT_CONFIG, ("model1", "model2")),
             ("s4cvnet", S4_CONFIG, ("model2", "ema")))


def eval_groups(models: dict, volumes, dev, mesh) -> dict:
    """{name: per-class [C-1, 2] dice and HD95} of ``models`` over
    ``volumes``, grouped by architecture as ``Trainer.evaluate`` groups
    them (one ``evaluate_volumes_multi`` call a group), on ``mesh``."""
    from hpfg_tpu_torch.evals.volume import evaluate_volumes_multi
    from hpfg_tpu_torch.train.trainer import _architecture

    groups: dict = {}
    for name, model in models.items():
        groups.setdefault(_architecture(model), {})[name] = model
    out = {}
    for group in groups.values():
        res = evaluate_volumes_multi(group, volumes, 4, (HW, HW), dev,
                                     mesh=mesh)
        out.update({n: r[2] for n, r in res.items()})
    return out


def timed_evals(dev, root: str, mesh, before=None) -> dict:
    """Each EVAL_RUNS algorithm's listed eval models (the config's seed,
    bf16) over the test volumes of ``root`` (read from the h5 files,
    uncached), on ``mesh``: {label: (per-class results, ms)}. ``before``
    runs once the models are built, before each timed eval."""
    import torch

    from hpfg_tpu_torch.data.acdc import ACDCDataset
    from hpfg_tpu_torch.data.loader import VolumeLoader
    from hpfg_tpu_torch.train.algorithms import build_algorithm

    out = {}
    for label, config, names in EVAL_RUNS:
        cfg = load_config(config)
        algo = build_algorithm(cfg["algorithm"], cfg, dtype=torch.bfloat16,
                               device=dev)
        models = {n: m for n, m in algo.eval_models().items() if n in names}
        vols = VolumeLoader(ACDCDataset(root, "test", cache=False))
        if before is not None:
            before(label)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eval_groups(models, vols, dev, mesh)
        out[label] = (res, (time.perf_counter() - t0) * 1e3)
        del algo, models
        torch.cuda.empty_cache()
    return out


def eval_worker(rank: int, world: int, port: int, out_dir: str,
                root: str) -> int:
    """One rank of phase 18 over gloo on cuda:0: ``timed_evals`` on the
    mesh of the ranks, the ranks meeting at a barrier before each; writes
    ``rank<r>.pt``."""
    import torch

    from hpfg_tpu_torch.parallel.distributed import (
        coordination_barrier,
        init_distributed,
    )
    from hpfg_tpu_torch.parallel.mesh import get_mesh

    dev = torch.device("cuda", 0)
    init_distributed(f"127.0.0.1:{port}", world, rank, device=dev,
                     backend="gloo", timeout_s=240)
    res = timed_evals(dev, root, get_mesh(),
                      lambda label: coordination_barrier(label, 240))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    sys.stdout.flush()
    os._exit(0)


def check_sharded_eval(rep: Report, dev, card: str, root: str) -> dict:
    """Phase 18: on the test split of ``root`` (SHARDED_EVAL_VOLUMES
    volumes of 10 slices), Mean-Teacher's student and EMA teacher, and
    S4CVNet's SwinUNet and EMA SwinUNet, each pair through one
    ``evaluate_volumes_multi`` call, first in one process here, then over
    DP_WORLD ranks (``--eval-worker`` processes, gloo on this card), each
    rank its share of the volumes: every rank's per-class dice and HD95
    bitwise equal to the one process's. The eval's wall time on one
    process and on each rank (from the barrier before it to its result),
    printed, not gated."""
    import numpy as np
    import torch

    single = timed_evals(dev, root, None)
    out_dir = tempfile.mkdtemp(prefix="hpfg_eval_")
    try:
        port = _free_port()
        t0 = time.perf_counter()
        outs, codes = _run_group(
            [[sys.executable, os.path.abspath(__file__), "--eval-worker",
              str(r), str(DP_WORLD), str(port), out_dir, root]
             for r in range(DP_WORLD)], 600)
        run_s = time.perf_counter() - t0
        if codes != [0] * DP_WORLD:
            rep.fail(f"sharded eval: worker exit codes {codes}; output "
                     f"tails {[o[-1500:] for o in outs]}")
            return {}
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_WORLD)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    summary = {"card": card, "world": DP_WORLD, "workers_s": run_s}
    for label, _, _ in EVAL_RUNS:
        want, ms_1 = single[label]
        same = all(
            set(r[label][0]) == set(want)
            and all(r[label][0][n].dtype == want[n].dtype
                    and r[label][0][n].tobytes() == want[n].tobytes()
                    for n in want) for r in ranks)
        hits = {n: int(np.count_nonzero(v[:, 1])) for n, v in want.items()}
        summary[label] = dict(equal=same, ms_1=ms_1,
                              ms_ranks=[r[label][1] for r in ranks],
                              dice={n: float(v[:, 0].mean())
                                    for n, v in want.items()},
                              hd95_classes_hit=hits)
        print(f"sharded eval {label} ({sorted(want)}; {SHARDED_EVAL_VOLUMES} "
              f"volumes of {ACDC_EVAL_DEPTH} x {ACDC_HW}): per-class dice "
              f"and HD95 on {DP_WORLD} ranks "
              f"{'bitwise equal to' if same else 'DIFFER from'} one "
              f"process (mean dice "
              + ", ".join(f"{n} {v[:, 0].mean():.4f}"
                          for n, v in want.items())
              + f"; classes with an HD95 {hits}); the eval takes "
              f"{ms_1:.1f} ms in one process, "
              + " / ".join(f"{r[label][1]:.1f}" for r in ranks)
              + f" ms on ranks 0 / 1 ({card})", flush=True)
        if not same:
            rep.fail(f"sharded eval {label}: the ranks' results differ "
                     f"from one process's: {want} vs "
                     f"{[r[label][0] for r in ranks]}")
    return summary


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


def launched(meta: dict, launches: dict, routes: dict) -> int:
    """A KERNELS entry's launches in one run: its wrappers' counts, or for
    a kernel that is one route of a wrapper (``route_of``: K12) that
    route's count (``routes``: the run's launches by route)."""
    if "route_of" in meta:
        wrapper, route = meta["route_of"]
        return routes.get(wrapper, {}).get(route, 0)
    return sum(launches.get(c, 0) for c in meta["counters"])


def kernel_line(rep: Report, paths: dict, routes: dict | None = None
                ) -> list[dict]:
    """The per-kernel summary: launches on each main path's timed run and
    their sum over the paths (``launches``), the largest error over every
    check, and the bf16 times and bounds summed over the timed shapes of
    the ACDC main paths, and in ``at_geometries`` over those of each new
    path (phase 2d). For K8 and K10, ``routes`` (each path's launches by
    route) gives ``launches_by_route`` summed over the paths, and their
    rows' device-only times give ``device_ms`` (the route the wrapper
    takes), ``mma_ms`` / ``mma_device_ms`` (PR 4's mma.sync kernels) and
    ``library_device_ms``, each summed like ``ms``; a kernel without
    routes whose rows all have it (C) gets ``device_ms`` alone."""
    kernels = []
    for name, meta in KERNELS.items():
        rows = [r for r in rep.rows if r["kernel"] == name]
        timed = [r for r in rows if r["ms"] is not None and r["main"]
                 and r["dtype"] == "bfloat16" and r["geometry"] is None]
        t_ops = sum(r["flops"] / BF16_FLOPS_PER_S * 1e3 for r in timed)
        t_bytes = sum(r["bytes"] / HBM_BYTES_PER_S * 1e3 for r in timed)
        lib = [r["library_ms"] for r in timed]
        dev = [r.get("device_ms") for r in timed]
        by_path = {p: launched(meta, launches, (routes or {}).get(p, {}))
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
            **(route_line(meta["routes"], meta.get("route_of", (name,))[0],
                          timed, routes or {})
               if "routes" in meta else
               {"device_ms": sum(dev)} if dev and None not in dev else {}),
            timed_shapes=len(timed), at_geometries=at,
            **({"by_tpu_kernel": {k: v for k, v in tpu_kernel_split(
                rows).items() if v["wrapper"] == name}}
               if name in TPU_FORMS else {})))
    return kernels


#: the TPU kernels whose work a wrapper's timed rows split into, by the
#: row's label: A's conv2 forwards (K2, the prologue form), its dgrads (K6)
#: and the rest (K1: the conv1s, 1x1s and head; the stem's is K12's own
#: entry, ``conv3x3_stem``); D's full calls (K4, with the dpre of K5 in
#: the same launch) and its dpre-only entry (K5)
TPU_FORMS = {
    "conv3x3_nhwc": (("K2", lambda w: ".conv2 fwd" in w),
                     ("K6", lambda w: " dgrad" in w),
                     ("K1", lambda w: True)),
    "bn_act_bwd": (("K5", lambda w: "dpre-only" in w),
                   ("K4", lambda w: True))}


def tpu_kernel_split(rows) -> dict:
    """A's and D's timed bf16 rows of the ACDC main path (phase 2; a list
    of kernels.jsonl rows, or the path of such a file) summed by the TPU
    kernel each form replaces (``TPU_FORMS``): ms (host-inclusive),
    device_ms, plain_ms, library_ms (None where a row has none), bound_ms
    and the shapes. Printed as one ``FORMS`` JSON line and returned."""
    if isinstance(rows, str):
        with open(rows, encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
    out = {}
    for kernel, forms in TPU_FORMS.items():
        for r in rows:
            if not (r["kernel"] == kernel and r["ms"] is not None
                    and r["main"] and r["dtype"] == "bfloat16"
                    and r["geometry"] is None):
                continue
            tpu = next(k for k, pick in forms if pick(r["what"]))
            acc = out.setdefault(tpu, dict(
                wrapper=kernel, ms=0.0, device_ms=0.0, plain_ms=0.0,
                library_ms=0.0, bound_ms=0.0, shapes=0))
            acc["shapes"] += 1
            for key in ("ms", "device_ms", "plain_ms", "library_ms",
                        "bound_ms"):
                if acc[key] is None or r.get(key) is None:
                    acc[key] = None
                else:
                    acc[key] += r[key]
    print("FORMS " + json.dumps(out), flush=True)
    return out


#: the device-only keys of phase 2's rows (``route_times``, ``bn_forms``)
#: that a kernel's routes line sums over its shapes
ROUTE_KEYS = ("device_ms", "mma_ms", "mma_device_ms", "library_device_ms",
              "hold_device_ms", "stream_device_ms", "walk_device_ms",
              "walk_ms")


def route_line(sources: dict, name: str, timed: list, routes: dict) -> dict:
    """The keys of the kernels line of a kernel with routes (A, B, K8 to
    K11, K13, K14, D): launches by route over the paths, and the
    ROUTE_KEYS its timed rows have, each summed over them (None where a
    row lacks it) and by shape."""
    out = dict(route_sources=sources, launches_by_route={
        r: sum(by.get(name, {}).get(r, 0) for by in routes.values())
        for r in sources})
    for key in ROUTE_KEYS:
        vals = [r.get(key) for r in timed]
        if any(v is not None for v in vals) or key in ROUTE_KEYS[:4]:
            out[key] = sum(vals) if vals and None not in vals else None
    out["ms_by_shape"] = {r["what"]: {k: r.get(k) for k in (
        "ms", "library_ms", "bound_ms", "enqueue_us", "mma_enqueue_us",
        "route") + ROUTE_KEYS if k in r} for r in timed}
    return out


# ---------------------------------------------------------------------------
# phase 2e: the kernels with global image ids; phases 15-17: data
# parallelism over processes
# ---------------------------------------------------------------------------

#: the global batches of the data-parallel phase (the configs' 8 + 24)
#: and its ranks, all on the one card over gloo
DP_WORLD, DP_STEPS = 2, 2
#: the bounds of the data-parallel phase against one process, each step
#: taken from the one process's state: the step's loss (relative) and the
#: parameters and BN buffers after it (over each model's largest
#: magnitude). They lie between the sound
#: readings (2.1e-6, 7.3e-5) and those of a rank that keeps its BN
#: statistics (8.2e-4, 0.14) or its image indices (2.1e-4, 2.9e-3) local
#: (PERF.md, PR 12); tests/test_sharding.py's 2e-3 and the bf16 kernel
#: bound 2e-2 pass the second fault.
DP_LOSS_RTOL, DP_STATE_TOL = 1e-4, 1e-3
#: the main paths (PATHS) the data-parallel phase runs: every algorithm
#: of the ACDC configs, and the three models without kernels
DP_PATHS = ("mean_teacher", "hpfg", "uamt", "ict", "ssnet", "s4cvnet",
            "swin_mae", "acdc_cmt_hpfg", "acdc_uniformer_hpfg",
            "lidc_transunet")
#: the checks of bf16 runs that bf16 rounding alone carries past the
#: bounds within one step from the one process's state (PERF.md, section
#: 6, PR 13): SS-Net's bank (the K lowest bf16 selector scores of 400,000
#: pixel rows: 96 of 128 slots swap), S4CVNet's state (adamW's first step
#: is +-lr wherever a gradient is rounding noise: 1.6e-3), UniFormer's
#: state (its BatchNorms' E[x^2] - E[x]^2: 9.9e-4) and TransUNet's loss
#: and state (3.3e-4, 1.3e-3). They are printed as unmet and not held;
#: each of these paths is held to the bounds by its fp32 run.
DP_UNMET_BF16 = {"ssnet": ("bank",), "s4cvnet": ("state",),
                 "acdc_uniformer_hpfg": ("state",),
                 "lidc_transunet": ("loss", "state")}
#: the phase's runs: (main path, dtype), each at the config's global
#: batches: every path in bf16, and in fp32 those of DP_UNMET_BF16
DP_RUNS = tuple((label, "bfloat16") for label in DP_PATHS) + tuple(
    (label, "float32") for label in DP_UNMET_BF16)
#: seconds the data-parallel phase may take, its ranks' start included
DP_TIMEOUT_S = 900
#: (ConvBlock, H = W, channels, keep) of the id checks: the stem's and the
#: bottleneck's conv2 of the full-width UNet
ID_SHAPES = (("in_conv", 224, 16, 0.95), ("down4", 14, 256, 0.5))


def check_image_ids(rep: Report, dev) -> None:
    """A, B and K11 with a two-segment image-id map (rank 1's rows of a
    2-rank global batch of 8 + 24: 16 images) against their plain versions
    at the stem's and the bottleneck's conv2; A's masks and K11's (on both
    routes) bit-exact through the identity conv; D's reduce alone
    (``bn_reduce``) against its plain version. In bf16 each kernel is timed with and without the ids. The
    rows stay out of the kernels' totals (the main paths run one process,
    without ids)."""
    import torch

    from hpfg_tpu_torch.ops import bn_act as ba
    from hpfg_tpu_torch.ops import conv_block as cb
    from hpfg_tpu_torch.parallel.mesh import Mesh

    ids = Mesh(DP_WORLD, 1, dev).rows(8, 24).ids
    n = len(ids)
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        bf16 = dt == torch.bfloat16
        clock = cuda_ms if bf16 else (lambda fn: None)
        for name, hh, c, keep in ID_SHAPES:
            x1 = torch.ones((n, hh, hh, c), device=dev, dtype=dt)
            eye = torch.zeros((3, 3, c, c), device=dev, dtype=dt)
            eye[1, 1] = torch.eye(c, device=dev, dtype=dt)
            one, zero = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            drop = cb.HashDropout(31 + c, keep, ids)
            full = cb.hash_mask(drop.seed, 32, hh, hh * c, keep, dev)
            ref = full[ids.long()].view(n, hh, hh, c).to(dt)
            unit = (x1, one, zero, zero, one)
            k11_mma = torch.empty_like(x1)
            cb._launch_conv(x1, eye, k11_mma, out_drop=drop, reduce=unit,
                            want_sums=True)
            for what, got in (
                    ("prologue", cb.conv3x3_nhwc(x1, eye, affine=(one, zero),
                                                 drop=drop)[0]),
                    ("output", cb.conv3x3_nhwc(x1, eye, out_drop=drop)[0]),
                    ("K11 output", cb.conv3x3_dgrad_reduce(
                        x1, eye, *unit, out_drop=drop)[0]),
                    ("K11 output mma route", k11_mma)):
                if not torch.equal(got, ref):
                    rep.fail(f"hash mask with ids ({what}) {name} {dname}: "
                             f"{(got != ref).sum().item()} elements differ")
            del x1, eye, full, ref, k11_mma
            x = randn(n, hh, hh, c).to(dt)
            dp = randn(n, hh, hh, c).to(dt)
            w = randn(3, 3, c, c, scale=(9 * c) ** -0.5).to(dt)
            a, b = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
            m, inv = randn(c, scale=0.1), 1.0 + randn(c, scale=0.1).abs()
            wf = cb.flip_transpose(w)
            plain = cb.HashDropout(drop.seed, keep)
            line = [f"{dname} {name}.conv2 {hh}^2 {c}, {n} images with ids"]
            calls = {
                "conv3x3_nhwc": (
                    lambda d: cb.conv3x3_nhwc(x, w, affine=(a, b), drop=d,
                                              want_stats=True),
                    lambda d: cb.conv3x3_reference(x, w, affine=(a, b),
                                                   drop=d, want_stats=True)),
                "conv3x3_wgrad_nhwc": (
                    lambda d: (cb.conv3x3_wgrad_nhwc(x, dp, affine=(a, b),
                                                     drop=d),),
                    lambda d: (cb.conv3x3_wgrad_reference(
                        x, dp, affine=(a, b), drop=d),)),
                "conv3x3_dgrad_reduce": (
                    lambda d: cb.conv3x3_dgrad_reduce(dp, wf, x, a, b, m,
                                                      inv, out_drop=d),
                    lambda d: cb.conv3x3_dgrad_reduce_reference(
                        dp, wf, x, a, b, m, inv, out_drop=d))}
            for kernel, (fn, fn_ref) in calls.items():
                errs = [rep.compare(kernel, f"{name}.conv2 ids {i}", dname,
                                    g, r, main=False)
                        for i, (g, r) in enumerate(zip(fn(drop),
                                                       fn_ref(drop)))]
                ms, ms0 = clock(lambda: fn(drop)), clock(lambda: fn(plain))
                line.append(f"{kernel} {max(errs):.1e}" + (
                    "" if ms is None else f" {ms:.3f} ms with ids, {ms0:.3f}"
                    " without"))
            s = ba.bn_reduce(dp, x, a, b, m, inv)
            r = rep.compare("bn_act_bwd", f"{name} bn_reduce", dname, s,
                            ba.bn_reduce_reference(dp, x, a, b, m, inv),
                            tol=TOL["float32"], main=False)
            ms = clock(lambda: ba.bn_reduce(dp, x, a, b, m, inv))
            line.append(f"bn_reduce {r:.1e}" + ("" if ms is None
                                                else f" {ms:.3f} ms"))
            print(" | ".join(line), flush=True)
            del x, dp, w
            torch.cuda.empty_cache()
    print("hash masks with ids: bit-exact check done (prologue and output, "
          "K11's on both routes, float32 and bfloat16)", flush=True)
    check_attention_ids(rep, dev)


#: (stage, token side, heads) of the attention id checks: the S4CVNet
#: SwinUNet's first and last stage (64 and 1 windows an image)
ID_ATTN_STAGES = ((0, 56, 3), (3, 7, 24))


def check_attention_ids(rep: Report, dev) -> None:
    """K13 and K14 with a two-segment image-id map (rank 1's rows of a
    2-rank global batch of 8 + 24: 16 images) and attention dropout (keep
    0.9) against their plain versions at ID_ATTN_STAGES, unshifted and
    shifted; the masks bit-exact (K13's output and K14's dv with q = k = 0
    and v, do the identity) and equal to the full batch's masks at those
    windows; in bf16 on both routes (``attn_route``'s and the mma route
    forced), each on the device alone with the ids (and the wrapper's
    route without them). The rows stay out of the kernels' totals."""
    import torch

    from hpfg_tpu_torch.models.swinunet import _shift_attention_mask
    from hpfg_tpu_torch.ops import window_attention as wa
    from hpfg_tpu_torch.ops.conv_block import HashDropout
    from hpfg_tpu_torch.parallel.mesh import Mesh

    rows = Mesh(DP_WORLD, 1, dev).rows(8, 24)
    n, l, ws = len(rows.ids), ATTN_WS * ATTN_WS, ATTN_WS
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # the masks, bit-exact: 4 windows an image (global count 128)
    heads, d, nw = 2, 64, 4
    bn = n * nw
    drop = HashDropout(2468, 0.9, rows.ids, rows.total)
    full = wa.attn_drop_mask(drop.seed, rows.total * nw, heads, l, drop.keep,
                             dev)[rows.expand(nw).index]
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.zeros((bn, l, 3 * heads * d), device=dev)
        do = torch.zeros((bn, l, heads * d), device=dev)
        for h in range(heads):
            o = 2 * heads * d + h * d
            qkv[:, :, o:o + l] = torch.eye(l, device=dev)
            do[:, :, h * d:h * d + l] = torch.eye(l, device=dev)
        qkv, do = qkv.to(dt), do.to(dt)
        zero_bias = torch.zeros((heads, l, l), device=dev)
        out = wa.window_attention_fwd(qkv, zero_bias, None, heads,
                                      drop).view(bn, l, heads, d)
        dv = wa.window_attention_bwd(qkv, zero_bias, None, do, heads,
                                     drop)[0][..., 2 * heads * d:]
        dv = dv.reshape(bn, l, heads, d)
        ref = (full * (torch.tensor(1.0, device=dev) / l)).to(dt)
        for name, got, perm in (("K13 output", out, (0, 2, 1, 3)),
                                ("K14 dv", dv, (0, 2, 3, 1))):
            if not (torch.equal(got[..., :l].permute(*perm), ref)
                    and not got[..., l:].any()):
                rep.fail(f"attention dropout mask with ids {name} {dt}: not "
                         "bit-exact to the full batch's")
    print("attention dropout masks with ids: bit-exact check done (K13 "
          "output and K14 dv against the full batch's masks, fp32 and "
          "bf16)", flush=True)

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        clock = device_ms if dt == torch.bfloat16 else None
        for stage, side, heads in ID_ATTN_STAGES:
            nw = (side // ws) ** 2
            bn, c = n * nw, heads * ATTN_D
            qkv = randn(bn, l, 3 * c).to(dt)
            bias = randn(heads, l, l, scale=0.02)
            do = randn(bn, l, c).to(dt)
            q, k, v = qkv.split(c, dim=-1)
            drop = HashDropout(77 + stage, 0.9, rows.ids, rows.total)
            plain = HashDropout(drop.seed, drop.keep)
            smask = torch.from_numpy(_shift_attention_mask(
                side, side, ws, ws // 2)).to(dev) if nw > 1 else None
            for mask in (None, smask) if nw > 1 else (None,):
                shift = "unshifted" if mask is None else "shifted"
                what = f"stage {stage} {shift} ids"
                got = wa.window_attention_fwd(qkv, bias, mask, heads, drop)
                r = rep.compare("window_attention_fwd", what, dname, got,
                                wa.window_attention_reference(
                                    q, k, v, bias, mask, heads, drop),
                                main=False)
                (dqkv, dbias) = wa.window_attention_bwd(qkv, bias, mask, do,
                                                        heads, drop)
                *ref, dbias_r = wa.window_attention_bwd_reference(
                    q, k, v, bias, mask, do, heads, drop)
                rb = max(rep.compare("window_attention_bwd", f"{what} {g}",
                                     dname, a, b, main=False)
                         for g, a, b in zip(("dq", "dk", "dv", "dbias"),
                                            (*dqkv.split(c, -1), dbias),
                                            (*ref, dbias_r)))
                route = wa.attn_route(dt, ATTN_D, l, True)
                if route == "wgmma":  # the mma route beside it
                    r = max(r, rep.compare(
                        "window_attention_fwd", f"{what} mma", dname,
                        wa._launch("mma", False, qkv, bias, mask, heads,
                                   drop),
                        wa.window_attention_reference(q, k, v, bias, mask,
                                                      heads, drop),
                        main=False))
                    dqkv, dbias = wa._launch("mma", True, qkv, bias, mask, do,
                                             heads, drop)
                    rb = max(rb, *(rep.compare(
                        "window_attention_bwd", f"{what} {g} mma", dname, a,
                        b, main=False)
                        for g, a, b in zip(("dq", "dk", "dv", "dbias"),
                                           (*dqkv.split(c, -1), dbias),
                                           (*ref, dbias_r))))
                line = (f"{dname} attention {what} Bn={bn} H={heads} L={l}, "
                        f"{n} images with ids: K13 {route} {r:.1e} K14 "
                        f"{rb:.1e}")
                if clock is not None:
                    # device-only ms: the wrapper's route with ids and
                    # without, the mma route with ids
                    def t(rt, bwd_, d_):
                        a_ = ((qkv, bias, mask, do, heads, d_) if bwd_
                              else (qkv, bias, mask, heads, d_))
                        return clock(lambda: wa._launch(rt, bwd_, *a_))

                    for bwd_, kname in ((False, "K13"), (True, "K14")):
                        line += (f" | {kname} device {route} "
                                 f"{t(route, bwd_, drop):.4f} ms with ids, "
                                 f"{t(route, bwd_, plain):.4f} without; mma "
                                 f"{t('mma', bwd_, drop):.4f} with ids")
                print(line, flush=True)
            del qkv, do, q, k, v
            torch.cuda.empty_cache()


def dp_batch(cfg: dict, step: int) -> dict:
    """The global batch of the data-parallel phase's ``step`` for ``cfg``
    (HPFG's with its second labelled batch; one labelled batch of
    ``batch_size`` for Supervised and Swin-MAE), from a seed. Row i of a
    batch of k images is normal with mean 2i/(k-1) - 1 and scale
    0.5 + 1.5i/(k-1): the ranks' shares differ in distribution, so a rank
    that normalises by its own rows' statistics gets other activations."""
    import numpy as np

    rng = np.random.default_rng((71, step))
    hw, lb = crop(cfg), int(cfg["batch_size"])
    ch, nc = int(cfg.get("in_channels", 1)), int(cfg.get("num_classes", 4))

    def img(k):
        r = (np.arange(k, dtype=np.float32) / (k - 1)).reshape(k, 1, 1, 1)
        return (rng.normal(size=(k, hw, hw, ch)) * (0.5 + 1.5 * r)
                + (2 * r - 1)).astype(np.float32)

    def lab(k):
        return rng.integers(0, nc, (k, hw, hw)).astype(np.int32)

    if cfg["algorithm"] in ("supervised", "swin_mae"):
        return {"image": img(lb), "label": lab(lb)}
    batch = {"label_img": img(lb), "label": lab(lb),
             "unlabel_img": img(int(cfg["unlabel_batch_size"]))}
    if cfg["algorithm"] == "hpfg":
        batch.update(label_img1=img(lb), label1=lab(lb))
    return batch


def dp_predicted(algo, path: MainPath, world: int) -> dict:
    """The path's ``predicted_launches`` and ``predicted_attention`` of
    DP_STEPS steps; under W > 1 D's backward runs as its reduce
    (``bn_reduce``) and its dpre, not ``bn_act_bwd``."""
    pred = predicted_launches(
        getattr(algo, path.unet) if path.unet else None, DP_STEPS,
        path.forwards, path.backwards, path.inner_backwards)
    if path.attn_fwd:
        pred.update(predicted_attention(algo, DP_STEPS, path.attn_fwd,
                                        path.attn_bwd))
    if world > 1:
        pred["bn_reduce"], pred["bn_act_bwd"] = pred["bn_act_bwd"], 0
        pred["bn_act_dpre"] += pred["bn_reduce"]
    return pred


def run_label(run) -> str:
    """A DP_RUNS entry's name: the path, and its dtype where not bf16."""
    label, dtype = run
    return label if dtype == "bfloat16" else f"{label} {dtype}"


def dp_steps(dev, run, states: str, publish: bool,
             collectives=None) -> dict:
    """DP_STEPS steps of a DP_RUNS entry's algorithm (in its dtype, on
    ``dev``) on this process's rows of the global batches, each step from
    the one process's state. ``publish`` (the one process): its state after
    step s is saved as ``<states>/<s + 1>.pt``. Else (a rank): that state
    is loaded before step s + 1, and after each step ``_state_diff`` says
    how far this rank's state lies from it. Returns the losses, ms per
    step, the launch counts against their prediction, and a rank's
    ``_state_diff`` of each step. With ``collectives`` (a rank: the bytes
    of each call, and a switch that times each call alone) the calls and
    bytes of every step, and in the last step each collective's time, the
    card drained before and after it (that step's own time is left out of
    ``ms``)."""
    import torch

    from hpfg_tpu_torch.parallel.mesh import get_mesh, shard_batch
    from hpfg_tpu_torch.train.algorithms import build_algorithm

    label, dtype = run
    path = {p.label: p for p in PATHS}[label]
    cfg = load_config(path.config)
    algo = build_algorithm(cfg["algorithm"], cfg,
                           dtype=getattr(torch, dtype), device=dev)
    mesh = get_mesh()
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    losses, ms, per_step, diffs, ref = [], [], [], [], None
    for s in range(DP_STEPS):
        if ref is not None:
            algo.load_state_dict(ref)
        batch = shard_batch(mesh, dp_batch(cfg, s))
        timed = collectives is not None and s == DP_STEPS - 1
        if collectives is not None:
            collectives["bytes"].clear()
            collectives["ms"] = 0.0
            collectives["on"] = timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(algo.step(batch)["loss"])
        torch.cuda.synchronize()
        if not timed:
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if collectives is not None:
            per_step.append(dict(calls=len(collectives["bytes"]),
                                 bytes=sum(collectives["bytes"])))
            if timed:
                per_step[-1]["ms_timed_alone"] = collectives["ms"]
                collectives["on"] = False
        file = os.path.join(states, f"{s + 1}.pt")
        if publish:
            torch.save(algo.state_dict(), file + ".tmp")
            os.replace(file + ".tmp", file)
        else:
            # each tensor where it was saved: generator states stay on the
            # host
            ref = torch.load(file, weights_only=False)
            diffs.append(_state_diff(algo.state_dict(), ref))
    launches = {k: fn.launches for k, fn in counters().items()}
    return dict(losses=losses, ms=ms, launches=launches,
                predicted=dp_predicted(algo, path, mesh.world),
                steps=diffs, collectives=per_step)


def gloo_cuda_support(dev) -> dict:
    """Which gloo collectives take CUDA tensors here: each tried once
    (this rank's group must be gloo); 'ok' or the error's first line."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    t = torch.ones(4 * world, device=dev)
    tries = {
        "all_reduce": lambda: dist.all_reduce(t),
        "broadcast": lambda: dist.broadcast(t, 0),
        "barrier": lambda: dist.barrier(),
        "all_gather": lambda: dist.all_gather(
            [torch.empty(4, device=dev) for _ in range(world)],
            torch.ones(4, device=dev)),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty(4, device=dev),
            [torch.ones(4, device=dev) for _ in range(world)]),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(4 * world, device=dev), t)}
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as exc:  # noqa: BLE001 - the finding itself
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
    return out


def dp_worker(rank: int, world: int, port: int, out_dir: str) -> int:
    """One rank of the data-parallel phase, over gloo on cuda:0 (every rank
    on the one card): the gloo collectives tried on CUDA tensors first;
    then, for each run i of DP_RUNS, once the one process has written
    ``run<i>/ready``, DP_STEPS steps of it from the one process's states
    in ``run<i>`` (``dp_steps``), the collectives' calls and bytes counted
    per step and, in the last step, each timed alone (the card drained
    before and after it); then ``run<i>/done<r>``.
    Writes ``rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from hpfg_tpu_torch.parallel.distributed import init_distributed

    dev = torch.device("cuda", 0)
    init_distributed(f"127.0.0.1:{port}", world, rank, device=dev,
                     backend="gloo", timeout_s=240)
    res = {"gloo_cuda": gloo_cuda_support(dev)}
    seen = {"bytes": [], "on": False, "ms": 0.0}
    real = {"all_reduce": dist.all_reduce, "broadcast": dist.broadcast}

    def counting(name):
        def call(t, *a, **k):
            seen["bytes"].append(t.numel() * t.element_size())
            if not seen["on"]:
                return real[name](t, *a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = real[name](t, *a, **k)
            torch.cuda.synchronize()
            seen["ms"] += (time.perf_counter() - t0) * 1e3
            return r
        return call

    dist.all_reduce = counting("all_reduce")
    dist.broadcast = counting("broadcast")
    deadline = time.monotonic() + DP_TIMEOUT_S
    try:
        for i, run in enumerate(DP_RUNS):
            states = os.path.join(out_dir, f"run{i}")
            _await([os.path.join(states, "ready")], [], deadline)
            res[run_label(run)] = dp_steps(dev, run, states, False, seen)
            torch.cuda.empty_cache()
            open(os.path.join(states, f"done{rank}"), "w").close()
    finally:
        dist.all_reduce, dist.broadcast = real["all_reduce"], \
            real["broadcast"]
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    sys.stdout.flush()
    os._exit(0)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _repo_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def _run_group(cmds: list, timeout: int) -> tuple[list, list]:
    """Run the commands at once (each in a session of its own); (outputs,
    exit codes). At the deadline every process still running is killed
    with its session, and its code is None."""
    import signal

    procs = [subprocess.Popen(c, cwd=REPO, env=_repo_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True) for c in cmds]
    end = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(1.0, end - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            outs.append("")
    codes = []
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            codes.append(None)
        else:
            codes.append(p.returncode)
    return outs, codes


def _model_err(got: dict, ref: dict) -> tuple[float, str]:
    """The largest difference over a model's tensors over the largest
    magnitude among them, the worst model of the state, and the tensor
    where it lies."""
    worst, where = 0.0, ""
    for model in {k.split(".")[0] for k in ref}:
        keys = [k for k in ref if k.split(".")[0] == model]
        scale = max(max(float(ref[k].abs().max()) for k in keys), 1e-30)
        for k in keys:
            err = float((got[k] - ref[k]).abs().max()) / scale
            if err > worst:
                worst, where = err, k
    return worst, where


def _state_diff(own: dict, ref: dict) -> dict:
    """How far a rank's ``state_dict()`` lies from the one process's:
    the parameters and BN buffers over each model's largest magnitude (the
    worst tensor named); SS-Net's bank likewise, the slots whose row moved
    by more than DP_STATE_TOL of the bank's largest magnitude, whether its
    validity is equal, and the rank's bank itself (on the host)."""
    import torch

    def flat(state):
        return {f"{field}.{k}": v.float()
                for field, sd in state["models"].items()
                for k, v in sd.items()}

    out = dict(zip(("state", "worst"), _model_err(flat(own), flat(ref))))
    if "memory" in ref:
        mem, ref_mem = own["memory"]["memory"], ref["memory"]["memory"]
        out["bank"] = _model_err({"memory.bank": mem.float()},
                                 {"memory.bank": ref_mem.float()})[0]
        out["slots"] = int(((mem - ref_mem).abs().amax(-1) > DP_STATE_TOL
                            * ref_mem.abs().max()).sum())
        out["valid"] = torch.equal(own["memory"]["memory_valid"],
                                   ref["memory"]["memory_valid"])
        out["memory"] = {k: v.cpu() for k, v in own["memory"].items()}
    return out


def _await(paths: list, procs: list, deadline: float) -> None:
    """Wait until every file of ``paths`` exists; raise if one of
    ``procs`` ends first or the ``time.monotonic()`` deadline passes."""
    while not all(os.path.exists(p) for p in paths):
        ended = [p.returncode for p in procs if p.poll() is not None]
        if ended:
            raise RuntimeError(f"a rank ended with exit code {ended[0]} "
                               f"before {paths}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"waited past the deadline for {paths}")
        time.sleep(0.02)


def check_data_parallel(rep: Report, dev, card: str) -> dict:
    """Phase 15: each DP_RUNS run at full width (the configs' global
    batches) for DP_STEPS steps, first in one process here, its state
    saved after each step, then over DP_WORLD ranks (``--dp-worker``
    processes, started at once and waiting for the run) over gloo, all on
    this card, each step of a rank taken from the one process's state:
    each step's loss within DP_LOSS_RTOL and the parameters and BN buffers
    after it within DP_STATE_TOL of each model's largest magnitude;
    SS-Net's bank bitwise equal on the ranks, its validity equal to one
    process's and its rows within DP_STATE_TOL (the checks of
    DP_UNMET_BF16 printed, not held, in bf16); both ranks' launch
    counters as the model's structure predicts; the step times, the
    collectives' calls, bytes and time, and which gloo collectives take
    CUDA tensors."""
    import signal

    import torch

    single, procs, logs = {}, [], []
    out_dir = tempfile.mkdtemp(prefix="hpfg_dp_")
    try:
        port = _free_port()
        for r in range(DP_WORLD):
            logs.append(open(os.path.join(out_dir, f"rank{r}.log"), "w",
                             encoding="utf-8"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-worker",
                 str(r), str(DP_WORLD), str(port), out_dir], cwd=REPO,
                env=_repo_env(), stdout=logs[-1], stderr=subprocess.STDOUT,
                start_new_session=True))
        deadline = time.monotonic() + DP_TIMEOUT_S
        for i, run in enumerate(DP_RUNS):
            states = os.path.join(out_dir, f"run{i}")
            os.makedirs(states)
            single[run_label(run)] = dp_steps(dev, run, states, True)
            torch.cuda.empty_cache()
            open(os.path.join(states, "ready"), "w").close()
            _await([os.path.join(states, f"done{r}")
                    for r in range(DP_WORLD)], procs, deadline)
            shutil.rmtree(states)
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
                 for p in procs]
        if codes != [0] * DP_WORLD:
            raise RuntimeError(f"worker exit codes {codes}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_WORLD)]
    except Exception as exc:  # noqa: BLE001 - reported with the ranks' logs
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        tails = []
        for f in logs:
            f.close()
            with open(f.name, encoding="utf-8", errors="replace") as g:
                tails.append(g.read()[-3000:])
        rep.fail(f"data parallel: {type(exc).__name__}: {exc}; the ranks' "
                 f"output tails: {tails}")
        return {}
    finally:
        for f in logs:
            f.close()
        shutil.rmtree(out_dir, ignore_errors=True)
    where = f"{DP_WORLD} ranks on one card over gloo"
    summary = {"gloo_cuda": ranks[0]["gloo_cuda"], "card": card,
               "world": DP_WORLD}
    print(f"dp: gloo with CUDA tensors: {ranks[0]['gloo_cuda']}",
          flush=True)
    for run in DP_RUNS:
        label = run_label(run)
        unmet = DP_UNMET_BF16.get(run[0], ()) if run[1] == "bfloat16" else ()
        ref = single[label]
        row = dict(losses_1=ref["losses"], ms_1=ref["ms"], not_held=unmet)
        for r, res in enumerate(ranks):
            got = res[label]
            loss = [abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                        ref["losses"])]
            state = [d["state"] for d in got["steps"]]
            worst = got["steps"][max(range(DP_STEPS),
                                     key=state.__getitem__)]["worst"]
            bad = {n: (got["launches"][n], got["predicted"][n])
                   for n in got["predicted"]
                   if got["launches"][n] != got["predicted"][n]}
            bank, missed = "", {"loss": max(loss) > DP_LOSS_RTOL,
                                "state": max(state) > DP_STATE_TOL}
            if "bank" in got["steps"][0]:
                banks = [d["bank"] for d in got["steps"]]
                valid = all(d["valid"] for d in got["steps"])
                same = all(torch.equal(d["memory"][n], d0["memory"][n])
                           for d, d0 in zip(got["steps"],
                                            ranks[0][label]["steps"])
                           for n in ("memory", "memory_valid"))
                bank = (f"; bank rel err {[f'{b:.2e}' for b in banks]} "
                        f"(slots off {[d['slots'] for d in got['steps']]} "
                        f"of {got['steps'][0]['memory']['memory_valid'].numel()}"
                        f"; bound {DP_STATE_TOL:.0e}), validity equal "
                        f"{valid}, equal to rank 0's {same}")
                missed["bank"] = max(banks) > DP_STATE_TOL
                if not valid or not same:
                    rep.fail(f"dp {label} rank {r}: memory bank{bank}")
            unmet_now = [k for k in unmet if missed[k]]
            if any(v for k, v in missed.items() if k not in unmet) or bad:
                rep.fail(f"dp {label} rank {r}: loss rel err per step "
                         f"{loss} (bound {DP_LOSS_RTOL:.0e}), state err per "
                         f"step {state} at {worst} (bound "
                         f"{DP_STATE_TOL:.0e}), launches off prediction "
                         f"{bad}{bank}")
            launched = {n: v for n, v in got["launches"].items() if v}
            row[f"rank{r}"] = dict(
                losses=got["losses"], loss_err=loss, state_err=state,
                worst=worst, ms=got["ms"], launches=launched,
                collectives=got["collectives"], unmet=unmet_now,
                **({"bank_err": banks} if bank else {}))
            print(f"dp {label} rank {r}: each step from the one process's "
                  f"state: losses {got['losses']} vs one process "
                  f"{ref['losses']} (rel err "
                  f"{[f'{v:.2e}' for v in loss]}, bound {DP_LOSS_RTOL:.0e}"
                  f"); parameters and BN buffers after each step: rel err "
                  f"{[f'{v:.2e}' for v in state]} (worst at {worst}; bound "
                  f"{DP_STATE_TOL:.0e}){bank}; launches {launched} "
                  f"{'off prediction' if bad else 'as predicted'}; "
                  f"collectives a step {got['collectives']}" + (
                      f"; not held in bf16: {list(unmet)}, unmet: "
                      f"{unmet_now}" if unmet else ""), flush=True)
        # the last step a rank does not spend timing its collectives
        last = DP_STEPS - 2
        row["ms_per_step_1"] = ref["ms"][last]
        row["ms_per_step_rank"] = [res[label]["ms"][last] for res in ranks]
        print(f"dp {label}: ms/step (step {last + 1} of {DP_STEPS}, a single "
              f"sample) one process {row['ms_per_step_1']:.1f}, per rank, "
              f"{where}: {[round(v, 1) for v in row['ms_per_step_rank']]} "
              f"({card})", flush=True)
        summary[label] = row
    return summary


def nccl_worker(port: int) -> int:
    """A 1-rank NCCL group on cuda:0: init, one all_reduce, the result."""
    import torch
    import torch.distributed as dist

    from hpfg_tpu_torch.parallel.distributed import init_distributed

    dev = torch.device("cuda", 0)
    init_distributed(f"127.0.0.1:{port}", 1, 0, device=dev, backend="nccl",
                     timeout_s=120)
    t = torch.arange(4, dtype=torch.float32, device=dev)
    dist.all_reduce(t)
    print(json.dumps({"backend": dist.get_backend(),
                      "all_reduce": t.cpu().tolist()}), flush=True)
    dist.destroy_process_group()
    return 0


def check_nccl(rep: Report, card: str) -> dict | None:
    """Phase 16: a 1-rank NCCL group initialises and all-reduces on
    cuda:0 (a process of its own)."""
    t0 = time.perf_counter()
    outs, codes = _run_group([[sys.executable, os.path.abspath(__file__),
                               "--nccl-worker", str(_free_port())]], 300)
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("{")]
    got = json.loads(lines[-1]) if lines else None
    if codes != [0] or got != {"backend": "nccl",
                               "all_reduce": [0.0, 1.0, 2.0, 3.0]}:
        rep.fail(f"nccl: exit {codes}, result {got}; output {outs[0][-1500:]}")
    print(f"nccl: 1-rank group on cuda:0: {got} in "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return got


def check_cli_dp(rep: Report, card: str, root: str, tmp: str) -> dict:
    """Phase 17: the HPFG CLI from the phase-10 tree through
    ``python -m torch.distributed.run --nproc-per-node 2`` on this card
    (``distributed=true``, ``device=cuda:0``, ``dist_backend=gloo``), 4
    steps and one eval boundary: rank 0 alone writes the log (each eval
    line once), one TensorBoard event file and the checkpoints."""
    save = os.path.join(tmp, "run_dp")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(DP_WORLD), "--master-port", str(_free_port()), "-m",
           "hpfg_tpu_torch.run", "--config", HPFG_CONFIG]
    for kv in (f"data_path={root}", f"save_path={save}", "total_itrs=4",
               "step_size=4", "distributed=true", "device=cuda:0",
               "dist_backend=gloo"):
        cmd += ["--set", kv]
    t0 = time.perf_counter()
    outs, codes = _run_group([cmd], 600)
    run_s = time.perf_counter() - t0
    log_path = os.path.join(save, "log.log")
    log = open(log_path, encoding="utf-8").read() if os.path.exists(
        log_path) else ""
    model_dir = os.path.join(save, "model")
    ckpts = sorted(f[:-3] for f in os.listdir(model_dir)) if os.path.isdir(
        model_dir) else []
    tb = os.path.join(save, "tensorboardX")
    events = [f for f in (os.listdir(tb) if os.path.isdir(tb) else [])
              if f.startswith("events.out")]
    lines = [f"iter 4 {m} dice" for m in CLI_ACDC[HPFG_CONFIG]] + [
        f"iter 4 eval over {DP_WORLD} rank(s)", "done: 4 iters"]
    counts = {k: log.count(k) for k in lines}
    if (codes != [0] or any(n != 1 for n in counts.values())
            or not {"last", "last_a"} <= set(ckpts) or len(events) > 1):
        rep.fail(f"cli dp: exit {codes}, log line counts {counts}, "
                 f"checkpoints {ckpts}, event files {events}; output tail "
                 f"{outs[0][-2000:]}")
    print(f"cli dp: torch.distributed.run --nproc-per-node {DP_WORLD} "
          f"{HPFG_CONFIG} (4 iters, eval at 4, gloo on cuda:0) exit {codes} "
          f"in {run_s:.1f} s ({card}); rank-0 log line counts {counts}; "
          f"checkpoints {ckpts}; {len(events)} event file(s)", flush=True)
    for line in log.splitlines():
        if " dice " in line or "done:" in line:
            print(f"  cli dp: {line[-150:]}", flush=True)
    shutil.rmtree(save, ignore_errors=True)
    return dict(exit=codes, run_s=run_s, line_counts=counts,
                checkpoints=ckpts, event_files=len(events))


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


#: the sm_90a kernels (A, K8, K9 and K11; B and K10; K13; K14; K12; D's
#: cooperative kernel) and the SASS instructions each instantiation must
#: hold and must not: wgmma (HGMMA) and TMA loads (UTMALDG), never
#: mma.sync (HMMA); D's kernel plain bulk copies (UBLKCP)
WGMMA_KERNELS = ("conv_sm90_kernel", "wgrad_sm90_kernel",
                 "attn_fwd_sm90_kernel", "attn_bwd_sm90_kernel",
                 "stem_sm90_kernel", "bn_coop_kernel")
SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "UBLKCP", "HMMA")


def sass_rule(func: str) -> tuple[tuple, tuple]:
    """(instructions required, instructions refused) of one instantiation
    ``name<args>`` of WGMMA_KERNELS."""
    if func.startswith("bn_coop_kernel"):
        return ("UBLKCP",), ("HMMA",)
    return ("HGMMA", "UTMALDG"), ("HMMA",)


def sass_counts(lib_path) -> dict:
    """Per instantiation of each WGMMA_KERNELS kernel in the library's SASS
    (``cuobjdump -sass``): how many HGMMA (wgmma), UTMALDG (TMA loads) and
    HMMA (mma.sync) instructions it holds."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                           "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            n = re.search(r"_kernelI((?:L[ib]\d+E)+)E", m.group(1))
            args = ", ".join(re.findall(r"L[ib](\d+)E", n.group(1))) if n \
                else ""
            func = next((f"{k}<{args}>" for k in WGMMA_KERNELS
                         if k in m.group(1)), None)
            if func:
                out[func] = dict.fromkeys(SASS_OPS, 0)
            continue
        if func:
            op = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                           line)
            if op and op.group(1) in SASS_OPS:
                out[func][op.group(1)] += 1
    return out


def main() -> int:
    import torch

    # strict fp32 in every process, the data-parallel ranks' too: their
    # fp32 runs are compared with this process's
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if len(sys.argv) > 1 and sys.argv[1] == "--dp-worker":
        sys.path.insert(0, REPO)
        return dp_worker(*map(int, sys.argv[2:5]), sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--eval-worker":
        sys.path.insert(0, REPO)
        return eval_worker(*map(int, sys.argv[2:5]), *sys.argv[5:7])
    if len(sys.argv) > 1 and sys.argv[1] == "--nccl-worker":
        sys.path.insert(0, REPO)
        return nccl_worker(int(sys.argv[2]))

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
    for line in lib.build_log.splitlines():  # wgmma serialized by ptxas
        if "C7515" in line or "serialized" in line:
            print(f"  ptxas: {line.strip()}")
    sass = sass_counts(lib.path)
    for func, ops in sass.items():
        print(f"  sass: {func}: {ops}")
    for k in WGMMA_KERNELS:
        insts = {f: ops for f, ops in sass.items() if f.startswith(k)}
        bad = {f: ops for f, ops in insts.items()
               if not all(ops[o] for o in sass_rule(f)[0])
               or any(ops[o] for o in sass_rule(f)[1])}
        if not insts or bad:
            rep.fail(f"{k}: SASS without its instructions, or with refused "
                     f"ones (sass_rule): {bad or 'no instantiation'}")

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
    phase("kernels with image ids", lambda: check_image_ids(rep, dev))
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
    loss_out = phase("losses", lambda: check_losses(rep, dev, card))
    torch.cuda.empty_cache()
    resume = {label: phase(f"resume {label}", lambda: check_resume(
        rep, dev, card, config, label))
        for label, config in (("ctct", CTCT_CONFIG), ("ssnet", SSNET_CONFIG))}
    pretrain = phase("pretrain", lambda: check_pretrain(rep, dev, card))
    cli = phase("cli", lambda: check_cli(rep, card))
    tmp = tempfile.mkdtemp(prefix="hpfg_acdc_")
    acdc = os.path.join(tmp, "acdc")
    dp = nccl = cli_dp = sharded = None
    try:
        h5_out = phase("h5", lambda: check_h5(rep, card, acdc))
        cli_acdc = phase("cli acdc", lambda: check_cli_acdc(rep, card, acdc,
                                                            tmp))
        prefetch = phase("prefetch", lambda: check_prefetch(rep, dev, card))
        torch.cuda.empty_cache()
        acdc_eval = phase("acdc eval tree", lambda: write_eval_tree(
            card, os.path.join(tmp, "acdc_eval")))
        out = (phase("async eval", lambda: check_async_eval(
            rep, dev, card, acdc, acdc_eval, tmp))
            if acdc_eval is not None else None)
        async_eval, hpfg = out if out is not None else (None, None)
        multi = (phase("multi eval", lambda: check_multi_eval(
            rep, dev, card, hpfg, acdc_eval)) if hpfg is not None else None)
        del out, hpfg
        torch.cuda.empty_cache()
        sharded = phase("sharded eval", lambda: check_sharded_eval(
            rep, dev, card, write_eval_tree(
                card, os.path.join(tmp, "acdc_sharded"),
                SHARDED_EVAL_VOLUMES)))
        dp = phase("data parallel", lambda: check_data_parallel(rep, dev,
                                                                card))
        nccl = phase("nccl", lambda: check_nccl(rep, card))
        cli_dp = phase("cli dp", lambda: check_cli_dp(rep, card, acdc, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    zoo = {}
    for name in ZOO_MODELS:
        zoo[name] = phase(f"zoo {name}", lambda: check_zoo(rep, dev, card,
                                                           name))
        torch.cuda.empty_cache()
    refused = phase("refused", lambda: check_refused(rep, dev))
    rep.close()

    if set(paths) != set(ALL_PATHS):
        rep.fail(f"main paths that ran: {sorted(paths)}")
    if None in (h5_out, cli_acdc, prefetch, async_eval, multi):
        rep.fail("a phase of 10-14 (h5, cli acdc, prefetch, async eval, "
                 "multi eval) did not complete")
    if not dp or nccl is None or cli_dp is None:
        rep.fail("a phase of 15-17 (data parallel, nccl, cli dp) did not "
                 "complete")
    if not sharded:
        rep.fail("phase 18 (sharded eval) did not complete")
    if loss_out is None:
        rep.fail("phase 19 (losses) did not complete")
    if None in zoo.values() or refused is None:
        rep.fail("a zoo model did not train, or ccnet_transunet was not "
                 "refused")
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] in
                      ("jax", "jaxlib", "flax", "hpfg_tpu"))
    if jax_side:
        rep.fail(f"JAX-side modules were imported: {jax_side[:5]}")
    kernels = kernel_line(rep, paths, {
        p: summaries[p].get("launches_by_route", {}) for p in summaries})
    with open(os.path.join(OUT_DIR, "summary.json"), "w",
              encoding="utf-8") as f:
        json.dump({"card": card, "paths": summaries, "resume": resume,
                   "pretrain": pretrain, "cli": cli, "zoo": zoo,
                   "refused": refused, "h5": h5_out, "cli_acdc": cli_acdc,
                   "prefetch": prefetch, "async_eval": async_eval,
                   "multi_eval": multi, "data_parallel": dp, "nccl": nccl,
                   "cli_dp": cli_dp, "sharded_eval": sharded,
                   "losses": loss_out,
                   "kernels": kernels}, f, indent=1,
                  default=str)
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
