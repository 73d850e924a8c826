#!/usr/bin/env python3
"""How far the SegFormer B0's bf16 gradients lie from its fp32 ones, on the
CPU and on the card, over several seeds.

    python3 scripts/segformer_bf16_grads.py [--seeds 10]

For each seed, one train-mode forward and backward of sum(logits * dy) in
four runs, bf16 and fp32 on the CPU and on CUDA device 0, by
``segformer_grads`` of ``tests/test_torch_gpu_kernels.py`` (64x64, 4
images, drop rates 0; the parameters whose exact gradient is zero left
out). For each pair of runs it prints, over all parameters at once, the L2
distance relative to the reference's norm, the largest error relative to
the reference's largest magnitude, and the cosine; then for each seed the
ratio that the bf16 GPU test bounds, the card's bf16 L2 distance from the
CPU's fp32 gradients over the CPU's own bf16 distance, and the spread of
that ratio. Writes ``chiprun_out/segformer_bf16_grads.json``. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compare(got: dict, ref: dict) -> dict:
    flat_g = torch.cat([got[n].float().cpu().reshape(-1) for n in ref])
    flat_r = torch.cat([ref[n].float().cpu().reshape(-1) for n in ref])
    return dict(
        l2_rel=((flat_g - flat_r).norm() / flat_r.norm()).item(),
        joint_max_rel=((flat_g - flat_r).abs().max()
                       / flat_r.abs().max()).item(),
        cosine=torch.nn.functional.cosine_similarity(flat_g, flat_r,
                                                     dim=0).item())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("segformer_bf16_grads: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # by path: ``tests`` is no package, and one installed elsewhere under
    # that name would shadow it
    spec = importlib.util.spec_from_file_location(
        "gpu_kernel_tests", os.path.join(REPO, "tests",
                                         "test_torch_gpu_kernels.py"))
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    segformer_grads = tests.segformer_grads

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    seeds = []
    for seed in range(args.seeds):
        runs = {(d, dev.type): segformer_grads(d, dev, seed)[2]
                for d in (torch.bfloat16, torch.float32)
                for dev in (cpu, card)}
        ref = runs[(torch.float32, "cpu")]
        pairs = {
            "cpu bf16 vs cpu fp32": compare(runs[(torch.bfloat16, "cpu")],
                                            ref),
            "card bf16 vs cpu fp32": compare(runs[(torch.bfloat16, "cuda")],
                                             ref),
            "card bf16 vs cpu bf16": compare(runs[(torch.bfloat16, "cuda")],
                                             runs[(torch.bfloat16, "cpu")]),
            "card fp32 vs cpu fp32": compare(runs[(torch.float32, "cuda")],
                                             ref),
        }
        ratio = (pairs["card bf16 vs cpu fp32"]["l2_rel"]
                 / pairs["cpu bf16 vs cpu fp32"]["l2_rel"])
        seeds.append(dict(seed=seed, ratio=ratio, pairs=pairs))
        for name, row in pairs.items():
            print(f"seed {seed} {name}: L2 {row['l2_rel']:.5f}, largest "
                  f"error {row['joint_max_rel']:.5f} of the largest "
                  f"magnitude, cosine {row['cosine']:.6f}")
        print(f"seed {seed} ratio card/cpu bf16 L2: {ratio:.4f}", flush=True)
    ratios = [s["ratio"] for s in seeds]
    print(f"ratio over {len(ratios)} seeds: min {min(ratios):.4f} max "
          f"{max(ratios):.4f} mean {sum(ratios) / len(ratios):.4f}")
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "segformer_bf16_grads.json"), "w",
              encoding="utf-8") as f:
        json.dump({"card": torch.cuda.get_device_name(0), "seeds": seeds},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
