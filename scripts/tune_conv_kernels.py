"""Time variants of hpfg_tpu_torch/csrc/conv3x3.cu against each other on
one CUDA card, at every bf16 conv form and shape of the full-width UNet's
main path (batch 32, 224^2), beside cuDNN.

    python3 scripts/tune_conv_kernels.py DIR[:PART_BYTES[:TARGET_BLOCKS]] ...

Each DIR holds a conv3x3.cu (a copy of the repo's with one change, say);
all are built in parallel with the repo's window_attention.cu and hash.cuh,
and checked against the first DIR on every case (relative error above
2e-2 prints MISMATCH). The optional numbers set the wgrad split
(conv_block.WGRAD_PART_BYTES, WGRAD_TARGET_BLOCKS) for that entry, so one
build can be timed under several splits. Each case is timed under each
entry in turn, 20 calls between CUDA events, three rounds; the least
round counts. Prints one line per case and the totals; the rounds go to
chiprun_out/tune.json. Needs nvcc and one card; imports no JAX.
"""

import json
import os
import pathlib
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hpfg_tpu_torch.ops import _cuda  # noqa: E402
from hpfg_tpu_torch.ops import conv_block as cb  # noqa: E402

REPS, ROUNDS = 20, 3


def build(dirs):
    procs = {}
    for d in dirs:
        out = os.path.join(d, "lib.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
               out, os.path.join(d, "conv3x3.cu"),
               str(_cuda.CSRC / "window_attention.cu")]
        procs[d] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for d, (p, out) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"BUILD FAIL {d}\n{log[-3000:]}")
            continue
        libs[d] = _cuda.KernelLibrary(pathlib.Path(out), 0, log)
        spills = [line.strip() for line in log.splitlines()
                  if "spill stores" in line and not line.strip().startswith("0 bytes")]
        regs = [line.split("Used")[1].split(",")[0].strip()
                for line in log.splitlines() if "Used" in line]
        print(f"built {d}: regs {regs}; spills {spills}", flush=True)
    return libs


def ms(fn):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPS


def cases(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    dt = torch.bfloat16

    def rn(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale)

    B = cs.BATCH
    out = []
    for name, hh, c, f, keep in cs.BLOCKS:
        up = name.startswith("up")
        x = rn(B, hh, hh, c).to(dt)
        w1 = rn(3, 3, c, f, scale=(9 * c) ** -0.5).to(dt)
        dp = rn(B, hh, hh, f).to(dt)
        bias = rn(f, scale=0.1)
        if up:
            xa, xb = x[..., :c // 2].contiguous(), x[..., c // 2:].contiguous()
            out.append((f"{name} K8", lambda xa=xa, xb=xb, w=w1, b=bias:
                        cb.conv3x3_pair_nhwc(xa, xb, w, b, True),
                        lambda x=x, w=w1: F.conv2d(cs.nchw(x), cs.oihw(w), padding=1)))
            wf = cb.flip_transpose(w1)
            out.append((f"{name} K9", lambda dp=dp, wf=wf, ca=c // 2:
                        cb.conv3x3_dgrad_pair(dp, wf, ca),
                        lambda dp=dp, wf=wf: F.conv2d(cs.nchw(dp), cs.oihw(wf), padding=1)))
            out.append((f"{name} K10", lambda xa=xa, xb=xb, dp=dp:
                        cb.conv3x3_wgrad_pair(xa, xb, dp),
                        lambda x=x, dp=dp, c=c, f=f: torch.nn.grad.conv2d_weight(
                            cs.nchw(x), (f, c, 3, 3), cs.nchw(dp), padding=1)))
        else:
            out.append((f"{name} A1", lambda x=x, w=w1, b=bias:
                        cb.conv3x3_nhwc(x, w, b, want_stats=True),
                        lambda x=x, w=w1: F.conv2d(cs.nchw(x), cs.oihw(w), padding=1)))
            if c > 1:
                wf = cb.flip_transpose(w1)
                out.append((f"{name} A1dgrad", lambda dp=dp, wf=wf:
                            cb.conv3x3_nhwc(dp, wf),
                            lambda dp=dp, wf=wf: F.conv2d(cs.nchw(dp), cs.oihw(wf), padding=1)))
            out.append((f"{name} B1", lambda x=x, dp=dp:
                        cb.conv3x3_wgrad_nhwc(x, dp),
                        lambda x=x, dp=dp, c=c, f=f: torch.nn.grad.conv2d_weight(
                            cs.nchw(x), (f, c, 3, 3), cs.nchw(dp), padding=1)))
        # conv2: prologue forward, K11, prologue wgrad
        h = rn(B, hh, hh, f).to(dt)
        w2 = rn(3, 3, f, f, scale=(9 * f) ** -0.5).to(dt)
        a, bb = 1 + rn(f, scale=0.1), rn(f, scale=0.1)
        m, inv = rn(f, scale=0.1), 1 + rn(f, scale=0.1).abs()
        drop = cb.HashDropout(7, keep) if keep else None
        out.append((f"{name} A2", lambda h=h, w=w2, a=a, bb=bb, d=drop, b=bias:
                    cb.conv3x3_nhwc(h, w, b, affine=(a, bb), drop=d, want_stats=True),
                    lambda h=h, w=w2: F.conv2d(cs.nchw(h), cs.oihw(w), padding=1)))
        wf2 = cb.flip_transpose(w2)
        out.append((f"{name} K11", lambda dp=dp, wf=wf2, h=h, a=a, bb=bb, m=m, inv=inv, d=drop:
                    cb.conv3x3_dgrad_reduce(dp, wf, h, a, bb, m, inv, out_drop=d),
                    lambda dp=dp, wf=wf2: F.conv2d(cs.nchw(dp), cs.oihw(wf), padding=1)))
        out.append((f"{name} B2", lambda h=h, dp=dp, a=a, bb=bb, d=drop:
                    cb.conv3x3_wgrad_nhwc(h, dp, affine=(a, bb), drop=d),
                    lambda h=h, dp=dp, f=f: torch.nn.grad.conv2d_weight(
                        cs.nchw(h), (f, f, 3, 3), cs.nchw(dp), padding=1)))
    for name, hh, c, f, _ in cs.PLAIN:
        x = rn(B, hh, hh, c).to(dt)
        w = rn(3, 3, c, f, scale=(9 * c) ** -0.5).to(dt)
        dp = rn(B, hh, hh, f).to(dt)
        out.append((f"{name} Afwd", lambda x=x, w=w: cb.conv3x3_nhwc(x, w),
                    lambda x=x, w=w: F.conv2d(cs.nchw(x), cs.oihw(w), padding=1)))
        out.append((f"{name} Adgrad", lambda dp=dp, wf=cb.flip_transpose(w):
                    cb.conv3x3_nhwc(dp, wf),
                    lambda dp=dp, wf=cb.flip_transpose(w): F.conv2d(cs.nchw(dp), cs.oihw(wf), padding=1)))
        out.append((f"{name} B", lambda x=x, dp=dp: cb.conv3x3_wgrad_nhwc(x, dp),
                    lambda x=x, dp=dp, c=c, f=f: torch.nn.grad.conv2d_weight(
                        cs.nchw(x), (f, c, 3, 3), cs.nchw(dp), padding=1)))
    return out


def use(d, libs):
    """Switch to variant d ("dir" or "dir:part_bytes:target_blocks")."""
    _cuda._LIB = libs[d.split(":")[0]]
    parts = d.split(":")
    cb.WGRAD_PART_BYTES = int(parts[1]) if len(parts) > 1 else 2 ** 25
    cb.WGRAD_TARGET_BLOCKS = int(parts[2]) if len(parts) > 2 else 2048


def main():
    dirs = sys.argv[1:]
    libs = build(sorted({d.split(":")[0] for d in dirs}))
    libs.update({d: libs[d.split(":")[0]] for d in dirs
                 if d.split(":")[0] in libs})
    dirs = [d for d in dirs if d in libs]
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line())
    rows = cases(dev)
    res = {name: {d: [] for d in dirs + ["cudnn"]} for name, _, _ in rows}
    # correctness of each variant against the first on every case
    for name, fn, lib_fn in rows:
        outs = []
        for d in dirs:
            use(d, libs)
            o = fn()
            o = o if isinstance(o, tuple) else (o,)
            outs.append([t.float().clone() for t in o if t is not None])
        for d, o in zip(dirs[1:], outs[1:]):
            err = max(((u - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                      for u, v in zip(o, outs[0]))
            if err > 2e-2:
                print(f"MISMATCH {name} {d}: {err:.3e}")
    for _ in range(ROUNDS):
        for name, fn, lib_fn in rows:
            for d in dirs:
                use(d, libs)
                res[name][d].append(ms(fn))
            res[name]["cudnn"].append(ms(lib_fn))
    tot = {d: 0.0 for d in dirs + ["cudnn"]}
    for name, r in res.items():
        best = {d: min(v) for d, v in r.items()}
        for d in tot:
            tot[d] += best[d]
        print(f"{name:18} " + " ".join(f"{os.path.basename(d)[-14:]:>14} {best[d]:.4f}"
                                       for d in dirs + ["cudnn"]))
    print("TOTAL " + " ".join(f"{os.path.basename(d)}={v:.3f}" for d, v in tot.items()))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "tune.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
