"""Time variants of the conv kernels (hpfg_tpu_torch/csrc/conv3x3.cu,
conv3x3_sm90.cu and stem_sm90.cu) against each other on one CUDA card, at
every bf16 conv form and shape of the full-width UNet's main path (batch
32, 224^2) and K12's stems at the 2-D datasets' shapes (``K12 <label>``:
chip_smoke.STEM_CASES; ``K12 <label> mma``: PR 4's mma.sync route), beside
cuDNN.

    python3 scripts/tune_conv_kernels.py [--only K8,K10] [--enqueue] \
        DIR[:PART_BYTES[:TARGET_BLOCKS]][:NAME=VALUE...] ...

Each DIR holds any of the port's CUDA sources (a copy of the repo's with
one change, say); every DIR's library is built from those and the repo's
other sources, all DIRs in parallel, as the port builds its own, and
checked against the first DIR on every case (relative error above 2e-2
prints MISMATCH). The optional numbers set the mma.sync wgrad's split
(conv_block.WGRAD_PART_BYTES, WGRAD_TARGET_BLOCKS) for that entry, and
NAME=VALUE any of ``DEFAULTS`` (the wgmma grids' CONV_TALL_MAX_W,
CONV_MIN_FILL, WGRAD_SM90_PART_RATIO; K12's STEM_CTAS_PER_SM), so one
build can be timed under several grids. K8 and K10 are timed on the
route their wrappers take (wgmma for these bf16 shapes) and, as "K8 mma"
and "K10 mma", on PR 4's mma.sync kernels through the wrappers' other
launchers, so one call compares the two routes. ``--only`` keeps the
cases whose name holds one of the words. Each case is timed under each
entry in turn, 20 calls between CUDA events (host-inclusive), three
rounds, the least round counting, and once on the device alone
(chip_smoke.device_ms); with ``--enqueue`` also the µs of host time one
call takes to enqueue (chip_smoke.enqueue_us). Prints one line per case
(host-inclusive, then device-only ms, then enqueue µs) and the totals;
the rounds go to chiprun_out/tune.json.
Needs nvcc and one card; imports no JAX.
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
    """One library a DIR, from its own sources and the repo's others; a
    source that no DIR changes is compiled once for all."""
    jobs, objs = {}, {}
    for d in dirs:
        objs[d] = []
        for name in _cuda.SOURCES:
            own = os.path.join(d, name)
            src = own if os.path.exists(own) else str(_cuda.CSRC / name)
            obj = (os.path.join(d, name + ".o") if src == own else
                   os.path.join(dirs[0], "repo_" + name + ".o"))
            if obj not in jobs:
                cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I",
                       str(_cuda.CSRC), "-c", "-o", obj, src]
                jobs[obj] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True)
            objs[d].append(obj)
    logs = {obj: p.communicate()[0] for obj, p in jobs.items()}
    libs = {}
    for d in dirs:
        log = "".join(logs[o] for o in objs[d])
        out = os.path.join(d, "lib.so")
        ok = not any(jobs[o].returncode for o in objs[d])
        if ok:
            link = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS[:2],
                                   "-shared", "-o", out, *objs[d]],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            ok = link.returncode == 0
        if not ok:
            print(f"BUILD FAIL {d}\n{log[-3000:]}")
            continue
        libs[d] = _cuda.KernelLibrary(pathlib.Path(out), 0, log)
        for line in cs.ptxas_summary(log):
            if "sm90" in line or " 0 bytes spill stores" not in line:
                print(f"built {d}: {line}", flush=True)
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
            y = torch.empty((B, hh, hh, f), dtype=dt, device=dev)
            out.append((f"{name} K8 mma", lambda xa=xa, xb=xb, w=w1, b=bias, y=y:
                        (y, cb._launch_conv(xa, w, y, x2=xb, bias=b,
                                            want_sums=True)),
                        lambda x=x, w=w1: F.conv2d(cs.nchw(x), cs.oihw(w), padding=1)))
            wf = cb.flip_transpose(w1)
            out.append((f"{name} K9", lambda dp=dp, wf=wf, ca=c // 2:
                        cb.conv3x3_dgrad_pair(dp, wf, ca),
                        lambda dp=dp, wf=wf: F.conv2d(cs.nchw(dp), cs.oihw(wf), padding=1)))
            out.append((f"{name} K10", lambda xa=xa, xb=xb, dp=dp:
                        cb.conv3x3_wgrad_pair(xa, xb, dp),
                        lambda x=x, dp=dp, c=c, f=f: torch.nn.grad.conv2d_weight(
                            cs.nchw(x), (f, c, 3, 3), cs.nchw(dp), padding=1)))
            out.append((f"{name} K10 mma", lambda xa=xa, xb=xb, dp=dp:
                        cb._launch_wgrad(xa, dp, src2=xb),
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
    for label, b, hh, c in cs.STEM_CASES:
        x = rn(b, hh, hh, c).to(dt)
        w = rn(3, 3, c, 16, scale=(9 * c) ** -0.5).to(dt)
        bias = rn(16, scale=0.1)
        y = torch.empty((b, hh, hh, 16), dtype=dt, device=dev)
        out.append((f"K12 {label}", lambda x=x, w=w, b=bias:
                    cb.conv3x3_nhwc(x, w, b, want_stats=True),
                    lambda x=x, w=w: F.conv2d(cs.nchw(x), cs.oihw(w), padding=1)))
        out.append((f"K12 {label} mma", lambda x=x, w=w, b=bias, y=y:
                    (y, cb._launch_conv(x, w, y, bias=b, want_sums=True)),
                    lambda x=x, w=w: F.conv2d(cs.nchw(x), cs.oihw(w), padding=1)))
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


#: ops/conv_block.py's grid constants as the repo sets them
DEFAULTS = {name: getattr(cb, name) for name in (
    "WGRAD_PART_BYTES", "WGRAD_TARGET_BLOCKS", "CONV_TALL_MAX_W",
    "CONV_MIN_FILL", "WGRAD_SM90_PART_RATIO", "STEM_CTAS_PER_SM")}


def use(d, libs):
    """Switch to variant d: "dir", "dir:part_bytes:target_blocks" or
    "dir:NAME=VALUE..." (any of DEFAULTS; the rest keep the repo's)."""
    _cuda._LIB = libs[d.split(":")[0]]
    for name, value in DEFAULTS.items():
        setattr(cb, name, value)
    parts = d.split(":")[1:]
    nums = [p for p in parts if "=" not in p]
    for name, value in zip(("WGRAD_PART_BYTES", "WGRAD_TARGET_BLOCKS"), nums):
        setattr(cb, name, int(value))
    for p in parts:
        if "=" in p:
            name, value = p.split("=")
            setattr(cb, name, type(DEFAULTS[name])(value))


def main():
    args = sys.argv[1:]
    only = []
    if args[:1] == ["--only"]:
        only, args = args[1].split(","), args[2:]
    enqueue = args[:1] == ["--enqueue"]
    args = args[1:] if enqueue else args
    dirs = args
    libs = build(sorted({d.split(":")[0] for d in dirs}))
    libs.update({d: libs[d.split(":")[0]] for d in dirs
                 if d.split(":")[0] in libs})
    dirs = [d for d in dirs if d in libs]
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line())
    rows = [r for r in cases(dev)
            if not only or any(w in r[0].split() for w in only)]
    res = {name: {d: [] for d in dirs + ["cudnn"]} for name, _, _ in rows}
    dev_ms = {name: {} for name, _, _ in rows}
    enq_us = {name: {} for name, _, _ in rows}
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
    for name, fn, lib_fn in rows:
        for d in dirs:
            use(d, libs)
            dev_ms[name][d] = cs.device_ms(fn)
            if enqueue:
                enq_us[name][d] = cs.enqueue_us(fn)
        dev_ms[name]["cudnn"] = cs.device_ms(lib_fn)
        if enqueue:
            enq_us[name]["cudnn"] = cs.enqueue_us(lib_fn)
    tot = {d: 0.0 for d in dirs + ["cudnn"]}
    dtot = dict(tot)
    for name, r in res.items():
        best = {d: min(v) for d, v in r.items()}
        for d in tot:
            tot[d] += best[d]
            dtot[d] += dev_ms[name][d]
        print(f"{name:18} " + " ".join(
            f"{os.path.basename(d)[-14:]:>14} {best[d]:.4f} "
            f"{dev_ms[name][d]:.4f}"
            + (f" {enq_us[name][d]:.1f}us" if enqueue else "")
            for d in dirs + ["cudnn"]))
    print("TOTAL " + " ".join(f"{os.path.basename(d)}={v:.3f}/{dtot[d]:.3f}"
                              for d, v in tot.items()))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "tune.json"), "w") as f:
        json.dump({"host": res, "device": dev_ms, "enqueue_us": enq_us}, f)


if __name__ == "__main__":
    main()
