"""Time variants of the window-attention kernels K13 and K14
(hpfg_tpu_torch/csrc/window_attention_sm90.cu and window_attention.cu)
against each other on one CUDA card, at every main-path shape of
``chip_smoke.attention_cases`` (the ACDC SwinUNet at batch 32, Swin-MAE at
24, the LIDC SwinUNet at 24), bf16 with attention dropout at keep 0.9.

    python3 scripts/tune_attention_kernels.py [--only WORD,...] \
        DIR[:FWD=n][:BWD=n] ...

Each DIR holds any of the port's CUDA sources (a copy of the repo's with
one change, say); every DIR's library is built from those and the repo's
other sources, all DIRs in parallel, as scripts/tune_conv_kernels.py
builds, and checked against the first DIR on every case (relative error
above 2e-2 prints MISMATCH). FWD=n and BWD=n set the CTAs an SM the
wgmma route's grid aims for at D <= 32 (ops/window_attention.py
SM90_CTAS_PER_SM), for a copy whose __launch_bounds__ or shared memory
fit another count. Each case is timed on the device alone
(chip_smoke.device_ms) under each entry, on the wgmma route and once, as
"mma", on window_attention.cu's mma.sync kernels; ``--only`` keeps the
cases whose label holds one of the words (acdc, mae, lidc, K13, K14).
Prints each DIR's count of ptxas notes that it serialized wgmmas (C7520),
one line per case and the totals by kernel and group. Needs nvcc and one
card; imports no JAX.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hpfg_tpu_torch.ops import _cuda  # noqa: E402
from hpfg_tpu_torch.ops import window_attention as wa  # noqa: E402
from tune_conv_kernels import build  # noqa: E402

DEFAULT_CTAS = dict(wa.SM90_CTAS_PER_SM)


def use(d, libs):
    """Switch to variant d: "dir" or "dir:FWD=n:BWD=n"."""
    _cuda._LIB = libs[d.split(":")[0]]
    wa.SM90_CTAS_PER_SM.update(DEFAULT_CTAS)
    for part in d.split(":")[1:]:
        name, value = part.split("=")
        back = {"FWD": False, "BWD": True}[name]
        wa.SM90_CTAS_PER_SM[back] = (int(value), DEFAULT_CTAS[back][1])


def cases(dev):
    """(label, the K13 or K14 call on a route) at every attention case."""
    from hpfg_tpu_torch.models.swinunet import _shift_attention_mask
    from hpfg_tpu_torch.ops.conv_block import HashDropout

    g = torch.Generator(device=dev).manual_seed(5)
    out = []
    for label, batch, stage, side, heads, ws, shifted in cs.attention_cases():
        l, nw = ws * ws, (side // ws) ** 2
        bn, c = batch * nw, heads * cs.ATTN_D
        qkv = torch.randn((bn, l, 3 * c), generator=g,
                          device=dev).to(torch.bfloat16)
        do = torch.randn((bn, l, c), generator=g,
                         device=dev).to(torch.bfloat16)
        bias = torch.randn((heads, l, l), generator=g, device=dev) * 0.02
        mask = (torch.from_numpy(_shift_attention_mask(
            side, side, ws, ws // 2)).to(dev) if shifted else None)
        drop = HashDropout(66 + stage, 0.9)
        what = f"{label} stage {stage} {'s' if shifted else 'u'}"
        out.append((f"K13 {what}", False, (qkv, bias, mask, heads, drop)))
        out.append((f"K14 {what}", True, (qkv, bias, mask, do, heads, drop)))
    return out


def main():
    args = sys.argv[1:]
    only = []
    if args[:1] == ["--only"]:
        only, args = args[1].split(","), args[2:]
    dirs = args
    libs = build(sorted({d.split(":")[0] for d in dirs}))
    libs.update({d: libs[d.split(":")[0]] for d in dirs
                 if d.split(":")[0] in libs})
    dirs = [d for d in dirs if d in libs]
    for d in sorted({d.split(":")[0] for d in dirs}):
        notes = sum("C7520" in line for line in libs[d].build_log.splitlines())
        print(f"{d}: {notes} ptxas notes of serialized wgmmas (C7520)")
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    rows = [r for r in cases(dev)
            if not only or any(w in r[0].split() for w in only)]
    cols = dirs + ["mma"]
    tot = {}
    for name, backward, args_ in rows:
        outs, times = [], {}
        for d in dirs:
            use(d, libs)
            o = wa._launch("wgmma", backward, *args_)
            o = o if isinstance(o, tuple) else (o,)
            outs.append([t.float().clone() for t in o])
            times[d] = cs.device_ms(
                lambda: wa._launch("wgmma", backward, *args_))
        for d, o in zip(dirs[1:], outs[1:]):
            err = max(((u - v).abs().max()
                       / v.abs().max().clamp_min(1e-30)).item()
                      for u, v in zip(o, outs[0]))
            if err > 2e-2:
                print(f"MISMATCH {name} {d}: {err:.3e}", flush=True)
        use(dirs[0], libs)
        times["mma"] = cs.device_ms(lambda: wa._launch("mma", backward,
                                                       *args_))
        print(f"{name:24s} " + " ".join(f"{d}={times[d]:.4f}" for d in cols),
              flush=True)
        for key in (name.split()[0], " ".join(name.split()[:2])):
            acc = tot.setdefault(key, dict.fromkeys(cols, 0.0))
            for d in cols:
                acc[d] += times[d]
    for key, acc in tot.items():
        print(f"total {key:10s} " + " ".join(f"{d}={acc[d]:.4f}"
                                              for d in cols), flush=True)


if __name__ == "__main__":
    main()
