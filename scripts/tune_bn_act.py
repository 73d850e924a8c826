"""Time kernels C and D (``hpfg_tpu_torch/csrc/bn_act.cu``) on one CUDA card
at the five main-path shapes of the full-width UNet (bf16, batch 32), in
several variants of the source, beside the plain versions and, given the
checkout of an earlier tree, that tree's ``ops/bn_act.py`` kernels in the
same process.

    python3 scripts/tune_bn_act.py [--earlier CHECKOUT] [DIR[:NAME=VALUE,...] ...]

Each DIR holds a bn_act.cu (a copy of the repo's with one change, say, in a
directory that .gitignore lists); all are built in parallel with the repo's
other sources. The optional NAME=VALUE pairs set constants of
``ops/bn_act.py`` while that entry runs: CTA_THREADS, TURN_STEPS (for a
copy whose NT or U differs from the repo's), and the cooperative kernel's
plan, COOP_CHUNK_BYTES, COOP_STREAM_STAGES, COOP_HOLD_CTAS_PER_SM,
COOP_STREAM_CTAS_PER_SM, COOP_MAX_HELD. Without a
DIR the repo's source is the one entry.

Cases per shape: C (``bn_act``), D (``bn_act_bwd`` as the wrapper routes
it: one launch of the cooperative kernel), D's forms forced ("hold" where
dy and pre fit the resident CTAs, "stream"), PR 6's two kernels ("walk":
reduce, then dpre from its sums), D's reduce alone (``bn_reduce``) and its
dpre alone (``bn_act_dpre``).

Two times per case, in ms per call:
  * host: ``chip_smoke.cuda_ms``, CUDA events around 10 back-to-back wrapper
    calls, the least of 3 rounds: the method of chip_smoke.py's table, which
    counts the host's cost of a call where that is longer than the kernels;
  * device: the kernels' own time (every device kernel of the call, summed)
    from torch.profiler, the median of 10 calls, each after a 64 MB write
    that leaves the L2 cache without the call's inputs.
At 14^2 also the host's enqueue time of a call (``enqueue``). Each entry's
outputs are checked against the plain version first (C bitwise, D's sums
within 1e-4 and dpre within 2e-2 of the largest magnitude; a failure
prints MISMATCH). Prints one line per case and the totals over the shapes;
the numbers go to chiprun_out/tune_bn_act.json. Needs nvcc and one card;
imports no JAX.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hpfg_tpu_torch.ops import _cuda  # noqa: E402
from hpfg_tpu_torch.ops import bn_act as ba  # noqa: E402

SHAPES = [(224, 16), (112, 32), (56, 64), (28, 128), (14, 256)]
MB = 2 ** 20


def parse(args):
    """(earlier checkout or None, [(name, dir, {constant: value})])."""
    earlier = None
    if args[:1] == ["--earlier"]:
        earlier, args = args[1], args[2:]
    entries = []
    for arg in args or [str(_cuda.CSRC)]:
        d, _, sets = arg.partition(":")
        consts = {k: int(v) for k, v in
                  (kv.split("=") for kv in sets.split(",") if kv)}
        entries.append((os.path.basename(os.path.normpath(d)) or d, d,
                        consts))
    return earlier, entries


def build(entries):
    """Each entry's library: its bn_act.cu with the repo's other sources,
    all compiled at once."""
    procs = {}
    others = [str(_cuda.CSRC / s) for s in _cuda.SOURCES if s != "bn_act.cu"]
    for name, d, _ in entries:
        out = Path(_cuda.BUILD_ROOT) / f"tune_{name}" / "libhpfg_kernels.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I",
               str(_cuda.CSRC), "-o", str(out), os.path.join(d, "bn_act.cu"),
               *others]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (p, out) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"BUILD FAIL {name}\n{log[-3000:]}", flush=True)
            continue
        libs[name] = _cuda.KernelLibrary(out, 0.0, log)
        for line in cs.ptxas_summary(log):
            if line.startswith("bn_") and "<1, 1>" in line:
                print(f"  {name} ptxas: {line}", flush=True)
        print(f"  {name} reduce CTAs per SM, bf16: "
              f"{libs[name].bn_reduce_ctas_per_sm(True)}", flush=True)
        for line in cs.ptxas_summary(log):
            if line.startswith("bn_coop"):
                print(f"  {name} ptxas: {line}", flush=True)
    return libs


DEFAULTS = dict(CTA_THREADS=ba.CTA_THREADS, TURN_STEPS=ba.TURN_STEPS,
                COOP_CHUNK_BYTES=ba.COOP_CHUNK_BYTES,
                COOP_STREAM_STAGES=ba.COOP_STREAM_STAGES,
                COOP_HOLD_CTAS_PER_SM=ba.COOP_HOLD_CTAS_PER_SM,
                COOP_STREAM_CTAS_PER_SM=ba.COOP_STREAM_CTAS_PER_SM,
                COOP_MAX_HELD=ba.COOP_MAX_HELD)


def use(libs, consts, name):
    """Switch the wrappers to entry ``name`` (the earlier tree and the
    plain versions run on the first entry's build)."""
    _cuda._LIB = libs.get(name, next(iter(libs.values())))
    for k, v in {**DEFAULTS, **consts.get(name, {})}.items():
        setattr(ba, k, v)
    ba._WALKS.clear()
    ba._PLANS.clear()


def device_ms(fn, flush, calls=10):
    """Median device time of one call of ``fn`` after a flush of L2."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    # a call's kernels are the device events between two flushes
    per_call, cur = [], None
    for e in sorted(events, key=lambda e: e.time_range.start):
        if "fill" in e.name.lower():  # the flush
            if cur is not None:
                per_call.append(cur)
            cur = 0.0
        elif cur is not None:
            cur += e.time_range.end - e.time_range.start
    if cur is not None:
        per_call.append(cur)
    return statistics.median(per_call) / 1e3 if per_call else float("nan")


def host_us(fn, calls=200):
    """Host microseconds a call takes to enqueue (no synchronisation inside
    the loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def load_earlier(checkout):
    """The earlier tree's ops/bn_act.py as a module (Triton kernels, which
    compile into this checkout's _build/triton)."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        REPO, "hpfg_tpu_torch", "_build", "triton"))
    path = os.path.join(checkout, "hpfg_tpu_torch", "ops", "bn_act.py")
    spec = importlib.util.spec_from_file_location("earlier_bn_act", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def main():
    earlier, entries = parse(sys.argv[1:])
    earlier = load_earlier(earlier) if earlier else None
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    libs = build(entries)
    consts = {name: c for name, _, c in entries}
    junk = torch.empty(64 * MB // 4, device=dev)

    def flush():
        junk.fill_(1.0)

    gen = torch.Generator(device=dev).manual_seed(0)
    names = list(libs) + (["earlier"] if earlier else []) + ["plain"]
    res = {}
    for hh, f in SHAPES:
        shape = (cs.BATCH, hh, hh, f)
        g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        a = 1 + 0.1 * torch.randn(f, generator=gen, device=dev)
        b = 0.1 * torch.randn(f, generator=gen, device=dev)
        m = 0.1 * torch.randn(f, generator=gen, device=dev)
        inv = 1 + torch.randn(f, generator=gen, device=dev).abs()
        s_r, d_r = ba.bn_act_bwd_reference(dy, g, a, b, m, inv)
        y_r = ba.bn_act_reference(g, a, b)
        n = g.numel()
        args = (dy, g, a, b, m, inv)

        def coop(form):
            return lambda: ba._coop(*args, torch.empty_like(dy), form=form)

        mine = dict(C=lambda: ba.bn_act(g, a, b),
                    D=lambda: ba.bn_act_bwd(*args),
                    hold=coop("hold"), stream=coop("stream"),
                    walk=lambda: ba._dpre(*args, ba._reduce(*args)),
                    reduce=lambda: ba.bn_reduce(*args),
                    dpre=lambda: ba.bn_act_dpre(dy, g, a, b, m, inv, s_r))
        calls = {}
        for name in libs:
            use(libs, consts, name)
            calls[name] = dict(mine)
            try:
                ba._plan(dy, False, "hold")
            except ValueError:  # dy and pre do not fit the resident CTAs
                del calls[name]["hold"]
        if earlier is not None:
            calls["earlier"] = dict(
                C=lambda: earlier.bn_act(g, a, b),
                D=lambda: earlier.bn_act_bwd(dy, g, a, b, m, inv),
                dpre=lambda: earlier.bn_act_dpre(dy, g, a, b, m, inv, s_r))
        calls["plain"] = dict(
            C=lambda: ba.bn_act_reference(g, a, b),
            D=lambda: ba.bn_act_bwd_reference(dy, g, a, b, m, inv),
            dpre=lambda: ba.bn_act_dpre_reference(dy, g, a, b, m, inv, s_r))
        for name in libs:
            use(libs, consts, name)
            if not torch.equal(ba.bn_act(g, a, b), y_r):
                print(f"MISMATCH C {hh}^2 {name}", flush=True)
            for form in ("D", "hold", "stream"):
                if form not in calls[name]:
                    continue
                d = torch.empty_like(dy)
                s = (ba.bn_act_bwd(*args) if form == "D" else
                     ba._coop(*args, d, form=form))
                s, d = s if form == "D" else (s[0], d)
                if (rel(s, s_r) > 1e-4 or rel(d, d_r) > 2e-2
                        or not torch.equal(d, ba.bn_act_dpre_reference(
                            *args, s))):
                    print(f"MISMATCH D {form} {hh}^2 {name}", flush=True)
        nbytes = dict(C=4 * n, D=6 * n, hold=6 * n, stream=6 * n, walk=6 * n,
                      reduce=4 * n, dpre=6 * n)
        # host-inclusive times first, before any profiler runs
        rows = {name: {} for name in names}
        for name in names:
            use(libs, consts, name)
            for k, fn in calls[name].items():
                rows[name][k] = [cs.cuda_ms(fn), float("nan"), nbytes[k],
                                 host_us(fn) if hh == 14 else float("nan")]
        for name in names[:-1]:
            use(libs, consts, name)
            for k, fn in calls[name].items():
                rows[name][k][1] = device_ms(fn, flush)
        use(libs, consts, next(iter(libs)))
        for name in names:
            res[f"{hh} {name}"] = rows[name]
            parts = []
            for k, (h_ms, d_ms, nb, hus) in rows[name].items():
                bound = nb / cs.HBM_BYTES_PER_S * 1e3
                parts.append(f"{k} host {h_ms:.4f} device {d_ms:.4f} "
                             f"(bound {bound:.4f}, {nb / d_ms / 1e6:.0f} GB/s"
                             + ("" if hus != hus else f", enqueue {hus:.1f} us")
                             + ")")
            print(f"{hh:>3}^2 F={f:<3} {name:>10}: " + " | ".join(parts),
                  flush=True)
        del g, dy, s_r, d_r, y_r, calls, mine
        torch.cuda.empty_cache()
    tot = {}
    for key, row in res.items():
        name = key.split(" ", 1)[1]
        for k, (h_ms, d_ms, nb, _) in row.items():
            t = tot.setdefault(name, {}).setdefault(k, [0.0, 0.0, 0.0])
            t[0] += h_ms
            t[1] += d_ms
            t[2] += nb / cs.HBM_BYTES_PER_S * 1e3
    for name, row in tot.items():
        print(f"TOTAL {name:>10}: " + " | ".join(
            f"{k} host {v[0]:.4f} device {v[1]:.4f} bound {v[2]:.4f}"
            for k, v in row.items()), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "tune_bn_act.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"card": cs.nvidia_smi_line(), "cases": res,
                   "totals": tot}, fh, indent=1)


if __name__ == "__main__":
    main()
