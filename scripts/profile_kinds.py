#!/usr/bin/env python3
"""Device work of one traced step by kind of kernel, from the
``profile_<path>.txt`` files that ``chip_smoke.py`` writes.

    python3 scripts/profile_kinds.py chiprun_out/chip_smoke/profile_*.txt

Each file lists one step's device kernels, copies and memsets by name with
their time and count (``chip_smoke.profile_step``). This sums them into
cuDNN convolutions, cuBLAS matmuls, reductions, the optimizer's foreach
kernels, elementwise kernels and copies, and the rest, and prints one line
a file: ms and launches of each kind and its share of the device work.
"""

from __future__ import annotations

import re
import sys

#: kind -> patterns of kernel names, tried in order
KINDS = (
    ("cuDNN", ("cudnn", "implicit_gemm", "conv2d_", "dgrad2d_", "wgrad2d_",
               "nhwcaddpadding", "tensortransform", "nchwtonhwc",
               "nhwctonchw")),
    ("cuBLAS", ("gemm", "nvjet", "cutlass")),
    ("reductions", ("reduce_kernel", "batch_norm")),
    ("optimizer", ("multi_tensor_apply",)),
    ("elementwise and copies", ("elementwise", "copy")),
)
ROW = re.compile(r"\s*([\d.]+) ms\s+[\d.]+% x(\d+)\s+(.*)")


def kind(name: str) -> str:
    low = name.lower()
    for label, patterns in KINDS:
        if any(p in low for p in patterns):
            return label
    return "other"


def summarize(path: str) -> str:
    sums: dict[str, list] = {}
    with open(path, encoding="utf-8") as f:
        for line in f.read().splitlines()[1:]:
            m = ROW.match(line)
            if m:
                row = sums.setdefault(kind(m.group(3)), [0.0, 0])
                row[0] += float(m.group(1))
                row[1] += int(m.group(2))
    total = sum(ms for ms, _ in sums.values()) or 1.0
    parts = [f"{k} {ms:.2f} ms x{n} ({100 * ms / total:.1f}%)"
             for k, (ms, n) in sorted(sums.items(), key=lambda kv: -kv[1][0])]
    return f"{path}: {total:.2f} ms; " + ", ".join(parts)


def main(paths: list[str]) -> int:
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    for path in paths:
        print(summarize(path))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
