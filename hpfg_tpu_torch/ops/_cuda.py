"""Build and load the hand-written CUDA kernels (``hpfg_tpu_torch/csrc``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded through ``ctypes``: seconds per build, where a source that
includes PyTorch's headers takes minutes. The library lands in
``hpfg_tpu_torch/_build/<hash of the sources>/`` at the first CUDA use, so a
changed source rebuilds and an unchanged one loads the library already built.
Nothing here runs at import time. The launch helpers shared by the kernel
wrappers (launch counter, pointers, stream, the column-sum second pass) live
here too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("conv3x3.cu", "window_attention.cu")
HEADERS = ("hash.cuh", "mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    "hpfg_tile_h": [],
    "hpfg_tile_w": [],
    "hpfg_wgrad_cm": [_I, _I],
    "hpfg_wgrad_bn": [_I, _I],
    "hpfg_conv3x3_nhwc": [_P, _P, _I, _P, _P, _P, _P, _I, _U, _U, _F, _I, _U,
                          _U, _F, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I,
                          _I, _I, _I, _I, _P],
    "hpfg_conv3x3_wgrad_nhwc": [_P, _P, _I, _P, _P, _P, _I, _U, _U, _F, _P,
                                _I, _I, _I, _I, _I, _I, _I, _P],
    "hpfg_colsum_f32": [_P, _P, _I, _I, _I, _P],
    "hpfg_attn_max_l": [],
    "hpfg_attn_max_d": [],
    "hpfg_window_attention_fwd": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _I,
                                  _U, _U, _F, _I, _I, _I, _I, _P],
    "hpfg_window_attention_bwd": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                                  _F, _I, _U, _U, _F, _I, _I, _I, _I, _P],
}


class KernelLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path = path
        self.build_seconds = seconds
        self.build_log = log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        # the conv and wgrad kernels' output tile (rows, columns)
        self.tile = (self.lib.hpfg_tile_h(), self.lib.hpfg_tile_w())
        self.attn_max_l = self.lib.hpfg_attn_max_l()
        self.attn_max_d = self.lib.hpfg_attn_max_d()

    def wgrad_tile(self, c: int, f: int, bf16: bool) -> tuple[int, int]:
        """The wgrad kernel's (input, output) channel tile for ``c`` input
        and ``f`` output channels in that dtype."""
        return (self.lib.hpfg_wgrad_cm(c, int(bf16)),
                self.lib.hpfg_wgrad_bn(f, int(bf16)))

    def call(self, name: str, *args) -> None:
        """Call one launcher; raise if the launch was refused."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); cannot build "
                           "the hpfg_tpu_torch kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> KernelLibrary:
    """Compile (if this source hash has no library yet) and load."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "libhpfg_kernels.so"
    log_path = out_dir / "build.log"
    t0 = time.perf_counter()
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libhpfg_kernels.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib_path, time.perf_counter() - t0, log)


_LIB: KernelLibrary | None = None


def library(device=None) -> KernelLibrary:
    """The process-wide kernel library, built on first use. A ``device``
    that is not CUDA raises: the kernels never run on another device."""
    global _LIB
    if device is not None and device.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors, got {device}")
    if _LIB is None:
        _LIB = build()
    return _LIB


def launch_counter(fn):
    """Give a kernel wrapper a ``launches`` count, which the wrapper bumps
    where it launches its kernel."""
    fn.launches = 0
    return fn


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


COLSUM_ROWS = 256


def colsum(part: torch.Tensor) -> torch.Tensor:
    """Sum a [R, N] fp32 CUDA tensor over rows with the colsum kernel, in a
    fixed order: the second pass of every cross-block reduction."""
    lib = library(part.device)
    r, n = part.shape
    while True:
        rows = -(-r // COLSUM_ROWS)
        out = torch.empty((rows, n), dtype=torch.float32, device=part.device)
        lib.call("hpfg_colsum_f32", ptr(part), ptr(out), r, n, COLSUM_ROWS,
                 stream(part))
        if rows == 1:
            return out[0]
        part, r = out, rows
