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

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("conv3x3.cu", "conv3x3_sm90.cu", "window_attention.cu",
           "window_attention_sm90.cu", "bn_act.cu", "stem_sm90.cu")
HEADERS = ("hash.cuh", "mma.cuh", "sm90.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "hpfg_tile_h": [],
    "hpfg_tile_w": [],
    "hpfg_wgrad_cm": [_I, _I],
    "hpfg_wgrad_bn": [_I, _I],
    "hpfg_conv3x3_nhwc": [_P, _P, _I, _P, _P, _P, _P, _I, _U, _U, _F, _P, _I,
                          _U, _U, _F, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                          _I, _I, _I, _I, _I, _I, _P],
    "hpfg_conv3x3_wgrad_nhwc": [_P, _P, _I, _P, _P, _P, _I, _U, _U, _F, _P,
                                _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "hpfg_colsum_f32": [_P, _P, _I, _I, _I, _P],
    "hpfg_conv_sm90_tile_h": [_I],
    "hpfg_conv_sm90_tile_w": [_I],
    "hpfg_pair_wgrad_tile_h": [],
    "hpfg_pair_wgrad_tile_w": [],
    "hpfg_conv_sm90": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _U,
                       _U, _F, _P, _I, _U, _U, _F, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "hpfg_wgrad_sm90": [_P, _P, _P, _P, _P, _P, _I, _U, _U, _F, _P, _I, _I,
                        _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "hpfg_attn_max_l": [],
    "hpfg_attn_max_d": [],
    "hpfg_window_attention_fwd": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _I,
                                  _U, _U, _F, _P, _I, _I, _I, _I, _I, _P],
    "hpfg_window_attention_bwd": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                                  _F, _I, _U, _U, _F, _P, _I, _I, _I, _I, _I,
                                  _P],
    "hpfg_attn_sm90_fwd": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _I, _U,
                           _U, _F, _P, _I, _I, _I, _I, _I, _P],
    "hpfg_attn_sm90_bwd": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _F, _I, _U, _U, _F, _P, _I, _I, _I, _I,
                           _I, _P],
    "hpfg_attn_sm90_dbias_group": [],
    "hpfg_stem_tile_h": [_I],
    "hpfg_stem_tile_w": [],
    "hpfg_stem_sm90": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P],
    "hpfg_bn_reduce_ctas_per_sm": [_I],
    "hpfg_bn_act": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _P],
    "hpfg_bn_reduce": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                       _I, _I, _I, _I, _P],
    "hpfg_bn_dpre": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                     _I, _I, _P],
    "hpfg_bn_coop_ctas_per_sm": [_I, _I],
    "hpfg_bn_coop": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                     _I, _I, _I, _I, _P],
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
        # the wgmma kernels' pixel tiles: the conv's (A, K8), wide (False)
        # and tall (True), and the wgrad's (B, K10)
        self.conv_sm90_tiles = {
            tall: (self.lib.hpfg_conv_sm90_tile_h(int(tall)),
                   self.lib.hpfg_conv_sm90_tile_w(int(tall)))
            for tall in (False, True)}
        self.pair_conv_tile = self.conv_sm90_tiles[False]
        self.pair_wgrad_tile = (self.lib.hpfg_pair_wgrad_tile_h(),
                                self.lib.hpfg_pair_wgrad_tile_w())
        self.attn_max_l = self.lib.hpfg_attn_max_l()
        self.attn_max_d = self.lib.hpfg_attn_max_d()
        # K14's dbias groups on the wgmma route (partial rows a group sums)
        self.attn_dbias_group = self.lib.hpfg_attn_sm90_dbias_group()
        # K12's stem tile (rows, columns) at F = 16 and 32 output channels
        self.stem_tiles = {f: (self.lib.hpfg_stem_tile_h(f),
                               self.lib.hpfg_stem_tile_w()) for f in (16, 32)}
        self._bn_occupancy: dict[bool, int] = {}
        self._coop_occupancy: dict[tuple[bool, int], int] = {}

    def wgrad_tile(self, c: int, f: int, bf16: bool) -> tuple[int, int]:
        """The wgrad kernel's (input, output) channel tile for ``c`` input
        and ``f`` output channels in that dtype."""
        return (self.lib.hpfg_wgrad_cm(c, int(bf16)),
                self.lib.hpfg_wgrad_bn(f, int(bf16)))

    def bn_reduce_ctas_per_sm(self, bf16: bool) -> int:
        """CTAs an SM holds of D's reduce kernel in that dtype, from the
        occupancy API of the current device."""
        if bf16 not in self._bn_occupancy:
            n = self.lib.hpfg_bn_reduce_ctas_per_sm(int(bf16))
            if n <= 0:
                raise RuntimeError(
                    f"hpfg_bn_reduce_ctas_per_sm: CUDA error {-n}")
            self._bn_occupancy[bf16] = n
        return self._bn_occupancy[bf16]

    def bn_coop_ctas_per_sm(self, bf16: bool, smem: int) -> int:
        """CTAs an SM holds of D's cooperative kernel in that dtype with
        ``smem`` bytes of dynamic shared memory (occupancy API, current
        device)."""
        key = (bf16, smem)
        if key not in self._coop_occupancy:
            n = self.lib.hpfg_bn_coop_ctas_per_sm(int(bf16), smem)
            if n < 0:
                raise RuntimeError(
                    f"hpfg_bn_coop_ctas_per_sm: CUDA error {-n}")
            self._coop_occupancy[key] = n
        return self._coop_occupancy[key]

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
        pid = os.getpid()
        objs = [out_dir / f"{Path(s).stem}.{pid}.o" for s in SOURCES]
        # one nvcc a source, all at once, then one link
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(CSRC / s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        tmp = out_dir / f"libhpfg_kernels.{pid}.so"
        if not failed:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                                   str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed = ["link"]
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
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
    (``counted``) where it launches its kernel."""
    fn.launches = 0
    return fn


_COUNT_LOCK = threading.Lock()
#: depth of the active ``reporting_flops`` blocks (count_flops)
_flop_reporting = 0


def counted(fn, like: torch.Tensor, flops: int = 0) -> None:
    """Count one launch of ``fn``'s kernel (under a lock: the overlapped
    eval launches kernels from its own thread) and, inside
    ``reporting_flops``, report its ``flops`` operations to the active
    ``FlopCounterMode``, which cannot see a ctypes launch; ``like`` is a
    tensor of the launch's device."""
    with _COUNT_LOCK:
        fn.launches += 1
    if flops and _flop_reporting:
        torch.ops.hpfg_tpu_torch.kernel_flops(like, flops)


@contextlib.contextmanager
def reporting_flops():
    """Within the block, every kernel launch reports its operations to an
    active ``torch.utils.flop_counter.FlopCounterMode`` through the op
    ``hpfg_tpu_torch::kernel_flops``, whose FLOP formula is its argument
    (registered here on first use)."""
    global _flop_reporting
    if not hasattr(torch.ops.hpfg_tpu_torch, "kernel_flops"):
        from torch.utils.flop_counter import register_flop_formula

        lib = torch.library.Library("hpfg_tpu_torch", "DEF")
        lib.define("kernel_flops(Tensor like, int flops) -> Tensor")
        lib.impl("kernel_flops", lambda like, flops: like.new_empty(0),
                 "CompositeExplicitAutograd")
        _LIBRARIES.append(lib)
        register_flop_formula(torch.ops.hpfg_tpu_torch.kernel_flops)(
            lambda _like, flops, *_, **__: flops)
    _flop_reporting += 1
    try:
        yield
    finally:
        _flop_reporting -= 1


#: the torch.library registrations, kept alive for the process
_LIBRARIES: list = []


_SMS: dict[int, int] = {}
_TICKETS: dict[tuple[int, str], torch.Tensor] = {}


def sm_count(device: torch.device) -> int:
    """The SMs of CUDA ``device``, read from its properties once."""
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def ticket(device: torch.device, kernel: str, n: int = 1) -> torch.Tensor:
    """The ticket counters of ``kernel``'s last-CTA reductions on CUDA
    ``device``: at least ``n`` int32, allocated zeroed (again, larger, when
    a launch needs more), which the kernel's last CTAs reset to 0 at every
    launch."""
    key = (device.index, kernel)
    if key not in _TICKETS or _TICKETS[key].numel() < n:
        _TICKETS[key] = torch.zeros(n, dtype=torch.int32,
                                    device=torch.device("cuda", key[0]))
    return _TICKETS[key]


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the raw handle (the call
    builds no Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


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
