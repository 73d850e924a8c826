"""BatchNorm-affine + LeakyReLU forward and backward: Triton kernels.

Replaces (hpfg_tpu/ops/pallas/conv_block.py):
  * ``bn_act``     -> ``_bn_act_kernel`` (K3): y = lrelu(a*g + b);
  * ``bn_act_bwd`` -> ``_bwd_reduce_kernel`` (K4) + ``_dpre_kernel`` (K5):
    per-channel S0 = sum(dz), S1 = sum(dz*xhat) with dz = dy*lrelu'(a*pre+b)
    and xhat = (pre-mean)*inv, then dpre = a*(dz - S0/N - xhat*S1/N);
  * ``bn_act_dpre`` -> ``_dpre_kernel`` (K5) alone, for the stage whose
    S0, S1 the conv2 dgrad already reduced in its epilogue (K11).

What bounds them on an H100: these are memory-bound passes over a
[B*H*W, F] activation (one or two reads, one write) with a handful of FLOPs
per element, so HBM bandwidth (3.35 TB/s) is the roofline. The design works
on the flattened NHWC view in 2-D blocks of [rows, F] whose loads are
contiguous and coalesced, keeps the per-channel vectors in registers, and
reduces per program into one [S0, S1] partial, summed in a fixed order by
the column-sum pass that kernels A and B use too (``_cuda.colsum``, CUDA;
deterministic, no atomics). Triton fits: no tensor-core work and
no shared-memory tiling to steer. Kernels launch with FMA contraction off
(``enable_fp_fusion=False``), so z = a*pre + b rounds as the plain version
rounds it and both take the same LeakyReLU-derivative branch.

Each wrapper takes its plain PyTorch version for CPU tensors only; for a CUDA
tensor it launches the Triton kernel or raises. ``triton`` is imported at the
first launch, never at import time. (No ``from __future__ import
annotations`` here: Triton reads the ``tl.constexpr`` annotations.)
"""

import torch

from hpfg_tpu_torch.ops._cuda import colsum, launch_counter

LRELU_SLOPE = 0.01

# triton.language, bound by _kernels() at the first launch: the kernel
# bodies resolve ``tl`` through this module's globals.
tl = None
_KERNELS = None

# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def bn_act_reference(g: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """y = lrelu(a*g + b) in fp32, stored in g's dtype."""
    z = g.float() * a + b
    return torch.where(z >= 0, z, z * LRELU_SLOPE).to(g.dtype)


def _dz_xhat(dy, pre, a, b, mean, inv):
    pf = pre.float()
    z = pf * a + b
    dz = dy.float() * torch.where(z >= 0, 1.0, LRELU_SLOPE)
    return dz, (pf - mean) * inv


def bn_act_dpre_reference(dy, pre, a, b, mean, inv, sums):
    """The elementwise pass alone: dpre = a*(dz - S0/N - xhat*S1/N) from
    given sums [2, F] fp32, in dy's dtype."""
    dz, xhat = _dz_xhat(dy, pre, a, b, mean, inv)
    n = dy.numel() // dy.shape[-1]
    return (a * (dz - sums[0] / n - xhat * (sums[1] / n))).to(dy.dtype)


def bn_act_bwd_reference(dy, pre, a, b, mean, inv):
    """Train-mode BN + LeakyReLU backward. Returns (sums [2, F] fp32 =
    [dbias, dscale], dpre in dy's dtype)."""
    dz, xhat = _dz_xhat(dy, pre, a, b, mean, inv)
    dims = tuple(range(dy.dim() - 1))
    sums = torch.stack([dz.sum(dims), (dz * xhat).sum(dims)])
    return sums, bn_act_dpre_reference(dy, pre, a, b, mean, inv, sums)


# ---------------------------------------------------------------------------
# Triton kernels
# ---------------------------------------------------------------------------

def _kernels():
    global tl, _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def bn_act_kernel(g_ptr, a_ptr, b_ptr, y_ptr, P, F,
                      BLOCK_P: tl.constexpr, BLOCK_F: tl.constexpr):
        rows = (tl.program_id(0) * BLOCK_P
                + tl.arange(0, BLOCK_P)).to(tl.int64)
        cols = tl.arange(0, BLOCK_F)
        cmask = cols < F
        mask = (rows[:, None] < P) & cmask[None, :]
        offs = rows[:, None] * F + cols[None, :]
        a = tl.load(a_ptr + cols, mask=cmask, other=0.0)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        z = g * a[None, :] + b[None, :]
        y = tl.where(z >= 0, z, z * 0.01)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def bwd_reduce_kernel(dy_ptr, pre_ptr, a_ptr, b_ptr, m_ptr, inv_ptr,
                          part_ptr, P, F, rows_per_prog,
                          BLOCK_P: tl.constexpr, BLOCK_F: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_F)
        cmask = cols < F
        a = tl.load(a_ptr + cols, mask=cmask, other=0.0)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
        m = tl.load(m_ptr + cols, mask=cmask, other=0.0)
        inv = tl.load(inv_ptr + cols, mask=cmask, other=0.0)
        s0 = tl.zeros([BLOCK_P, BLOCK_F], tl.float32)
        s1 = tl.zeros([BLOCK_P, BLOCK_F], tl.float32)
        start = pid * rows_per_prog
        for r0 in range(start, start + rows_per_prog, BLOCK_P):
            rows = (r0 + tl.arange(0, BLOCK_P)).to(tl.int64)
            mask = (rows[:, None] < P) & cmask[None, :]
            offs = rows[:, None] * F + cols[None, :]
            dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            pre = tl.load(pre_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            z = pre * a[None, :] + b[None, :]
            dz = dy * tl.where(z >= 0, 1.0, 0.01)
            xhat = (pre - m[None, :]) * inv[None, :]
            s0 += dz
            s1 += dz * xhat
        base = part_ptr + pid * 2 * F
        tl.store(base + cols, tl.sum(s0, axis=0), mask=cmask)
        tl.store(base + F + cols, tl.sum(s1, axis=0), mask=cmask)

    @triton.jit
    def dpre_kernel(dy_ptr, pre_ptr, a_ptr, b_ptr, m_ptr, inv_ptr, s_ptr,
                    out_ptr, P, F, inv_n,
                    BLOCK_P: tl.constexpr, BLOCK_F: tl.constexpr):
        rows = (tl.program_id(0) * BLOCK_P
                + tl.arange(0, BLOCK_P)).to(tl.int64)
        cols = tl.arange(0, BLOCK_F)
        cmask = cols < F
        mask = (rows[:, None] < P) & cmask[None, :]
        offs = rows[:, None] * F + cols[None, :]
        a = tl.load(a_ptr + cols, mask=cmask, other=0.0)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
        m = tl.load(m_ptr + cols, mask=cmask, other=0.0)
        inv = tl.load(inv_ptr + cols, mask=cmask, other=0.0)
        u = tl.load(s_ptr + cols, mask=cmask, other=0.0) * inv_n
        v = tl.load(s_ptr + F + cols, mask=cmask, other=0.0) * inv_n
        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        pre = tl.load(pre_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        z = pre * a[None, :] + b[None, :]
        dz = dy * tl.where(z >= 0, 1.0, 0.01)
        xhat = (pre - m[None, :]) * inv[None, :]
        out = a[None, :] * (dz - u[None, :] - xhat * v[None, :])
        tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)

    _KERNELS = dict(bn_act=bn_act_kernel, bwd_reduce=bwd_reduce_kernel,
                    dpre=dpre_kernel)
    return _KERNELS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _blocks(f: int) -> tuple[int, int]:
    block_f = max(16, 1 << (f - 1).bit_length())
    return max(1, 4096 // block_f), block_f


def _check(name: str, t: torch.Tensor, like: torch.Tensor | None = None,
           dtype=None, shape=None) -> None:
    if like is not None and (t.device != like.device or t.shape != like.shape
                             or t.dtype != like.dtype):
        raise ValueError(f"{name}: expected {tuple(like.shape)} "
                         f"{like.dtype} on {like.device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_vecs(ref: torch.Tensor, **vecs) -> None:
    f = ref.shape[-1]
    for name, v in vecs.items():
        _check(name, v, dtype=torch.float32, shape=(f,))
        if v.device != ref.device:
            raise ValueError(f"{name}: on {v.device}, data on {ref.device}")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@launch_counter
def bn_act(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = lrelu(a*g + b) over NHWC ``g`` (bf16 or fp32) with per-channel
    fp32 ``a``, ``b`` [F]; y in g's dtype."""
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bn_act: unsupported dtype {g.dtype}")
    _check("g", g)
    _check_vecs(g, a=a, b=b)
    if g.device.type == "cpu":
        return bn_act_reference(g, a, b)
    _require_cuda(g)
    k = _kernels()
    f = g.shape[-1]
    p = g.numel() // f
    y = torch.empty_like(g)
    block_p, block_f = _blocks(f)
    k["bn_act"][(_cdiv(p, block_p),)](
        g, a, b, y, p, f, BLOCK_P=block_p, BLOCK_F=block_f, num_warps=4,
        enable_fp_fusion=False)
    bn_act.launches += 1
    return y


@launch_counter
def bn_act_bwd(dy: torch.Tensor, pre: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor):
    """Backward of y = lrelu(BN(pre)) under train-mode BN. ``a``, ``b`` are
    the folded affine, ``mean``/``inv`` the batch statistics, all fp32 [F].
    Returns (sums [2, F] fp32 = [dbias, dscale], dpre in dy's dtype)."""
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bn_act_bwd: unsupported dtype {dy.dtype}")
    _check("dy", dy)
    _check("pre", pre, like=dy)
    _check_vecs(dy, a=a, b=b, mean=mean, inv=inv)
    if dy.device.type == "cpu":
        return bn_act_bwd_reference(dy, pre, a, b, mean, inv)
    _require_cuda(dy)
    k = _kernels()
    f = dy.shape[-1]
    p = dy.numel() // f
    block_p, block_f = _blocks(f)
    nblocks = _cdiv(p, block_p)
    nprog = min(nblocks, 1024)
    rows_per_prog = _cdiv(nblocks, nprog) * block_p
    nprog = _cdiv(p, rows_per_prog)
    part = torch.empty((nprog, 2 * f), dtype=torch.float32, device=dy.device)
    k["bwd_reduce"][(nprog,)](dy, pre, a, b, mean, inv, part, p, f,
                              rows_per_prog, BLOCK_P=block_p,
                              BLOCK_F=block_f, num_warps=4,
                              enable_fp_fusion=False)
    sums = colsum(part)
    dpre = _dpre(dy, pre, a, b, mean, inv, sums)
    bn_act_bwd.launches += 1
    return sums.view(2, f), dpre


@launch_counter
def bn_act_dpre(dy: torch.Tensor, pre: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                sums: torch.Tensor) -> torch.Tensor:
    """Kernel D's elementwise pass alone, from sums [2, F] fp32 that another
    kernel already reduced (the conv2 dgrad's reduce epilogue,
    ``conv_block.conv3x3_dgrad_reduce``). Returns dpre in dy's dtype."""
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bn_act_dpre: unsupported dtype {dy.dtype}")
    _check("dy", dy)
    _check("pre", pre, like=dy)
    _check_vecs(dy, a=a, b=b, mean=mean, inv=inv)
    _check("sums", sums, dtype=torch.float32, shape=(2, dy.shape[-1]))
    if sums.device != dy.device:
        raise ValueError(f"sums: on {sums.device}, data on {dy.device}")
    if dy.device.type == "cpu":
        return bn_act_dpre_reference(dy, pre, a, b, mean, inv, sums)
    _require_cuda(dy)
    dpre = _dpre(dy, pre, a, b, mean, inv, sums)
    bn_act_dpre.launches += 1
    return dpre


def _dpre(dy, pre, a, b, mean, inv, sums):
    f = dy.shape[-1]
    p = dy.numel() // f
    block_p, block_f = _blocks(f)
    dpre = torch.empty_like(dy)
    _kernels()["dpre"][(_cdiv(p, block_p),)](
        dy, pre, a, b, mean, inv, sums, dpre, p, f, 1.0 / p,
        BLOCK_P=block_p, BLOCK_F=block_f, num_warps=4, enable_fp_fusion=False)
    return dpre


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors, got {t.device}")
