"""K12, the stem conv on its own kernel (``csrc/stem_sm90.cu``), on the CPU:
the route rule (``conv_route``'s "stem", ``stem_ok``), the persistent
grid (``stem_grid``), and a torch model of the kernel's packed-K operand
against the plain conv and the JAX package's ``_conv_stats_c1_kernel``.

The model mirrors the kernel's index math: each tile's halo box (TMA's
zero fill outside the image, 8 pixels of margin each side of the 32
columns), each pixel's K row gathered from it at the offsets the kernel
fixes per thread ((tap // 3 - 1) * box width + (tap % 3 - 1) * C + c for
k = tap * C + c < 9C, zero up to 16 or 32), times the packed weights
(HWIO flattened to [9C, F], zero rows to match), plus bias, and the
[sum, sum^2] of the fp32 result. Inputs are seeded numpy values rounded
to bf16 and computed in fp32 on both sides; tolerance 1e-5 relative to
the reference's largest magnitude (another summation order). The JAX
side runs ``fused_conv_block`` in interpret mode, whose C = 1 stem is
``_conv_stats_c1_kernel`` (its conv1 output and the statistics it
feeds), at 1e-4 (the Pallas kernel rounds its conv1 output to the
compute dtype, fp32 here, and sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfg_tpu.ops.pallas import conv_block as jcb
from hpfg_tpu_torch.ops import conv_block as cb

TW, PAD = 32, 8  # stem_sm90.cu ST_TW, ST_PAD


def _tile_h(f: int) -> int:
    return 512 // f  # stem_sm90.cu StemTile::TH


def _packed_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """The kernel's computation in fp32 by its own walk: y [B, H, W, F] and
    the [2, F] statistics over in-image pixels."""
    b, h, wd, c = x.shape
    f = w.shape[3]
    th, k = _tile_h(f), 9 * c
    kp = 16 if k <= 16 else 32
    bw = (TW + 2 * PAD) * c
    wp = torch.zeros(kp, f)
    wp[:k] = w.reshape(k, f)
    offk = [((t // c) // 3 - 1) * bw + ((t // c) % 3 - 1) * c + t % c
            for t in range(k)]
    y = torch.zeros(b, h, wd, f)
    s0, s1 = torch.zeros(f), torch.zeros(f)
    flat = x.reshape(b, h, wd * c)
    for img in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, wd, TW):
                # the halo box: rows y0 - 1 .., elements (x0 - PAD) * C ..,
                # zeros outside the image
                box = torch.zeros(th + 2, bw)
                for r in range(th + 2):
                    gy = y0 - 1 + r
                    if not 0 <= gy < h:
                        continue
                    e0 = (x0 - PAD) * c
                    lo, hi = max(e0, 0), min(e0 + bw, wd * c)
                    box[r, lo - e0:hi - e0] = flat[img, gy, lo:hi]
                box = box.reshape(-1)
                a = torch.zeros(th * TW, kp)
                for p in range(th * TW):
                    centre = (p // TW + 1) * bw + (p % TW + PAD) * c
                    a[p, :k] = box[[centre + o for o in offk]]
                out = (a @ wp + bias).reshape(th, TW, f)
                rows, cols = min(th, h - y0), min(TW, wd - x0)
                inside = out[:rows, :cols]
                y[img, y0:y0 + rows, x0:x0 + cols] = inside
                s0 += inside.sum((0, 1))
                s1 += (inside * inside).sum((0, 1))
    return y, torch.stack([s0, s1])


def _inputs(b, hw, c, f, seed=0):
    rng = np.random.default_rng(seed)

    def bf(*s, scale=1.0):
        v = torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))
        return v.to(torch.bfloat16).float()

    return (bf(b, hw[0], hw[1], c), bf(3, 3, c, f, scale=(9 * c) ** -0.5),
            torch.from_numpy((rng.normal(size=f) * 0.1).astype(np.float32)))


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("c,f,b,hw", [
    (1, 16, 2, (40, 40)),    # two tiles across, the second ragged
    (3, 16, 1, (33, 70)),    # ragged rows and columns
    (1, 32, 1, (20, 64)),    # the F = 32 tile (16 rows)
    (3, 32, 2, (18, 24))])
def test_packed_operand_times_packed_weights_is_the_conv(c, f, b, hw):
    x, w, bias = _inputs(b, hw, c, f)
    y, st = _packed_conv(x, w, bias)
    y_r, st_r = cb.conv3x3_reference(x, w, bias, want_stats=True)
    assert _rel(y, y_r) <= 1e-5
    assert _rel(st, st_r) <= 1e-5


def test_packed_operand_matches_the_pallas_c1_stem():
    """At C = 1 against ``_conv_stats_c1_kernel`` in interpret mode (its
    conv1 output, the packed h2 of ``_forward``, and the batch mean and
    variance ``fused_conv_block`` returns from its sums)."""
    b, hw, f = 2, (16, 16), 16
    x, w, bias = _inputs(b, hw, 1, f, seed=3)
    rng = np.random.default_rng(4)
    p = {k: (rng.normal(size=s) * 0.2).astype(np.float32) for k, s in (
        ("w2", (3, 3, f, f)), ("b2", (f,)), ("bias1", (f,)),
        ("bias2", (f,)))}
    params = jcb.ConvBlockParams(
        w1=jnp.asarray(w.numpy()), b1=jnp.asarray(bias.numpy()),
        scale1=jnp.ones(f), bias1=jnp.asarray(p["bias1"]),
        w2=jnp.asarray(p["w2"]), b2=jnp.asarray(p["b2"]),
        scale2=jnp.ones(f), bias2=jnp.asarray(p["bias2"]))
    xj = jnp.asarray(x.numpy())
    _, h2, _, _ = jcb._forward(xj, params, None, None, True, interpret=True)
    _, stats = jcb.fused_conv_block(xj, params, None, None, True, True, None,
                                    None)
    y, st = _packed_conv(x, w, bias)
    n = b * hw[0] * hw[1]
    mean, var = cb.finalize_stats(st, n)
    h_j = torch.from_numpy(np.array(h2)).reshape(b, *hw, f)
    assert _rel(y, h_j) <= 1e-4
    assert _rel(mean, torch.from_numpy(np.array(stats.mean1))) <= 1e-4
    assert _rel(var, torch.from_numpy(np.array(stats.var1))) <= 1e-4


@pytest.mark.parametrize("c,f,dtype,aligned,width,route", [
    (1, 16, torch.bfloat16, True, 224, "stem"),    # ACDC, Synapse
    (3, 16, torch.bfloat16, True, 96, "stem"),     # LIDC
    (3, 16, torch.bfloat16, True, 224, "stem"),    # ISIC
    (3, 16, torch.bfloat16, True, 512, "stem"),    # Building
    (1, 32, torch.bfloat16, True, 224, "stem"),
    (1, 16, torch.bfloat16, True, 20, "mma"),      # 40-byte rows
    (1, 16, torch.bfloat16, True, 100, "mma"),     # 200-byte rows
    (3, 16, torch.bfloat16, True, 90, "mma"),      # 540-byte rows
    (1, 16, torch.bfloat16, True, 7, "mma"),
    (1, 16, torch.float32, True, 224, "mma"),      # fp32
    (1, 16, torch.bfloat16, False, 224, "mma"),    # unaligned base
    (1, 8, torch.bfloat16, True, 224, "mma"),      # F not 16 or 32
    (1, 64, torch.bfloat16, True, 224, "mma"),
    (2, 16, torch.bfloat16, True, 224, "mma"),     # C not 1 or 3
    (16, 1, torch.bfloat16, True, 224, "mma"),     # SS-Net's stem dgrad
    (16, 16, torch.bfloat16, True, 224, "wgmma")])
def test_stem_route(c, f, dtype, aligned, width, route):
    assert cb.conv_route(c, f, dtype, aligned, "conv", width=width) == route


@pytest.mark.parametrize("form", ["prologue", "out_drop", "wgrad"])
def test_stem_route_is_the_plain_forward_alone(form):
    route = cb.conv_route(1, 16, torch.bfloat16, True, form, width=224)
    assert route == "mma"


@pytest.mark.parametrize("b,hw,f,ctas", [
    (32, 224, 16, 264),   # ACDC: 1568 tiles
    (1, 64, 16, 4),       # fewer tiles than CTAs
    (40, 224, 16, 264),   # ISIC
    (12, 512, 32, 264),   # F = 32: tiles of 16 x 32
    (32, 96, 16, 264)])   # LIDC: 288 tiles
def test_stem_grid(b, hw, f, ctas):
    tile = (_tile_h(f), TW)
    tiles = b * -(-hw // tile[0]) * -(-hw // tile[1])
    assert cb.stem_grid(b, hw, hw, tile, 132) == min(tiles, ctas)
    # the walk t = cta, cta + grid, ... takes every tile once
    seen = sorted(t for i in range(min(tiles, ctas))
                  for t in range(i, tiles, min(tiles, ctas)))
    assert seen == list(range(tiles))
