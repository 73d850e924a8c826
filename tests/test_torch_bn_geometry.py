"""D's cooperative kernel (``bn_coop_kernel`` in ``csrc/bn_act.cu``) on the
CPU: its route rule (``bn_route``), the plan that picks the hold or the
stream form from the bytes and the occupancy (``coop_plan``, here with a
stand-in occupancy of an H100's 227 KB an SM), the split of the rows over
the grid and their walk (every row and channel group once), and the
finish's split of the 2F columns over the grid's warps (every column once,
each by one warp in a fixed order). No card and no JAX: the plan's sizes
are ``ops/bn_act.py``'s, the kernel's thread walk and finish are mirrored
below (``_walk``, ``_finish``), all held against brute-force counts.
"""

import pytest

from hpfg_tpu_torch.ops import bn_act as ba

SMS = 132
SM_BYTES = 228 * 1024  # an H100 SM's shared memory


def occupancy(smem: int) -> int:
    """CTAs of 256 threads an SM holds at ``smem`` dynamic bytes: the
    kernel's static 16.6 KB and 1 KB reserved a CTA beside them."""
    return min(8, SM_BYTES // (smem + 2 * 8 * 256 * 4 + 32 * 8 + 1024))


def _walk(p: int, f: int, elem_bytes: int, plan: ba.CoopPlan,
          cta: int) -> list[tuple[int, int]]:
    """The (row, channel group) pairs CTA ``cta`` of the plan reads in
    phase 1 (bn_coop_kernel), in a thread-major listing of each chunk:
    thread t owns group t % G and rows t // G, t // G + R, ... of each
    chunk (G = F / V groups, R = 256 // G); threads from G * R on idle."""
    groups = f * elem_bytes // 16
    r_step = ba.CTA_THREADS // groups
    out = []
    for r0, n in ba.coop_chunks(p, plan, cta):
        for t in range(groups * r_step):
            out += [(r0 + r, t % groups)
                    for r in range(t // groups, n, r_step)]
    return out


def _finish(f: int, ctas: int) -> dict[int, tuple[int, int]]:
    """Phase 2's split of the 2F columns (bn_coop_kernel): 16-byte unit
    u (columns 4u .. 4u + 3) to (CTA, warp) = divmod(u, 8) of the grid's
    warps, each unit summed over the CTAs' rows in order by one warp."""
    warps = ba.CTA_THREADS // 32
    return {u: divmod(u % (ctas * warps), warps)
            for u in range(2 * f // 4)}


#: (rows, channels) of the five ACDC stages at batch 32
ACDC = [(32 * 14 * 14, 256), (32 * 28 * 28, 128), (32 * 56 * 56, 64),
        (32 * 112 * 112, 32), (32 * 224 * 224, 16)]


@pytest.mark.parametrize("f,es,aligned,route", [
    (16, 2, True, "coop"), (256, 2, True, "coop"), (8, 2, True, "coop"),
    (12, 2, True, "walk"), (20, 2, True, "walk"), (300, 2, True, "walk"),
    (16, 2, False, "walk"), (4, 4, True, "coop"), (12, 4, True, "coop"),
    (6, 4, True, "walk"), (2048, 2, True, "coop"), (2056, 2, True, "walk")])
def test_bn_route(f, es, aligned, route):
    assert ba.bn_route(f, es, aligned) == route


@pytest.mark.parametrize("b,forms", [
    (32, ("hold", "hold", "hold", "stream", "stream")),
    (40, ("hold", "hold", "stream", "stream", "stream")),
    (12, ("hold", "hold", "hold", "hold", "stream"))])
def test_plan_holds_what_fits_the_resident_ctas(b, forms):
    """Hold at 14^2, 28^2 and 56^2 at batch 32 (dy + pre 6.4, 12.8 and
    25.7 MB against 132 x 227 KB); 56^2 at batch 40 (32.1 MB) streams, as
    do 112^2 and 224^2 at batches 32 and 40; at batch 12 112^2 (19.3 MB)
    holds."""
    for (p, f), form in zip(ACDC, forms):
        plan = ba.coop_plan(p * b // 32, f, 2, SMS, occupancy)
        assert plan.form == form, (p, f, plan)


@pytest.mark.parametrize("p,f", ACDC + [(12 * 512 * 512, 16), (7, 8),
                                       (40 * 14 * 14, 256)])
@pytest.mark.parametrize("es", [2, 4])
def test_plan_fits_the_card(p, f, es):
    plan = ba.coop_plan(p, f, es, SMS, occupancy)
    k = plan.ctas // SMS
    assert plan.ctas % SMS == 0 and 1 <= k <= max(
        ba.COOP_HOLD_CTAS_PER_SM, ba.COOP_STREAM_CTAS_PER_SM)
    assert occupancy(plan.smem) >= k  # co-resident: the barrier's premise
    assert plan.smem <= ba.COOP_MAX_DYNAMIC
    assert plan.smem >= (2 * (plan.stages + plan.held) * plan.chunk_rows
                         * f * es)
    assert plan.stages + plan.held <= ba.COOP_MAX_STAGES
    most = max(len(ba.coop_chunks(p, plan, i)) for i in range(plan.ctas))
    fewest = min(len(ba.coop_chunks(p, plan, i)) for i in range(plan.ctas))
    assert most - fewest <= 1  # the chunks split evenly over the grid
    assert plan.chunk_rows * f * es <= ba.COOP_CHUNK_BYTES or \
        plan.chunk_rows == 1
    if plan.form == "hold":  # every chunk of every CTA has its stage
        assert plan.stages == 0
        assert plan.held >= most
    else:  # a ring, and held stages beside it while the occupancy holds
        assert plan.stages == ba.COOP_STREAM_STAGES
        assert k == min(ba.COOP_STREAM_CTAS_PER_SM,
                        occupancy(plan.stages * 2 * plan.chunk_rows * f * es))
        assert occupancy(plan.smem + 2 * plan.chunk_rows * f * es) < k \
            or plan.stages + plan.held == ba.COOP_MAX_STAGES \
            or plan.smem + 2 * plan.chunk_rows * f * es > \
            ba.COOP_MAX_DYNAMIC
    alone = ba.coop_plan(p, f, es, SMS, occupancy, reduce_only=True)
    assert alone.form == "stream" and alone.held == 0


def test_plan_forced_forms():
    p, f = ACDC[0]
    assert ba.coop_plan(p, f, 2, SMS, occupancy, form="stream").form == \
        "stream"
    assert ba.coop_plan(p, f, 2, SMS, occupancy, form="hold").form == "hold"
    with pytest.raises(ValueError):
        ba.coop_plan(*ACDC[4], 2, SMS, occupancy, form="hold")


@pytest.mark.parametrize("p,f,ctas", [(6272, 256, 264), (100352, 64, 132),
                                      (7, 8, 264), (1, 8, 1),
                                      (401408, 32, 264), (1000, 24, 7)])
def test_chunks_cover_every_row_once(p, f, ctas):
    """The grid's chunks, CTA i taking i, i + ctas, ...: every row once,
    each CTA's chunks in increasing order, at most 8 KB of bf16 each."""
    cr = ba.coop_chunk_rows(p, 2 * f, ctas)
    plan = ba.CoopPlan("stream", ctas, cr, 4, 0, 0)
    chunks = [ba.coop_chunks(p, plan, i) for i in range(ctas)]
    rows = sorted(r for cs in chunks for r0, n in cs
                  for r in range(r0, r0 + n))
    assert rows == list(range(p))
    assert all(cs == sorted(cs) for cs in chunks)
    assert cr * 2 * f <= ba.COOP_CHUNK_BYTES or cr == 1


@pytest.mark.parametrize("p,f,es,form", [
    (200, 256, 2, "hold"), (3000, 16, 2, "stream"), (777, 24, 4, "hold"),
    (50, 8, 2, "stream"), (1000, 128, 2, "stream")])
def test_walk_reads_every_row_and_group_once(p, f, es, form):
    plan = ba.coop_plan(p, f, es, 4, occupancy, form=form)
    groups = f * es // 16
    seen = [pair for cta in range(plan.ctas)
            for pair in _walk(p, f, es, plan, cta)]
    assert sorted(seen) == [(r, g) for r in range(p) for g in range(groups)]


@pytest.mark.parametrize("f", [8, 16, 64, 256, 2048])
@pytest.mark.parametrize("ctas", [132, 264, 3])
def test_finish_covers_every_column_once(f, ctas):
    units = _finish(f, ctas)
    cols = sorted(c for u in units for c in range(4 * u, 4 * u + 4))
    assert cols == list(range(2 * f))
    # warp w of CTA i takes units i * 8 + w, + 8 * ctas, ...: one warp a
    # unit, and every warp's units in increasing order
    for u, (cta, warp) in units.items():
        assert 0 <= cta < ctas and 0 <= warp < 8
        assert (u - (cta * 8 + warp)) % (8 * ctas) == 0
