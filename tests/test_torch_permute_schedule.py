"""The transpose kernel's tiles, tile order and shared-memory layout
(``csrc/probes.cu`` permute, mirrored below), walked in numpy on the CPU.

The tile shape and the instance (16-byte or 4-byte accesses) are
``kernels.probes.permute_plan``'s, the numbers the wrapper hands the
kernel.  The emulation takes the tiles in the kernel's order (units of
``rows_per_block`` rows of ``batch_per_block`` batch entries), stages each
tile's input as the kernel copies it (16-byte slots, XOR-swizzled by row)
into a buffer that holds nothing else, reads every lane's 4 x 4 block (four
16-byte reads, a row each) back through the kernel's own address
arithmetic and stores its four columns as the kernel does.  Every output element must be written exactly once,
from a slot its own tile loaded, and equal ``permute_reference`` bit for
bit.  The bank model checks the kernel's shared-memory accesses: the
16-byte reads behind the stores and the 16-byte copies of a quarter-warp
fall on 8 distinct 16-byte bank groups, the 4-byte copies of a warp on 32
distinct banks.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from simpledsp_tpu_torch.kernels import probes

THREADS = probes.PERMUTE_THREADS
WARPS = THREADS // 32
LANE = np.arange(32)


def swizzle(r, ltr):
    """csrc/probes.cu perm_swizzle: slot q of a tile sits at q ^ this."""
    return (r >> 2) & 7 if ltr >= 5 else (r >> 1) & 6


def plan_at(shape, strides, aligned, tile=None):
    """``permute_plan`` with tiles of ``tile`` floats (None: PERMUTE_TILE),
    as the variant tool's tile4k / tile16k arms set it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(probes, "PERMUTE_TILE", tile or probes.PERMUTE_TILE)
        return probes.permute_plan(shape, strides, aligned)


def _log2(v: int) -> int:
    assert v & (v - 1) == 0
    return v.bit_length() - 1


def args(shape, plan, rows_per_block=32, batch_per_block=1) -> dict:
    """The kernel's PermArgs for ``shape`` under ``plan``."""
    nb, nr, nc = shape
    tile = plan.tr * plan.tc * plan.tb
    a = {"nb": nb, "nr": nr, "nc": nc, "ltr": _log2(plan.tr),
         "ltc": _log2(plan.tc), "tb": plan.tb, "tile": tile,
         "nbt": -(-nb // plan.tb), "nrt": -(-nr // plan.tr),
         "nct": -(-nc // plan.tc)}
    a["tiles"] = a["nbt"] * a["nrt"] * a["nct"]
    # a unit wider than the view is the view
    a["ub"] = min(-(-batch_per_block // plan.tb), a["nbt"])
    a["ur"] = min(-(-rows_per_block // plan.tr), a["nrt"])
    return a


def tile_of(a, t):
    """csrc/probes.cu tile_of: tile t of the order, (bt, rt, ct)."""
    band = a["ub"] * a["nrt"] * a["nct"]
    ubi = t // band
    t -= ubi * band
    ubn = min(a["ub"], a["nbt"] - ubi * a["ub"])
    unit = ubn * a["ur"] * a["nct"]
    uri = t // unit
    t -= uri * unit
    urn = min(a["ur"], a["nrt"] - uri * a["ur"])
    per_b = urn * a["nct"]
    bi = t // per_b
    t -= bi * per_b
    return ubi * a["ub"] + bi, uri * a["ur"] + t // a["nct"], t % a["nct"]


def load_slots(a, vec):
    """For each copy of a tile (thread tid's copies tid, tid + 256, ...):
    its first element e (input order (b, r, c) in the tile), its width in
    floats, and the float address it lands at in shared memory."""
    width = 4 if vec else 1
    e = np.arange(0, a["tile"], width)
    r = (e >> a["ltc"]) & ((1 << a["ltr"]) - 1)
    addr = 4 * ((e >> 2) ^ swizzle(r, a["ltr"])) + (e & 3)
    return e, width, addr


def store_lanes(a, u):
    """Warp unit u's lanes: (tile batch entry, 4-column slot, r4) each, the
    lane owning rows 4 r4 .. 4 r4 + 3 of the slot's 4 columns."""
    ltr, lcs = a["ltr"], a["ltc"] - 2
    if ltr >= 5:
        r4 = 8 * (u & ((1 << (ltr - 5)) - 1)) + (LANE & 7)
        slot = 4 * (u >> (ltr - 5)) + (LANE >> 3)
    else:
        r4 = LANE & 3
        slot = 8 * u + (LANE >> 2)
    return slot >> lcs, slot & ((1 << lcs) - 1), r4


def read_address(a, bi, cg, r):
    """The float address of a lane's 16-byte read of row r, slot cg."""
    q = (((bi << a["ltr"]) + r) << (a["ltc"] - 2)) + cg
    return 4 * (q ^ swizzle(r, a["ltr"]))


def emulate(base, shape, strides, scale, split, plan, rows_per_block=32,
            batch_per_block=1, grid=5):
    """The kernel's output planes for the view ``shape`` / ``strides`` of
    the flat float32 ``base``, and how often each element was written."""
    nb, nr, nc = shape
    sb, sr, sc = strides
    a = args(shape, plan, rows_per_block, batch_per_block)
    half = nc // 2
    oshape = (nb, half, nr) if split else (nb, nc, nr)
    outs = [np.full(oshape, np.nan, np.float32) for _ in range(2)]
    count = [np.zeros(oshape, np.int64) for _ in range(2)]
    e, width, addr = load_slots(a, plan.vec)
    s = np.float32(scale)
    seen = []
    for blk in range(grid):
        for t in range(blk, a["tiles"], grid):
            seen.append(t)
            bt, rt, ct = tile_of(a, t)
            b0, r0, c0 = bt * plan.tb, rt * plan.tr, ct * plan.tc
            stage = np.full(a["tile"], np.nan, np.float32)
            # the kernel's bound check is on a copy's first element: a
            # 16-byte slot is loaded whole or not at all
            gb = b0 + (e >> (a["ltc"] + a["ltr"]))
            gr = r0 + ((e >> a["ltc"]) & (plan.tr - 1))
            gc = c0 + (e & (plan.tc - 1))
            ok = (gb < nb) & (gr < nr) & (gc < nc)
            src = gb * sb + gr * sr + gc * sc
            if plan.vec:
                assert (src[ok] % 4 == 0).all() and (gc[ok] + 3 < nc).all()
            for j in range(width):
                stage[(addr + j)[ok]] = base[(src + j)[ok]]
            for u in range(a["tile"] // 512):
                bi, cg, r4 = store_lanes(a, u)
                gb, gc, gr = b0 + bi, c0 + 4 * cg, r0 + 4 * r4
                live = (gb < nb) & (gc < nc) & (gr < nr)
                rows = [stage[read_address(a, bi, cg, 4 * r4 + i)[:, None]
                              + np.arange(4)] for i in range(4)]
                for k in range(4):
                    col = live & (gc + k < nc)
                    if plan.vec:
                        assert (col == live).all() and nr % 4 == 0
                    for j in range(4):
                        ok = col & (gr + j < nr)
                        v = s * rows[j][:, k]
                        for p in range(2 if split else 1):
                            sel = ok & ((gc + k >= half) == bool(p)) \
                                if split else ok
                            cc = gc[sel] + k - (half if p else 0)
                            outs[p][gb[sel], cc, gr[sel] + j] = v[sel]
                            count[p][gb[sel], cc, gr[sel] + j] += 1
    assert sorted(seen) == list(range(a["tiles"]))
    return outs[:2 if split else 1], count[:2 if split else 1]


def _check(shape, strides, size, scale=1.5, split=False, aligned=True,
           rows_per_block=32, batch_per_block=1, vec=None, tile=None,
           grid=5):
    rng = np.random.default_rng(sum(shape) + size)
    base = rng.standard_normal(size).astype(np.float32)
    plan = plan_at(shape, strides, aligned, tile)
    if vec is not None:
        assert plan.vec == vec
    outs, counts = emulate(base, shape, strides, scale, split, plan,
                           rows_per_block, batch_per_block, grid)
    view = torch.as_strided(torch.as_tensor(base), shape, strides)
    want = probes.permute_reference(view, scale, split)
    want = want if split else (want,)
    for got, n, w in zip(outs, counts, want):
        assert (n == 1).all(), "an output element written other than once"
        assert np.array_equal(got.view(np.int32), w.numpy().view(np.int32))
    return plan


def _contiguous(shape):
    nb, nr, nc = shape
    return (nr * nc, nc, 1), nb * nr * nc


# Each shape class of the probes at a reduced size: (shape, strides, base
# size, split, rows_per_block, batch_per_block, the 16-byte instance?).
_T = (16, 2048 + 128, 16)          # probe_transpose at a reduced nfr
SHAPE_CASES = {
    "transpose (1, 32)": (_T, *_contiguous(_T), False, 32, 1, True),
    "transpose (8, 2048)": (_T, *_contiguous(_T), False, 2048, 8, True),
    "transpose (8, 8192)": (_T, *_contiguous(_T), False, 8192, 8, True),
    "transpose (1, 8192)": (_T, *_contiguous(_T), False, 8192, 1, True),
    "regmix": ((64, 16, 128), *_contiguous((64, 16, 128)), False, 32, 1,
               True),
    # probe_mosaic k4: (32, F, 128).permute(1, 0, 2)
    "k4": ((96, 32, 128), (128, 96 * 128, 1), 32 * 96 * 128, False, 32, 1,
           True),
    # probe_relayout: (32, F, 128).permute(1, 0, 2), split at 64
    "relayout": ((80, 32, 128), (128, 80 * 128, 1), 32 * 80 * 128, True, 32,
                 1, True),
    # the chain arm's fmajor planes, (F, n1, n2 / 2)
    "relayout chain arm": ((70, 32, 64), *_contiguous((70, 32, 64)), False,
                           32, 1, True),
    "partial tiles": ((3, 68, 20), *_contiguous((3, 68, 20)), False, 64, 2,
                      True),
    "R = 16, B odd": ((5, 16, 48), *_contiguous((5, 16, 48)), False, 32, 1,
                      True),
    "C = 16, R = 16": ((9, 16, 16), *_contiguous((9, 16, 16)), False, 32, 3,
                       True),
    # the 4-byte instance
    "C not a multiple of 4": ((3, 100, 45), *_contiguous((3, 100, 45)),
                              False, 64, 2, False),
    "R not a multiple of 4": ((5, 101, 32), *_contiguous((5, 101, 32)),
                              False, 32, 1, False),
    "split, C / 2 odd": ((4, 40, 66), *_contiguous((4, 40, 66)), True, 32, 1,
                         False),
    "columns strided (sc != 1)": ((2, 40, 24), (960, 1, 40), 1920, False, 32,
                                  1, False),
    "row stride odd": ((3, 32, 16), (32 * 33, 33, 1), 3 * 32 * 33, False,
                       32, 1, False),
}


@pytest.mark.parametrize("name", sorted(SHAPE_CASES))
def test_schedule_writes_each_output_once_with_the_plain_bits(name):
    shape, strides, size, split, rows, batch, vec = SHAPE_CASES[name]
    _check(shape, strides, size, split=split, rows_per_block=rows,
           batch_per_block=batch, vec=vec)


def test_schedule_misaligned_base_takes_the_scalar_instance():
    """A view one float past a 16-byte boundary: 4-byte accesses, same
    bits."""
    shape = (4, 64, 32)
    strides, size = _contiguous(shape)
    plan = _check(shape, strides, size, aligned=False)
    assert not plan.vec


@pytest.mark.parametrize("tile", [2048, 4096, 16384])
@pytest.mark.parametrize("name", ["transpose (8, 2048)", "regmix", "k4",
                                  "relayout"])
def test_schedule_at_other_tile_sizes(name, tile):
    """The tile sizes the variant tool times give the same bits."""
    shape, strides, size, split, rows, batch, vec = SHAPE_CASES[name]
    _check(shape, strides, size, split=split, rows_per_block=rows,
           batch_per_block=batch, vec=vec, tile=tile, grid=3)


@pytest.mark.parametrize("nb,nr,nc,rows,batch", [
    (16, 65664, 16, 32, 1), (16, 65664, 16, 2048, 8), (16, 65664, 16, 8192, 8),
    (16, 65664, 16, 8192, 1), (16384, 16, 128, 32, 1), (4096, 32, 128, 32, 1),
    (7, 1000, 45, 96, 3), (5, 300, 40, 8192, 64)])
def test_tile_order_visits_every_tile_once(nb, nr, nc, rows, batch):
    """tile_of maps 0 .. tiles - 1 onto the tiles one to one, at the
    probes' full sizes (the (P, L) forms of probe_transpose among them),
    and keeps a unit's tiles together."""
    plan = probes.permute_plan((nb, nr, nc), (nr * nc, nc, 1), True)
    a = args((nb, nr, nc), plan, rows, batch)
    coords = np.array([tile_of(a, t) for t in range(a["tiles"])])
    flat = (coords[:, 0] * a["nrt"] + coords[:, 1]) * a["nct"] + coords[:, 2]
    assert np.array_equal(np.sort(flat), np.arange(a["tiles"]))
    unit = (coords[:, 0] // a["ub"]) * 10 ** 9 + coords[:, 1] // a["ur"]
    # a unit's tiles are consecutive in the order: the unit changes at
    # most once per unit
    changes = np.count_nonzero(np.diff(unit))
    units = -(-a["nbt"] // a["ub"]) * -(-a["nrt"] // a["ur"])
    assert changes == units - 1


PLAN_SHAPES = [(16, 65664, 16), (16384, 16, 128), (4096, 32, 128),
               (16384, 32, 64), (3, 1000, 45), (9, 16, 16), (2, 5, 3),
               (1, 1, 1), (8, 3000, 32), (8, 3000, 64), (4, 40, 8),
               (64, 8, 1000)]


@pytest.mark.parametrize("tile", [2048, 4096, 8192, 16384])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_fits_the_kernel(shape, tile):
    """Sides powers of two of at least 16, TC at most 128 and no wider
    than C needs, the tile ``tile`` floats (a whole number of slots for
    every thread), two tiles within a block's shared memory."""
    plan = plan_at(shape, (shape[1] * shape[2], shape[2], 1), True, tile)
    for side in (plan.tr, plan.tc):
        assert side >= probes.PERMUTE_MIN_SIDE and side & (side - 1) == 0
    assert plan.tc <= probes.PERMUTE_MAX_TC
    assert plan.tc < 2 * max(shape[2], 8) or plan.tc == probes.PERMUTE_MIN_SIDE
    assert plan.tr * plan.tc * plan.tb == tile
    assert tile % (4 * THREADS) == 0 and 2 * 4 * tile <= 232448


def _tile_plans():
    plans = set()
    for tile in (2048, 4096, 8192, 16384):
        for shape in PLAN_SHAPES:
            p = plan_at(shape, (shape[1] * shape[2], shape[2], 1), True,
                        tile)
            plans.add((p.tr, p.tc, p.tb))
    return sorted(plans)


@pytest.mark.parametrize("tr,tc,tb", _tile_plans())
def test_shared_memory_accesses_have_no_bank_conflict(tr, tc, tb):
    plan = probes.PermutePlan(True, tr, tc, tb)
    a = args((tb, tr, tc), plan)
    # the swizzle is a permutation of the tile's floats
    e, _, addr = load_slots(a, vec=False)
    assert np.array_equal(np.sort(addr), np.arange(a["tile"]))
    # 4-byte copies: a warp's 32 consecutive elements on 32 banks
    for w0 in range(0, a["tile"], 32):
        assert len(set((addr[w0:w0 + 32] % 32).tolist())) == 32
    # 16-byte copies: a quarter-warp's 8 consecutive slots on 8 groups
    _, _, addr16 = load_slots(a, vec=True)
    for q0 in range(0, len(addr16), 8):
        groups = (addr16[q0:q0 + 8] // 4) % 8
        assert len(set(groups.tolist())) == 8
    # the stores' 16-byte reads: a quarter-warp's rows on 8 groups
    for u in range(a["tile"] // 512):
        bi, cg, r4 = store_lanes(a, u)
        for i in range(4):
            rd = read_address(a, bi, cg, 4 * r4 + i)
            for q0 in range(0, 32, 8):
                groups = (rd[q0:q0 + 8] // 4) % 8
                assert len(set(groups.tolist())) == 8, (u, i, q0)


@pytest.mark.parametrize("tr,tc,tb", _tile_plans())
def test_store_units_cover_the_tile_and_write_whole_runs(tr, tc, tb):
    """The warp units cover every (batch entry, 4-column slot, r4) of the
    tile once; a quarter-warp's stores of a column are consecutive rows of
    one column (128 bytes), or at TR = 16 whole columns (64 bytes)."""
    plan = probes.PermutePlan(True, tr, tc, tb)
    a = args((tb, tr, tc), plan)
    seen = np.zeros((tb, tc // 4, tr // 4), np.int64)
    for u in range(a["tile"] // 512):
        bi, cg, r4 = store_lanes(a, u)
        np.add.at(seen, (bi, cg, r4), 1)
        for q in range(4):
            sl = slice(8 * q, 8 * q + 8)
            if tr >= 32:
                assert len(set(zip(bi[sl].tolist(), cg[sl].tolist()))) == 1
                assert np.array_equal(np.diff(r4[sl]), np.ones(7))
            else:
                assert np.array_equal(r4[sl], np.tile(np.arange(4), 2))
    assert (seen == 1).all()


def test_tile_and_threads_are_the_kernels():
    """PERMUTE_TILE and PERMUTE_THREADS are csrc/probes.cu's kPermTile and
    kPermThreads, which the kernel's entry holds a plan's tile to."""
    src = (Path(probes.__file__).resolve().parents[1] / "csrc"
           / "probes.cu").read_text()
    const = dict(re.findall(r"constexpr int (kPerm\w+) = (\d+);", src))
    assert int(const["kPermTile"]) == probes.PERMUTE_TILE
    assert int(const["kPermThreads"]) == probes.PERMUTE_THREADS
