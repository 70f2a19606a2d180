"""The direct conv2d kernel's schedule and shared-memory layout
(``csrc/conv2d.cu``, mirrored below), walked in numpy on the CPU.

The emulation stages each tile's input rows as the kernel does (zeros past
the image, 16-byte slots swizzled), reads every thread's windows and tap
rows through the kernel's own address arithmetic, rounds each product and
each sum to float32 on its own, in the kernel's order (each tap row feeds
the thread's 2 output rows in turn, from the window of the input row each
meets: every output adds its taps i outer and j inner), and stores through
each warp's output stage with the kernel's lanes and edges.  It must equal
``conv2d_valid_reference`` bit for bit (NaN where it has NaN), the bar the
kernel is held to on the card.  The bank model checks that every
shared-memory access of a warp is free of bank conflicts.  A thread's
16-byte load is served a quarter-warp at a time: eight addresses that are
equal or fall in eight distinct 16-byte bank groups.
"""

import numpy as np
import pytest
import torch

from simpledsp_tpu_torch.kernels import conv2d as tk2d

THREADS = 256
TID = np.arange(THREADS)

# csrc/conv2d.cu's schedule, which is the authority (the two change
# together): a thread owns THREAD_ROWS x THREAD_COLS outputs, a block of 256
# threads a TILE_ROWS x TILE_COLS tile, a warp WARP_ROWS x WARP_COLS of it,
# which leave through the warp's output stage of 8 rows of OUT_PITCH
# floats; kw up to TEMPLATED_KW has an instance of its own, wider rows go
# TAP_STEP taps a step; a block has SMEM_MAX bytes.
THREAD_ROWS, THREAD_COLS = 2, 8
TILE_ROWS, TILE_COLS = 16 * THREAD_ROWS, 16 * THREAD_COLS
WARP_ROWS, WARP_COLS = 8 * THREAD_ROWS, 4 * THREAD_COLS
OUT_PITCH = WARP_COLS + 4
TEMPLATED_KW = 16
TAP_STEP = 8
SMEM_MAX = 232448


def kernel_plan(kh: int, kw: int) -> dict:
    """What the kernel's host code computes for a (kh, kw) kernel: the input
    rows a tile stages, their pitch (floats, a multiple of 8), the floats of
    a thread's window a row (16-byte loads), a tap row's stride in shared
    memory and the bytes (taps, the warps' output stages and two stages)."""
    if kw <= TEMPLATED_KW:
        window = (THREAD_COLS + kw - 1 + 3) & ~3
        kstride = (kw + 3) & ~3
    else:
        window = TAP_STEP * (-(-kw // TAP_STEP) - 1) + 16
        kstride = TAP_STEP * -(-kw // TAP_STEP)
    rows = TILE_ROWS + kh - 1
    pitch = (TILE_COLS - THREAD_COLS + window + 7) & ~7
    return {"rows": rows, "pitch": pitch, "window": window,
            "kstride": kstride,
            "smem": 4 * (kh * kstride + 8 * 8 * OUT_PITCH + 2 * rows * pitch)}


def thread_of(tid):
    """(row thread, column thread) of thread ``tid`` of a block (ints or
    arrays): warp w holds row threads 8 (w >> 2) .. + 7 and column threads
    4 (w & 3) .. + 3, lane l the row thread + (l >> 2), the column thread
    + (l & 3)."""
    warp, lane = tid >> 5, tid & 31
    return (warp >> 2) * 8 + (lane >> 2), (warp & 3) * 4 + (lane & 3)


def staged_slot(row, slot):
    """Where 16-byte slot ``slot`` of staged row ``row`` sits in that row:
    the row threads of a quarter-warp, THREAD_ROWS rows apart, on opposite
    parities."""
    return slot ^ ((row // THREAD_ROWS) & 1)


def _taps_smem(k, plan):
    kh, kw = k.shape
    ks = np.zeros(kh * plan["kstride"], np.float32)
    for i in range(kh):
        ks[i * plan["kstride"]: i * plan["kstride"] + kw] = k[i]
    return ks


def _stage(img, r0, c0, plan):
    """The tile's staged input (rows x pitch floats, zeros past the image),
    each 16-byte slot where the kernel puts it."""
    rows, pitch = plan["rows"], plan["pitch"]
    hp, wp = img.shape
    rr, cc = np.meshgrid(np.arange(rows), np.arange(pitch), indexing="ij")
    gr, gc = r0 + rr, c0 + cc
    ok = (gr < hp) & (gc < wp)
    vals = np.where(ok, img[np.minimum(gr, hp - 1), np.minimum(gc, wp - 1)],
                    np.float32(0))
    buf = np.full(rows * pitch, np.nan, np.float32)
    buf[rr * pitch + staged_slot(rr, cc >> 2) * 4 + (cc & 3)] = vals
    assert not np.isnan(buf).any() or np.isnan(img).any()
    return buf


def _window_addresses(tr, tc, s, plan, jb=0):
    """The float addresses of a thread's 16-byte window loads of its staged
    row s (the kernel's `even` / `odd` pointers)."""
    base = tr * THREAD_ROWS * plan["pitch"] + THREAD_COLS * tc
    sw = ((tr * THREAD_ROWS + s) // THREAD_ROWS) & 1
    even = base + s * plan["pitch"] + 4 * sw
    odd = base + s * plan["pitch"] - 4 * sw
    nq = plan["window"] // 4 if jb is None else 4
    jb = 0 if jb is None else jb
    return [(odd if q & 1 else even) + jb + 4 * q for q in range(nq)]


def _load(buf, addr):
    return np.stack([buf[a[:, None] + np.arange(4)] for a in addr], 1).reshape(
        len(addr[0]), -1)


def _store_rows(out, b, stage, wr0, wc0, o, oh, ow, vec):
    """A warp's output row o of each of its 8 row threads, from its stage
    (8 rows of OUT_PITCH floats) to ``out`` as the kernel stores it: 16-byte
    stores of 4 rows a load where the output's rows allow them, else a row
    a load."""
    lane = np.arange(32)
    for h in (range(2) if vec else range(8)):
        rr = (lane >> 3) + 4 * h if vec else np.full(32, h)
        cols = (wc0 + 4 * (lane & 7))[:, None] + np.arange(4) if vec else (
            wc0 + lane)[:, None]
        src = (rr * OUT_PITCH)[:, None] + (
            4 * (lane & 7)[:, None] + np.arange(4) if vec else lane[:, None])
        r = np.broadcast_to((wr0 + THREAD_ROWS * rr + o)[:, None],
                            cols.shape)
        keep = (r < oh) & (cols < ow)
        if vec:
            assert (keep == keep[:, :1]).all()   # whole 16-byte stores
        out[b, r[keep], cols[keep]] = stage[src[keep]]


def emulate(x, k):
    """The kernel's output for the (B, Hp, Wp) float32 image ``x`` and the
    (kh, kw) float32 taps ``k``, walked in the kernel's schedule: each tap
    row i (and, in the generic instance, each step of TAP_STEP taps) feeds
    the thread's THREAD_ROWS output rows in turn, from its window of
    staged row i + o; the outputs leave through each warp's stage."""
    b_, hp, wp = x.shape
    kh, kw = k.shape
    oh, ow = hp - kh + 1, wp - kw + 1
    plan = kernel_plan(kh, kw)
    ks = _taps_smem(k, plan)
    tr, tc = thread_of(TID)
    warp, lane = TID >> 5, TID & 31
    out = np.full((b_, oh, ow), np.float32(-123.0))
    tiles_x = -(-ow // TILE_COLS)
    tiles_y = -(-oh // TILE_ROWS)
    steps = [None] if kw <= TEMPLATED_KW else range(0, kw, TAP_STEP)
    for tile in range(b_ * tiles_x * tiles_y):
        tx, rest = tile % tiles_x, tile // tiles_x
        b, r0, c0 = (rest // tiles_y, (rest % tiles_y) * TILE_ROWS,
                     tx * TILE_COLS)
        buf = _stage(x[b], r0, c0, plan)
        acc = np.zeros((THREADS, THREAD_ROWS, THREAD_COLS),
                       np.float32)
        for i in range(kh):
            for jb in steps:
                j0 = 0 if jb is None else jb
                js = range(kw) if jb is None else range(
                    jb, min(jb + TAP_STEP, kw))
                for o in range(THREAD_ROWS):
                    w = _load(buf, _window_addresses(tr, tc, i + o, plan, jb))
                    for j in js:
                        t = ks[i * plan["kstride"] + j]
                        prod = t * w[:, j - j0: j - j0 + THREAD_COLS]
                        acc[:, o] = acc[:, o] + prod
        for wi in range(THREADS // 32):
            wr0 = r0 + (wi >> 2) * WARP_ROWS
            wc0 = c0 + (wi & 3) * WARP_COLS
            if wr0 >= oh or wc0 >= ow:
                continue                          # the warp skips the tile
            mine = warp == wi
            lr, lc = lane[mine] >> 2, lane[mine] & 3
            for o in range(THREAD_ROWS):
                stage = np.full(8 * OUT_PITCH, np.nan, np.float32)
                at = (lr * OUT_PITCH + THREAD_COLS * lc)[:, None]
                stage[at + np.arange(THREAD_COLS)] = acc[mine, o]
                _store_rows(out, b, stage, wr0, wc0, o, oh, ow, ow % 4 == 0)
    return out


SCHEDULE_CASES = [((2, 70, 140), (3, 3)),      # partial last tiles both ways
                  ((2, 75, 140), (9, 9)),
                  ((1, 80, 150), (13, 13)),
                  ((1, 17, 33), (4, 2)),
                  ((1, 200, 40), (169, 1)),
                  ((1, 8, 300), (1, 169)),     # the generic instance
                  ((3, 64, 131), (2, 3)),      # whole tiles, 1 column spare
                  ((1, 20, 60), (3, 17))]


@pytest.mark.parametrize("shape,ks", SCHEDULE_CASES)
def test_schedule_equals_plain_version_bits(shape, ks):
    rng = np.random.default_rng(shape[-1] * 31 + ks[1])
    x = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal(ks).astype(np.float32)
    got = emulate(x, k)
    want = tk2d.conv2d_valid_reference(torch.as_tensor(x),
                                       torch.as_tensor(k)).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("ks", [(3, 3), (9, 9)])
def test_schedule_keeps_inf_and_nan(ks):
    """inf and NaN in the image, and a zero tap: the same NaN positions and
    the same bits elsewhere (every tap is applied, none skipped)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 80, 140)).astype(np.float32)
    x[0, 5, 7] = np.inf
    x[0, 40, 100] = -np.inf
    x[0, 66, 3] = np.nan
    k = rng.standard_normal(ks).astype(np.float32)
    k[1, 1] = 0.0
    got = emulate(x, k)
    want = tk2d.conv2d_valid_reference(torch.as_tensor(x),
                                       torch.as_tensor(k)).numpy()
    assert np.isnan(want).any()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert np.array_equal(got[fin].view(np.int32), want[fin].view(np.int32))


def _quarters_free(addr):
    """Every quarter-warp's 16-byte accesses at float addresses ``addr``
    (32 lanes) are equal or in 8 distinct bank groups."""
    for q in range(4):
        a = np.asarray(addr[8 * q: 8 * q + 8])
        assert (a % 4 == 0).all(), a
        if len(set(a.tolist())) > 1:
            assert len(set(((a // 4) % 8).tolist())) == 8, a


@pytest.mark.parametrize("ks", [(3, 3), (9, 9), (13, 13), (4, 2), (1, 16),
                                (10, 16), (169, 1), (1, 169), (3, 17)])
def test_shared_memory_accesses_have_no_bank_conflict(ks):
    """The windows' 16-byte loads and the staging copies (16- and 4-byte)
    of every warp, at every staged row and step.  (A tap row's loads do not
    depend on the thread: one address a warp.)"""
    kh, kw = ks
    plan = kernel_plan(kh, kw)
    tr, tc = thread_of(TID)
    steps = [None] if kw <= TEMPLATED_KW else range(0, kw, TAP_STEP)
    for s in range(THREAD_ROWS + kh - 1):
        for jb in steps:
            for addr in _window_addresses(tr, tc, s, plan, jb):
                assert addr.min() >= 0 and addr.max() + 4 <= (
                    plan["rows"] * plan["pitch"])
                for w in range(THREADS // 32):
                    _quarters_free(addr[32 * w: 32 * w + 32])
    # The staging copies of each staged row, 16 and 4 bytes a lane.
    lane = np.arange(32)
    for rr in range(plan["rows"]):
        sw = (rr // THREAD_ROWS) & 1
        for q0 in range(0, plan["pitch"] // 4, 32):
            q = q0 + lane
            q = q[q < plan["pitch"] // 4]
            a16 = rr * plan["pitch"] + 4 * (q ^ sw)
            if len(q) == 32:
                _quarters_free(a16)
        for c0 in range(0, plan["pitch"], 32):
            cc = c0 + lane
            cc = cc[cc < plan["pitch"]]
            a4 = rr * plan["pitch"] + (((cc >> 2) ^ sw) << 2) + (cc & 3)
            assert len(set((a4 % 32).tolist())) == len(cc)


def test_output_stage_has_no_bank_conflict():
    """A warp's output stage (8 rows of OUT_PITCH floats): each thread's
    two 16-byte writes of an output row, the 16-byte reads behind whole
    128-byte stores (4 rows a load) and the 4-byte reads (a row a load)."""
    lane = np.arange(32)
    lr, lc = lane >> 2, lane & 3
    for h in range(2):
        _quarters_free(lr * OUT_PITCH + THREAD_COLS * lc + 4 * h)
        _quarters_free(((lane >> 3) + 4 * h) * OUT_PITCH
                       + 4 * (lane & 7))
    for rr in range(8):
        assert len(set(((rr * OUT_PITCH + lane) % 32).tolist())) == 32


@pytest.mark.parametrize("kh", [1, 2, 3, 5, 9, 13, 16, 42, 84, 169])
def test_plan_fits_a_block(kh):
    """Every kernel of at most 169 taps fits a block's shared memory with
    two stages, and its windows cover the tile and halo."""
    for kw in range(1, 169 // kh + 1):
        plan = kernel_plan(kh, kw)
        assert plan["smem"] <= SMEM_MAX
        assert plan["pitch"] % 8 == 0 and plan["kstride"] % 4 == 0
        assert plan["pitch"] >= TILE_COLS + kw - 1
        assert plan["kstride"] >= kw
