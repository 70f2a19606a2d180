"""The half-spectrum layouts of the port's fused chain
(``fused_chain_frames(half_spectrum=True, layout=...)``,
``simpledsp_tpu_torch.kernels.chain_variants``) against the JAX package's,
in Pallas interpret mode, and against the scipy + numpy oracle, on the CPU.

On the CPU each layout runs its kernel's plain version; the kernels
themselves are checked against it in ``test_torch_cuda.py``.  The index
arithmetic of the chain kernel at a layout's g, of its store forms'
staging, and of the "regs" kernel's split IIR block (its planes, table,
fragments and K steps) is emulated here on the CPU.

Tolerances: float64 layouts agree with JAX and the packed oracle to 1e-11
of the largest bin (sums in different orders); "regs" is a float32 scheme:
>= 125 dB against the float64 oracle (the JAX package's own bar for it) and
within 2e-6 of the largest bin of the JAX "regs" result (float32 sums in
another order).  Host tables bit for bit.
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu.design.biquad import sos_matrix
from simpledsp_tpu.kernels import chain as jchain
from simpledsp_tpu.kernels import chain_variants as jcv
from simpledsp_tpu.models.northstar import default_design as j_default_design
from simpledsp_tpu.ops.fft import _dft_mats_f64 as j_dft_mats
from simpledsp_tpu_torch.convert import design_from_numpy
from simpledsp_tpu_torch.kernels import chain as tchain
from simpledsp_tpu_torch.kernels import chain_variants as tcv
from simpledsp_tpu_torch.kernels.fft import _best_split

HALF_LAYOUTS = ["reg", "regp", "regw", "reg2", "reg4", "k1", "fmajor", "pair"]


def _ops(n, dtype=torch.float64):
    jd = j_default_design()
    td = design_from_numpy(jd.b, jd.a, jd.gain, jd.ftype, jd.f0, jd.fs, jd.q)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (jchain.FusedNorthStarOperators(jd, n, dtype=jdt),
            tchain.FusedNorthStarOperators(td, n, dtype=dtype, device="cpu"))


def _packed_oracle(design, x, n):
    y = sig.sosfilt(sos_matrix(design), x, axis=-1)
    full = np.fft.rfft(y.reshape(x.shape[0], -1, n))
    packed = full[..., : n // 2].copy()
    packed[..., 0] += 1j * full[..., n // 2].real
    return packed


def _both(n, x, s0, dtype=torch.float64, **kw):
    jops, tops = _ops(n, dtype)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    (jr, ji), _ = jchain.fused_chain_frames(
        jops, jnp.asarray(x, jdt), jnp.asarray(s0, jdt), half_spectrum=True,
        interpret=True, frames_per_tile=4, **kw)
    (tr, ti), _ = tchain.fused_chain_frames(
        tops, torch.as_tensor(x, dtype=dtype), torch.as_tensor(s0, dtype=dtype),
        half_spectrum=True, frames_per_tile=4, **kw)
    return (np.asarray(jr), np.asarray(ji)), (tr.numpy(), ti.numpy()), jops


@pytest.mark.parametrize("layout,n", [(lay, 1024) for lay in HALF_LAYOUTS]
                         + [("reg", 4096), ("regp", 4096), ("pair", 4096)])
def test_layout_matches_jax_and_oracle(layout, n, rng):
    x = rng.standard_normal((2, 8 * n))
    s0 = np.zeros((2, 10))
    (jr, ji), (tr, ti), jops = _both(n, x, s0, layout=layout)
    assert tr.shape == ti.shape == jr.shape == (2, 8, n // 2 // jops.n1,
                                                jops.n1)
    packed = _packed_oracle(jops.design, x, n)
    scale = float(np.abs(packed).max())
    for got, want in ((tr, jr), (ti, ji)):
        assert np.abs(got - want).max() <= 1e-11 * scale
    got = (tr + 1j * ti).reshape(packed.shape)
    assert np.abs(got - packed).max() <= 1e-11 * scale


@pytest.mark.parametrize("layout", HALF_LAYOUTS)
@pytest.mark.parametrize("n", [1024, 4096])
def test_flat_out_shapes_match_jax(layout, n, rng):
    """flat_out gives the JAX shapes for every layout: (C F, n2/2/qf,
    qf n1) for "reg*" and "k1", the (C, F, n2/2, n1) planes for "pair" and
    "fmajor", which ignore it."""
    x = rng.standard_normal((2, 4 * n))
    s0 = 0.1 * rng.standard_normal((2, 10))
    (jr, ji), (tr, ti), _ = _both(n, x, s0, layout=layout, flat_out=True)
    assert tr.shape == ti.shape == jr.shape
    scale = float(np.abs(jr).max())
    assert np.abs(tr - jr).max() <= 1e-11 * scale
    assert np.abs(ti - ji).max() <= 1e-11 * scale


@pytest.mark.parametrize("n1", [1, 2, 4, 6, 8, 16, 32, 64, 128])
def test_bf16_split3_equals_jax_bit_for_bit(n1):
    w = np.concatenate(j_dft_mats(n1), axis=0)
    want = np.asarray(jcv._bf16_split3(w)).astype(np.float64)
    got = tcv._bf16_split3(w)
    assert got.shape == want.shape == (6 * n1, 3 * n1)
    np.testing.assert_array_equal(got, want)
    h, m, low = got[:2 * n1, :n1], got[2 * n1:4 * n1, :n1], got[4 * n1:, :n1]
    assert np.abs(h + m + low - w).max() <= 2.0 ** -24


def test_bf16_round_near_ties_as_ml_dtypes(rng):
    """float64 -> bfloat16 as JAX casts it (through float32), also at and
    just beside bfloat16 ties, where one direct rounding would differ."""
    base = rng.standard_normal(20000).astype(ml_dtypes.bfloat16).astype(
        np.float64)
    ulp = np.abs(base) * 2.0 ** -7
    v = np.concatenate([base + ulp / 2, base - ulp / 2,
                        base + ulp / 2 * (1 + 2.0 ** -30),
                        base + ulp / 2 * (1 - 2.0 ** -30),
                        rng.standard_normal(20000) * 1e-20])
    np.testing.assert_array_equal(
        tcv._bf16_round(v), v.astype(ml_dtypes.bfloat16).astype(np.float64))


@pytest.mark.parametrize("n1", [1, 2, 3, 5, 8, 16, 24, 32, 100, 128])
def test_regw_qf_and_resolve_layout_match_jax(n1):
    for n2h in (1, 3, 50, 63, 64):
        assert tcv._regw_qf(n1, n2h) == jcv._regw_qf(n1, n2h)
    assert tchain.resolve_layout(n1) == jchain.resolve_layout(n1)


@pytest.mark.parametrize("n", [1024, 4096])
def test_regs_float32_snr_and_jax(n, rng):
    """"regs" in float32: the split step 1 holds >= 125 dB against the
    float64 oracle and stays within float32 rounding of the JAX "regs"."""
    x = rng.standard_normal((2, 8 * n))
    (jr, ji), (tr, ti), jops = _both(n, x, np.zeros((2, 10)),
                                     dtype=torch.float32, layout="regs")
    assert tr.shape == jr.shape and tr.dtype == np.float32
    packed = _packed_oracle(jops.design, x, n)
    got = (tr.astype(np.float64) + 1j * ti.astype(np.float64)).reshape(
        packed.shape)
    snr = 10 * np.log10((np.abs(packed) ** 2).sum()
                        / (np.abs(got - packed) ** 2).sum())
    assert snr >= 125.0
    scale = float(np.abs(packed).max())
    assert np.abs(tr - jr).max() <= 2e-6 * scale
    assert np.abs(ti - ji).max() <= 2e-6 * scale


def test_regs_needs_float32_and_unknown_layouts_raise(rng):
    _, tops = _ops(1024)
    x = torch.as_tensor(rng.standard_normal((2, 4096)))
    s0 = torch.zeros(2, tops.state_dim, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        tchain.fused_chain_frames(tops, x, s0, half_spectrum=True,
                                  layout="regs")
    with pytest.raises(ValueError, match="unknown layout"):
        tchain.fused_chain_frames(tops, x, s0, half_spectrum=True,
                                  layout="regq")
    # The full spectrum ignores the layout, as in JAX.
    (yr, _), _ = tchain.fused_chain_frames(tops, x, s0, layout="regq")
    assert yr.shape == (2, 4, tops.n2, tops.n1)


@pytest.mark.parametrize("layout,n1,n2,r,want", [
    ("reg2", 32, 128, 64, 2), ("reg4", 32, 128, 64, 4),
    ("reg4", 32, 128, 2, 2), ("reg4", 32, 128, 1, 1),
    ("regp", 8, 128, 64, 16), ("regp", 8, 128, 4, 4),
    ("regp", 6, 128, 64, 2), ("regp", 2, 128, 64, 64),
    ("regp", 128, 128, 64, 1), ("pair", 32, 128, 64, 2),
    ("pair", 32, 128, 3, 1), ("reg4", 128, 128, 64, 1),
    # N = 4096, 16384 and 200 at the tiles of 16 x 2^20 samples.
    ("reg2", 32, 128, 64, 2), ("reg4", 32, 128, 64, 4),
    ("regp", 32, 128, 64, 4), ("pair", 32, 128, 64, 2),
    ("reg2", 128, 128, 32, 1), ("reg4", 128, 128, 32, 1),
    ("regp", 128, 128, 32, 1), ("pair", 128, 128, 32, 1),
    ("regp", 2, 100, 32, 32)])
def test_group_frames(layout, n1, n2, r, want):
    """g as the JAX package resolves it from its tile r, then halved until
    the chain kernel's block fits: 4 frames of 128 x 128 do not (32768 FFT
    values a block, the kernel takes 8192), 64 of 2 x 128 do."""
    assert tcv.group_frames(layout, n1, n2, r, 10) == want
    assert tchain._natural_fits(n1, n2, 10, want)


def _natural_walk(x3, s3, tables, g):
    """``chain_natural_kernel``'s half spectrum (``csrc/chain.cu``) walked in
    float64 with its own index arithmetic, g frames a block: each block's
    frames stacked as rows of kLdx = 132 floats with no per-frame padding,
    zero rows up to g n1 rounded up to 8, the starts transposed into rows
    of d rounded up to 4, the IIR block over every row, z read from y by the
    block's value index, the FFT core (``_core_walk``) per frame, the split.
    The last block may hold fewer frames."""
    from test_torch_fft import _core_walk

    from simpledsp_tpu_torch.kernels import fft as tkfft

    frames, n1, n2 = x3.shape
    d = s3.shape[1]
    m = n1 * n2 // 2
    ldx, dp = 132, -(-d // 4) * 4
    rows = -(-g * n1 // 8) * 8
    ht = np.zeros((128, 128))
    ht[:n2, :n2] = tables.HT.numpy()
    phit = np.zeros((d, 128))
    phit[:, :n2] = tables.PhiT.numpy()
    x, s = x3.numpy().reshape(-1), s3.numpy().reshape(-1)
    sp = tkfft._split_table_f64(n1 * n2)
    spec = np.empty((frames, m), dtype=complex)
    for f0 in range(0, frames, g):
        nf = min(g, frames - f0)
        xs = np.zeros(rows * ldx)
        st = np.zeros(rows * dp)
        i = np.arange(nf * n1 * n2)
        p = i // n2
        xs[p * ldx + i - p * n2] = x[f0 * n1 * n2 + i]
        i = np.arange(nf * d * n1)
        q, r = i // (d * n1), i % (d * n1)
        st[(q * n1 + r % n1) * dp + r // n1] = s[f0 * d * n1 + i]
        ys = np.zeros((rows, ldx))
        ys[:, :128] = (xs.reshape(rows, ldx)[:, :128] @ ht
                       + st.reshape(rows, dp)[:, :d] @ phit)
        ys = ys.reshape(-1)
        e = 2 * np.arange(nf * m)
        row = e // n2
        at = row * ldx + e - row * n2
        z = _core_walk((ys[at] + 1j * ys[at + 1]).reshape(nf, m), m)
        out = spec[f0:f0 + nf]
        out[:, 0] = (z[:, 0].real + z[:, 0].imag
                     + 1j * (z[:, 0].real - z[:, 0].imag))
        for k in range(1, m // 2 + 1):
            a, b = z[:, k], z[:, m - k]
            wr, wi = sp[k]
            er, ei = 0.5 * (a.real + b.real), 0.5 * (a.imag - b.imag)
            dr, di = 0.5 * (a.real - b.real), 0.5 * (a.imag + b.imag)
            u, v = wr * di + wi * dr, wi * di - wr * dr
            out[:, k] = (er + u) + 1j * (ei + v)
            if 2 * k < m:
                out[:, m - k] = (er - u) + 1j * (v - ei)
    return spec


@pytest.mark.parametrize("n,g", [(200, 16), (768, 3), (1024, 4), (4096, 2)])
def test_grouped_natural_walk_gives_the_spectra(n, g, rng):
    """The grouped layouts' kernel, ``chain_natural_kernel`` at the
    caller's g, walked in float64 (:func:`_natural_walk`) over 2 g + 1
    frames (the last block partial), gives the plain version's spectra
    (1e-12 of the largest bin)."""
    _, tops = _ops(n)
    x = torch.as_tensor(rng.standard_normal((1, (2 * g + 1) * n)))
    s0 = torch.as_tensor(rng.standard_normal((1, tops.state_dim)))
    x3, s3, _ = tchain.chain_prepass(tops, x, s0)
    spec = _natural_walk(x3, s3, tops.tables(), g)
    ref_re, ref_im = tchain.chain_frames_reference(x3, s3, tops.tables())
    scale = float(max(ref_re.abs().max(), ref_im.abs().max()))
    np.testing.assert_allclose(spec.real, ref_re.numpy(), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(spec.imag, ref_im.numpy(), rtol=0,
                               atol=1e-12 * scale)


@pytest.mark.parametrize("n", [256, 768, 1024, 4096, 16384])
def test_store_staging_maps(n, rng):
    """The staging of the store forms in ``chain_natural_kernel`` (kWide,
    "regw"; kFmajor, "fmajor"), walked at the kernel's own g for n1 = 2, 6,
    8, 32 and 128: the split puts bin k of frame q at p = q M + k (kWide)
    or p + p // lcm(n1, 32) (kFmajor), each place once, within half of y's
    space (rows x 66 floats a plane); the kWide readout (16-byte quads of
    consecutive places) gives the natural-order planes and the kFmajor
    readout (value e = (q, k1, k2) from the place of bin k1 + n1 k2) the
    k1-major rows, also for a block short of frames; and each warp's
    kFmajor read (32 consecutive e) touches 32 distinct banks."""
    n1, n2 = _best_split(n)
    m, h = n // 2, n2 // 2
    g = tchain._natural_frames(n1, n2)
    rows = -(-g * n1 // 8) * 8
    lpad = n1 * 32 // math.gcd(n1, 32)
    place = {"wide": lambda p: p, "fmajor": lambda p: p + p // lpad}
    for nf in sorted({g, max(1, g - 1)}):
        spec = rng.standard_normal((nf, m))
        p = np.arange(nf * m)
        e = np.arange(nf * m)
        q, r = e // m, e % m
        k1 = r // h
        bins = q * m + k1 + n1 * (r - k1 * h)
        for store, at in place.items():
            assert at(p).max() < rows * 66
            assert len(np.unique(at(p))) == len(p)
            stage = np.full(rows * 66, np.nan)
            stage[at(p)] = spec.reshape(-1)
            if store == "wide":
                assert m % 4 == 0
                got = stage[:nf * m].reshape(-1, 4).reshape(nf, m)
                np.testing.assert_array_equal(got, spec)
                continue
            got = stage[at(bins)].reshape(nf, n1, h)
            np.testing.assert_array_equal(
                got, spec.reshape(nf, h, n1).transpose(0, 2, 1))
            if nf == g:
                for w0 in range(0, nf * m, 32):
                    banks = at(bins[w0:w0 + 32]) % 32
                    assert len(set(banks.tolist())) == len(banks), (n, w0)


def _ldmatrix_x4(plane, lda, row0, col0):
    """``ldmatrix.x4`` as the kernel runs it: lane l gives the address of
    row row0 + l % 16, column col0 + 8 (l / 16) of a row-major bf16 plane
    (row stride lda); matrix i is the 8 rows lanes 8 i .. 8 i + 7 address,
    and lane T receives row T / 4, columns 2 (T % 4) and + 1 of each.
    Returns (32, 4, 2): lane, register, half."""
    lane = np.arange(32)
    addr = (row0 + (lane & 15)) * lda + col0 + ((lane >> 4) << 3)
    regs = np.empty((32, 4, 2))
    for i in range(4):
        rows = addr[8 * i: 8 * i + 8]               # the matrix's 8 rows
        at = rows[lane >> 2] + 2 * (lane & 3)
        regs[:, i, 0], regs[:, i, 1] = plane[at], plane[at + 1]
    return regs


def _mma(a, b):
    """``mma.sync.m16n8k16.row.col``: (32, 4, 2) A registers and (32, 2, 2)
    B registers (lane = 4 gid + tig) as the PTX fragment layout places them
    (a0: row gid, columns 2 tig + {0, 1}; a1: row gid + 8; a2, a3: columns
    + 8; b0: rows 2 tig + {0, 1} of column gid, b1: rows + 8), multiplied in
    float64; returns the (32, 4) C registers (c0, c1: row gid, columns
    2 tig + {0, 1}; c2, c3: row gid + 8)."""
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    am = np.zeros((16, 16))
    bm = np.zeros((16, 8))
    for e in range(2):
        am[gid, 2 * tig + e] = a[:, 0, e]
        am[gid + 8, 2 * tig + e] = a[:, 1, e]
        am[gid, 2 * tig + 8 + e] = a[:, 2, e]
        am[gid + 8, 2 * tig + 8 + e] = a[:, 3, e]
        bm[2 * tig + e, gid] = b[:, 0, e]
        bm[2 * tig + 8 + e, gid] = b[:, 1, e]
    d = am @ bm
    return np.stack([d[gid, 2 * tig], d[gid, 2 * tig + 1],
                     d[gid + 8, 2 * tig], d[gid + 8, 2 * tig + 1]], -1)


def _bf16_pair(words):
    """uint32 words -> (low, high) bfloat16 halves as float64."""
    w = np.asarray(words, np.uint32)
    lo = (w << np.uint32(16)).view(np.float32).astype(np.float64)
    hi = (w & np.uint32(0xFFFF0000)).view(np.float32).astype(np.float64)
    return np.stack([lo, hi], -1)


def _regs_walk(x3, s3, t3, g):
    """The "regs" form's IIR block (``split_load`` and ``iir_mma_stage`` in
    ``csrc/chain_natural.cuh``) walked in float64 with the kernel's index
    arithmetic, g frames a block: A's three bf16 planes written as
    split_load writes them (everything else NaN, so that a read of an
    unwritten place shows), each warp's N tiles, M-tile groups and K steps
    (the triangular skip), its B fragments read from the host table
    (``_regs_fragments``) at the kernel's offsets, its A fragments by
    ldmatrix, nine products a step, and the C registers stored to y.
    Returns y (F, n1, n2) and the K steps read, against the dense count."""
    frames, n1, n2 = x3.shape
    d = s3.shape[1]
    kp = -(-(n2 + d) // 16) * 16
    lda = kp + 8
    rows = -(-g * n1 // 16) * 16
    ntiles, ksteps, mtiles = -(-n2 // 8), kp // 16, rows // 16
    hlast, phi0 = (n2 - 1) >> 4, n2 >> 4
    words = tcv._regs_fragments(t3)
    ax, as_ = (np.stack([p.numpy().astype(np.float64) for p in tcv._split3(v)])
               for v in (x3, s3))
    ax, as_ = ax.reshape(3, -1), as_.reshape(3, -1)
    y_all = np.full((frames, n1, n2), np.nan)
    steps = dense = 0
    for f0 in range(0, frames, g):
        nf = min(g, frames - f0)
        vr = nf * n1
        plane = rows * lda
        a3 = np.full(3 * plane, np.nan)
        pl = np.arange(3)[:, None] * plane
        i = np.arange(vr * n2)
        p = i // n2
        a3[pl + p * lda + i - p * n2] = ax[:, f0 * n1 * n2 + i]
        i = np.arange(nf * d * n1)
        q, r = i // (d * n1), i % (d * n1)
        a3[pl + (q * n1 + r % n1) * lda + n2 + r // n1] = \
            as_[:, f0 * d * n1 + i]
        pc = kp - n2 - d
        i = np.arange(vr * pc)
        p = i // pc
        a3[pl + p * lda + n2 + d + i - p * pc] = 0.0
        z = (rows - vr) * lda // 8
        for a in range(3):
            a3[a * plane + vr * lda: a * plane + vr * lda + 8 * z] = 0.0
        y = np.full((rows, 132), np.nan)
        nw = 8
        for warp in range(nw):
            j = 0
            while j * nw < ntiles:
                nt = (j + 1) * nw - 1 - warp if j & 1 else j * nw + warp
                j += 1
                if nt >= ntiles:
                    continue
                hend = min((8 * nt + 7) >> 4, hlast)
                ks_list = (list(range(hend + 1))
                           + list(range(max(hend + 1, phi0), ksteps)))
                for m0 in range(0, mtiles, 8):
                    acc = np.zeros((8, 32, 4))
                    for ks in ks_list:
                        base = (nt * ksteps + ks) * 192
                        lane = np.arange(32)
                        hm = words[base + 4 * lane[:, None] + np.arange(4)]
                        lo = words[base + 128 + 2 * lane[:, None]
                                   + np.arange(2)]
                        b = [_bf16_pair(hm[:, :2]), _bf16_pair(hm[:, 2:]),
                             _bf16_pair(lo)]
                        for i4 in range(8):
                            if m0 + i4 >= mtiles:
                                continue
                            steps += 1
                            a = [_ldmatrix_x4(a3[k * plane:(k + 1) * plane],
                                              lda, 16 * (m0 + i4), 16 * ks)
                                 for k in range(3)]
                            part = sum(_mma(a[ka], b[kb])
                                       for ka, kb in ((2, 2), (2, 1), (1, 2),
                                                      (1, 1), (2, 0), (0, 2),
                                                      (1, 0), (0, 1), (0, 0)))
                            acc[i4] += part
                    for i4 in range(8):
                        if m0 + i4 >= mtiles:
                            continue
                        dense += ksteps
                        gid, tig = np.arange(32) >> 2, np.arange(32) & 3
                        row = 16 * (m0 + i4) + gid
                        col = 8 * nt + 2 * tig
                        y[row, col] = acc[i4][:, 0]
                        y[row, col + 1] = acc[i4][:, 1]
                        y[row + 8, col] = acc[i4][:, 2]
                        y[row + 8, col + 1] = acc[i4][:, 3]
        y_all[f0:f0 + nf] = y[:vr, :n2].reshape(nf, n1, n2)
    return y_all, steps, dense


@pytest.mark.parametrize("n2", [100, 128])
@pytest.mark.parametrize("n1", [2, 6, 8, 32, 128])
def test_regs_walk_gives_the_split_iir_block(n1, n2, rng):
    """The "regs" kernel's IIR block walked on the CPU (:func:`_regs_walk`)
    at its own g over 2 g + 1 frames (the last block partial) gives the
    split product the plain version sums, ``_split_iir_block``: within 1e-12
    of the same parts' nine products summed in float64, and within float32
    rounding (2e-6 of the largest |y|) of the plain version's float32 sums;
    it reads no unwritten place (NaN), and skips H^T's zero K steps.  The
    split table's parts sum to the float64 table [H^T; Phi^T] within 2^-24
    of each entry."""
    from simpledsp_tpu_torch.models.northstar import default_design
    from simpledsp_tpu_torch.ops.iir import block_operators_f64

    H, Phi, *_ = block_operators_f64(default_design(), n2)
    d = Phi.shape[1]
    t3 = tcv.iir_split3(H.T, Phi.T)
    table = np.concatenate([H.T, Phi.T])
    assert np.all(np.abs(t3.sum(0) - table) <= 2.0 ** -24 * np.abs(table))
    g = tchain._natural_frames(n1, n2)
    frames = 2 * g + 1
    x3 = torch.as_tensor(rng.standard_normal((frames, n1, n2)),
                         dtype=torch.float32)
    s3 = torch.as_tensor(1e-5 * rng.standard_normal((frames, d, n1)),
                         dtype=torch.float32)
    y, steps, dense = _regs_walk(x3, s3, t3, g)
    assert not np.isnan(y).any()
    assert steps < 0.75 * dense
    parts = [p.double() for p in tcv._split_operands(x3, s3)]
    exact = sum(parts[a] @ torch.as_tensor(t3[b]) for a in range(3)
                for b in range(3)).numpy()
    scale = float(np.abs(exact).max())
    np.testing.assert_allclose(y, exact, rtol=0, atol=1e-12 * scale)
    plain = tcv._split_iir_block(x3, s3, torch.as_tensor(t3, dtype=torch.float32))
    np.testing.assert_allclose(y, plain.double().numpy(), rtol=0,
                               atol=2e-6 * scale)


def test_variant_wrappers_refuse_before_any_build():
    """The CUDA wrappers check their operands before they build or launch,
    and the dispatchers take only CPU or CUDA tensors."""
    _, tops = _ops(1024)
    x3 = torch.zeros(4, tops.n1, tops.n2, dtype=torch.float64)
    s3 = torch.zeros(4, tops.state_dim, tops.n1, dtype=torch.float64)
    tabs = tops.tables()
    kernels = (tcv.chain_regs_kernel, tcv.chain_grouped_kernel,
               tcv.chain_store_kernel)
    before = [k.launches for k in kernels]
    with pytest.raises(ValueError, match="float32"):
        tcv.chain_regs_kernel(x3, s3, tabs)
    with pytest.raises(ValueError, match="float32"):
        tcv.chain_grouped_kernel(x3, s3, tabs, 2)
    with pytest.raises(ValueError, match="fit a block"):
        tcv.chain_grouped_kernel(x3, s3, tabs, 64)
    with pytest.raises(ValueError, match="fit a block"):
        tcv.chain_grouped_kernel(x3, s3, tabs, 0)
    # Both read H^T by bands up to each band's last column only.
    x32, s32 = x3.float(), s3.float()
    tabs32 = tchain.ChainTables(*(t.float() for t in tabs))
    lower = tabs32._replace(HT=tabs32.HT.T.contiguous())
    with pytest.raises(ValueError, match="upper-triangular"):
        tcv.chain_grouped_kernel(x32, s32, lower, 2)
    with pytest.raises(ValueError, match="upper-triangular"):
        tcv.chain_store_kernel(x32, s32, lower, "fmajor")
    # The regs form reads T's split parts, skipping H^T's zero K steps.
    t3 = tabs32.T3.clone()
    t3[0, 5, 0] = 1.0
    with pytest.raises(ValueError, match="upper-triangular"):
        tcv.chain_regs_kernel(x32, s32, tabs32._replace(T3=t3))
    with pytest.raises(ValueError, match="expected"):
        tcv.chain_regs_kernel(x32, s32, tabs32._replace(T3=t3[:, 1:]))
    with pytest.raises(ValueError, match="float32"):
        tcv.chain_store_kernel(x3, s3, tabs, "wide")
    with pytest.raises(ValueError, match="launches"):
        tcv.chain_store_kernel(x3, s3, tabs, "natural")
    with pytest.raises(ValueError, match="unknown store"):
        tcv.chain_frames_store(x3, s3, tabs, "narrow")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tcv.chain_frames_grouped(x3.to("meta"), s3.to("meta"), tabs, 2)
    assert [k.launches for k in kernels] == before


def test_fmajor_plain_rows_are_the_k1_major_spectrum(rng):
    _, tops = _ops(1024)
    x = torch.as_tensor(rng.standard_normal((1, 3 * 1024)))
    x3, s3, _ = tchain.chain_prepass(tops, x, torch.zeros(1, tops.state_dim,
                                                          dtype=x.dtype))
    fr, fi = tcv.chain_frames_store(x3, s3, tops.tables(), "fmajor")
    rr, ri = tchain.chain_frames_reference(x3, s3, tops.tables())
    assert fr.shape == (3, tops.n1, tops.n2 // 2)
    # Row k1, column k2 holds bin k1 + n1 k2.
    assert torch.equal(fr.transpose(1, 2).reshape(3, -1), rr)
    assert torch.equal(fi.transpose(1, 2).reshape(3, -1), ri)


def test_chain_forms_tool_needs_a_card():
    """``tools/chain_forms.py`` times the card and raises without one."""
    from simpledsp_tpu_torch.tools import chain_forms

    assert set(chain_forms.LAYOUTS) == set(tchain.LAYOUTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chain_forms.run(sizes=(200,))


def test_chain_stages_tool_has_its_hook_and_needs_a_card():
    """``tools/chain_stages.py`` cuts the chain kernel through the
    ``SDSP_CHAIN_CUT_AT`` hook of ``csrc/chain_natural.cuh`` (after the
    loads, 1, and after the IIR block, 2, in both IIR forms) and raises
    without a card."""
    from simpledsp_tpu_torch.kernels import _build
    from simpledsp_tpu_torch.tools import chain_stages

    text = (_build.CSRC_DIR / "chain_natural.cuh").read_text()
    assert "defined(SDSP_CHAIN_CUT_AT)" in text
    assert text.count("SDSP_CHAIN_SINK(1, smem);") == 2
    assert text.count("SDSP_CHAIN_SINK(2, ys);") == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chain_stages.run(sizes=(200,))
