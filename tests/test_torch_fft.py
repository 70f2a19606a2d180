"""The PyTorch port's FFT (simpledsp_tpu_torch.ops.fft, kernels.fft host
tables) against the JAX package and numpy, in float64 on the CPU.

Tolerance: 1e-12 relative to the largest output magnitude (float64 rounding
of four-step sums; outputs of random normal input grow as sqrt(N)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledsp_tpu.kernels import fft as jkfft
from simpledsp_tpu.ops import fft as jfft
from simpledsp_tpu_torch.kernels import fft as tkfft
from simpledsp_tpu_torch.ops import fft as tfft

SIZES = [8, 256, 4096, 16384]
TOL = 1e-12


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", SIZES)
def test_fft_ri_ifft_ri(n, rng):
    xr, xi = rng.standard_normal((2, 3, n))
    yr, yi = tfft.fft_ri(_t(xr), _t(xi))
    jr, ji = jfft.fft_ri(jnp.asarray(xr), jnp.asarray(xi))
    ref = np.fft.fft(xr + 1j * xi)
    for got, want in ((yr, jr), (yi, ji), (yr, ref.real), (yi, ref.imag)):
        _close(got.numpy(), want)
    br, bi = tfft.ifft_ri(yr, yi)
    jr, ji = jfft.ifft_ri(jnp.asarray(yr.numpy()), jnp.asarray(yi.numpy()))
    for got, want in ((br, jr), (bi, ji), (br, xr), (bi, xi)):
        _close(got.numpy(), want)


@pytest.mark.parametrize("n", SIZES + [6, 9])
def test_rfft_ri_irfft_ri(n, rng):
    x = rng.standard_normal((3, n))
    yr, yi = tfft.rfft_ri(_t(x))
    jr, ji = jfft.rfft_ri(jnp.asarray(x))
    ref = np.fft.rfft(x)
    for got, want in ((yr, jr), (yi, ji), (yr, ref.real), (yi, ref.imag)):
        _close(got.numpy(), want)
    back = tfft.irfft_ri(yr, yi, n)
    _close(back.numpy(), jfft.irfft_ri(jr, ji, n))
    _close(back.numpy(), x)


@pytest.mark.parametrize("n", SIZES)
def test_pack_unpack_rfft_ri(n, rng):
    x = rng.standard_normal((2, n))
    yr, yi = tfft.rfft_ri(_t(x))
    pr, pi = tfft.pack_rfft_ri(yr, yi)
    jpr, jpi = jfft.pack_rfft_ri(*jfft.rfft_ri(jnp.asarray(x)))
    _close(pr.numpy(), jpr)
    _close(pi.numpy(), jpi)
    assert pr.shape == (2, n // 2)
    ur, ui = tfft.unpack_rfft_ri(pr, pi)
    ref = np.fft.rfft(x)
    _close(ur.numpy(), ref.real)
    _close(ui.numpy(), ref.imag)


@pytest.mark.parametrize("n", [16, 64, 256, 1024])
def test_radix_entries_match_numpy(n, rng):
    """The JAX signature: one complex tensor in, one complex tensor out."""
    x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    ref = np.fft.fft(x)
    y = tfft.fft_radix2(_t(x))
    assert y.dtype == torch.complex128
    _close(y.numpy(), ref)
    _close(tfft.fft_radix2(y, inverse=True).numpy(), x)
    _close(tfft.fft_radix4(_t(x)).numpy(), ref)   # every n here is 4^k
    assert tfft.fft_radix4(_t(x), dtype=torch.float32).dtype == torch.complex64


@pytest.mark.parametrize("entry,n", [("fft_radix2", 12), ("fft_radix2", 96),
                                     ("fft_radix4", 8), ("fft_radix4", 32),
                                     ("fft_radix4", 48)])
def test_radix_gates_raise_as_in_jax(entry, n):
    with pytest.raises(ValueError, match=entry):
        getattr(jfft, entry)(jnp.zeros(n, jnp.complex128))
    with pytest.raises(ValueError, match=entry):
        getattr(tfft, entry)(torch.zeros(n, dtype=torch.complex128))


@pytest.mark.parametrize("entry,n", [("fft_radix2", 1024),
                                     ("fft_radix4", 4096)])
def test_radix_entries_match_jax_entries(entry, n, rng):
    """``tests/test_fft.py``'s radix cases, against the JAX entries: the
    forward and inverse transforms, and the gates at 512 and 1000."""
    x = rng.standard_normal(n) + 0j
    ours, theirs = getattr(tfft, entry), getattr(jfft, entry)
    _close(ours(_t(x)).numpy(), theirs(jnp.asarray(x)))
    _close(ours(_t(x), inverse=True).numpy(),
           theirs(jnp.asarray(x), inverse=True))
    bad = 512 if entry == "fft_radix4" else 1000
    with pytest.raises(ValueError, match=entry):
        ours(_t(x[:bad]))


@pytest.mark.parametrize("n", [8, 64, 100, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_get_the_same_bits_in_any_batch(n, dtype, rng):
    """A row's transform does not depend on the rows beside it: slices of 1,
    3 and 7 rows, at several offsets, give the bits those rows have inside
    a batch of 60 (streaming callers such as ``OverlapSaveFIR`` rely on
    it)."""
    xr, xi = (torch.as_tensor(a, dtype=dtype)
              for a in rng.standard_normal((2, 60, n)))
    for entry in (tfft.fft_ri, tfft.ifft_ri):
        whole = entry(xr, xi)
        for lo, count in ((0, 1), (0, 7), (5, 3), (29, 7), (59, 1), (53, 7)):
            part = entry(xr[lo: lo + count], xi[lo: lo + count])
            for p, w in zip(part, whole):
                assert torch.equal(p, w[lo: lo + count]), (entry, lo, count)


def _snr_db(ref, got) -> float:
    err = np.asarray(got, np.complex128) - ref
    return float(10 * np.log10((np.abs(ref) ** 2).sum()
                               / (np.abs(err) ** 2).sum()))


# The float32 accuracy cases hold the port to the JAX engine on the same
# input, within this many dB (the small-DFT route once summed [xr | xi]
# against stacked (2n, n) tables and lost 2.2-2.9 dB at every size below).
JAX_SNR_SLACK_DB = 0.3


@pytest.mark.parametrize("n", [64, 128, 4096, 32768])
@pytest.mark.parametrize("entry", ["fft_ri", "rfft_ri"])
def test_float32_transform_keeps_the_jax_engines_accuracy(entry, n):
    """float32 on the CPU, 2^20 values of noise (seed 0): the SNR against
    numpy in float64 is at least the JAX engine's on the same input, less
    0.3 dB.  Each output of a small DFT (n <= 128: the sizes themselves,
    and step 1 of the larger ones) is a difference of n-term sums, as in
    the JAX engine.  ``-s`` prints both SNRs."""
    xr, xi = np.random.default_rng(0).standard_normal(
        (2, (1 << 20) // n, n)).astype(np.float32)
    if entry == "fft_ri":
        ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        ours = tfft.fft_ri(_t(xr), _t(xi))
        theirs = jfft.fft_ri(jnp.asarray(xr), jnp.asarray(xi))
    else:
        ref = np.fft.rfft(xr.astype(np.float64))
        ours = tfft.rfft_ri(_t(xr))
        theirs = jfft.rfft_ri(jnp.asarray(xr))
    mine = _snr_db(ref, ours[0].numpy() + 1j * ours[1].numpy())
    jax_db = _snr_db(ref, np.asarray(theirs[0]) + 1j * np.asarray(theirs[1]))
    print(f"{entry} n = {n}: port {mine:.2f} dB, JAX {jax_db:.2f} dB")
    assert mine >= jax_db - JAX_SNR_SLACK_DB, (mine, jax_db)


@pytest.mark.parametrize("fft_size", [4096, 32768])
def test_float32_plain_chain_keeps_the_jax_chains_accuracy(fft_size):
    """The plain ``NorthStarChain`` in float32 on 2 x 2^18 samples of noise
    (seed 0): its spectra's SNR against the float64 oracle (scipy
    ``sosfilt`` + numpy ``rfft``, packed) is at least the JAX composable
    chain's on the same input, less 0.3 dB."""
    import scipy.signal as sig

    from simpledsp_tpu.models.northstar import NorthStarChain as JChain
    from simpledsp_tpu_torch.design.biquad import sos_matrix
    from simpledsp_tpu_torch.models.northstar import NorthStarChain

    x = np.random.default_rng(0).standard_normal((2, 1 << 18)).astype(
        np.float32)
    chain = NorthStarChain(fft_size=fft_size, device="cpu")
    (sr, si), _ = chain(torch.as_tensor(x))
    (jr, ji), _ = JChain(fft_size=fft_size, dtype=jnp.float32)(jnp.asarray(x))
    y64 = sig.sosfilt(sos_matrix(chain.design), x.astype(np.float64), axis=-1)
    full = np.fft.rfft(y64.reshape(2, -1, fft_size))
    ref = full[..., : fft_size // 2].copy()
    ref[..., 0] += 1j * full[..., fft_size // 2].real
    mine = _snr_db(ref, sr.numpy() + 1j * si.numpy())
    jax_db = _snr_db(ref, np.asarray(jr) + 1j * np.asarray(ji))
    print(f"plain chain N = {fft_size}: port {mine:.2f} dB, JAX "
          f"{jax_db:.2f} dB")
    assert mine >= jax_db - JAX_SNR_SLACK_DB, (mine, jax_db)


@pytest.mark.parametrize("n,factor", [(257, 257), (262, 131), (524, 131),
                                      (1031, 1031), (4099, 4099)])
def test_prime_factor_above_128_not_ported(n, factor, rng):
    """Sizes with a prime factor above 128 (``factor``) run Bluestein's
    chirp-z (``ops/transforms.czt_ri``), as in the JAX package: forward
    and inverse against JAX and numpy."""
    assert n % factor == 0 and tkfft._best_split(factor) is None
    xr, xi = rng.standard_normal((2, 2, n))
    yr, yi = tfft.fft_ri(_t(xr), _t(xi))
    jr, ji = jfft.fft_ri(jnp.asarray(xr), jnp.asarray(xi))
    ref = np.fft.fft(xr + 1j * xi)
    for got, want in ((yr, jr), (yi, ji), (yr, ref.real), (yi, ref.imag)):
        _close(got.numpy(), want)
    br, bi = tfft.ifft_ri(yr, yi)
    _close(br.numpy() + 1j * bi.numpy(), xr + 1j * xi)


# -- the frames FFT (kernels/fft.py): plain version against the JAX kernel in
# interpret mode, at tests/test_kernels.py's sizes plus 100 and 384, float64,
# atol n 1e-13 as that file holds the JAX kernel to numpy.

FRAME_SIZES = [64, 100, 256, 384, 1024, 4096]


@pytest.mark.parametrize("n", FRAME_SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_frames_ri_matches_jax_kernel(n, inverse, rng):
    xr, xi = rng.standard_normal((2, 5, n))
    yr, yi = tkfft.fft_frames_ri(_t(xr), _t(xi), inverse=inverse)
    jr, ji = jkfft.fft_frames_ri(jnp.asarray(xr), jnp.asarray(xi),
                                 inverse=inverse, interpret=True)
    ref = (np.fft.ifft if inverse else np.fft.fft)(xr + 1j * xi)
    for got, want in ((yr, jr), (yi, ji), (yr, ref.real), (yi, ref.imag)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=n * 1e-13)


@pytest.mark.parametrize("n", FRAME_SIZES)
def test_rfft_frames_matches_jax_kernel(n, rng):
    x = rng.standard_normal((2, 5, n))
    yr, yi = tkfft.rfft_frames(_t(x))
    jr, ji = jkfft.rfft_frames(jnp.asarray(x), interpret=True)
    ref = np.fft.fft(x)
    assert yr.shape == x.shape
    for got, want in ((yr, jr), (yi, ji), (yr, ref.real), (yi, ref.imag)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=n * 1e-13)


@pytest.mark.parametrize("n", [64, 384, 4096])
def test_fft_frames_unscaled_and_strided(n, rng):
    """``scale=False`` leaves the inverse unscaled; the even/odd strided
    views rfft_ri hands the engine give the same bins as copies."""
    x = rng.standard_normal((3, 2 * n))
    xt = _t(x)
    yr, yi = tkfft._fft_frames(xt[:, 0::2], xt[:, 1::2], inverse=True,
                               scale=False)
    ref = np.fft.ifft(x[:, 0::2] + 1j * x[:, 1::2]) * n
    np.testing.assert_allclose(yr.numpy(), ref.real, rtol=0, atol=n * 1e-13)
    np.testing.assert_allclose(yi.numpy(), ref.imag, rtol=0, atol=n * 1e-13)


def test_fft_frames_rejects_what_it_cannot_run():
    z = torch.zeros(2, 131, dtype=torch.float64)
    with pytest.raises(ValueError, match="131"):
        tkfft._fft_frames(z, z, inverse=False)
    z = torch.zeros(2, 64, dtype=torch.float64)
    with pytest.raises(ValueError, match="HIGHEST"):
        tkfft.fft_frames_ri(z, z, precision="default")
    with pytest.raises(ValueError, match="frames_per_tile"):
        tkfft.rfft_frames(z, frames_per_tile=0)
    with pytest.raises(ValueError, match=r"\(F, N\)"):
        tkfft._fft_frames(z[None], None, inverse=False)


def _swz(p, mask=31):
    """The core's buffer index (``swz`` in ``csrc/fft_core.cuh``)."""
    r = p >> 5
    return p ^ (((r & 15) | ((r & 8) << 1)) & mask)


_W16 = np.exp(-2j * np.pi * np.arange(16) / 16)


def _reg_dft(v, r):
    """The core's r-point DFT over axis 0 in its register order: radix 2
    and 4 direct, 8 = 2 x 4 and 16 = 4 x 4 (t = B t1 + t2, k = k1 + A k2,
    twiddle exp(-2 pi i t2 k1 / r) between)."""
    if r in (2, 4):
        return np.fft.fft(v, axis=0)
    a, b = {8: (2, 4), 16: (4, 4)}[r]
    u = np.stack([_reg_dft(v[t2::b], a) for t2 in range(b)])  # [t2][k1]
    out = np.empty_like(v)
    for k1 in range(a):
        w = np.stack([u[t2, k1] * _W16[(t2 * k1 * (16 // r)) % 16]
                      for t2 in range(b)])
        out[k1::a] = _reg_dft(w, b)
    return out


def _core_walk(x, n, radices=None):
    """x (..., n) complex through ``csrc/fft_core.cuh``'s passes, walked in
    float64 in the kernel's order: each pass reads its butterflies from the
    swizzled buffer, twiddles them from the host table, runs the r-point
    DFT and writes the Stockham places back through the swizzle.  The plan
    is ``radices`` (default ``kernels/fft._plan``), the table built for it."""
    radices = tkfft._plan(n) if radices is None else radices
    tab = tkfft._kernel_table_f64(n, radices)
    tab = tab[:, 0] + 1j * tab[:, 1]
    mask = 31 if n & (n - 1) == 0 else 0      # swz_mask
    buf = np.zeros(x.shape[:-1] + (-(-n // 32) * 32,), dtype=complex)
    buf[..., _swz(np.arange(n), mask)] = x
    ns, off = 1, 0
    assert int(np.prod(radices)) == n
    for r in radices:
        tw = tab[off: off + (r - 1) * ns]
        off += (r - 1) * ns
        q = n // r
        j = np.arange(q)
        k = j % ns
        v = np.stack([buf[..., _swz(j + t * q, mask)] for t in range(r)])
        for t in range(1, r):
            v[t] = v[t] * tw[(t - 1) * ns + k]
        if r % 2:
            # Output m: x_0 and the pairs t, r - t against one table entry,
            # w = W[(t m) mod r] and its conjugate.
            w = tab[off: off + r]
            off += r
            d = np.empty_like(v)
            for m in range(r):
                d[m] = v[0]
                for t in range(1, r // 2 + 1):
                    wt = w[t * m % r]
                    d[m] += v[t] * wt + v[r - t] * np.conj(wt)
        else:
            assert r in (2, 4, 8, 16)
            d = _reg_dft(v, r)
        for m in range(r):
            buf[..., _swz((j - k) * r + k + m * ns, mask)] = d[m]
        ns *= r
    assert off == len(tab)
    return buf[..., _swz(np.arange(n), mask)]


@pytest.mark.parametrize("n", [1, 2, 3, 6, 64, 100, 127, 384, 1152, 4096,
                               16256, 16384])
def test_kernel_plan_and_table_compute_the_dft(n, rng):
    """``csrc/fft_core.cuh``'s pass plan and twiddle / small-DFT table,
    walked in numpy in the core's register / exchange order, give numpy's
    DFT."""
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    _close(_core_walk(x, n), np.fft.fft(x))


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192, 16384])
def test_core_exchanges_have_no_bank_conflict(n):
    """Every shared-memory access of the frames kernel at a power-of-two n
    (the passes' reads after the first, which reads device memory, and
    their writes before the last, which writes it) touches 32 distinct banks
    a warp, through the swizzle."""
    fpb = 1 if n >= 4096 else 4096 // n
    total = fpb * n
    nt = -(-total // 16 // 32) * 32
    tid = np.arange(nt)
    plan = tkfft._plan(n)
    accesses = []
    ns = 1
    for p, r in enumerate(plan):
        q = n // r
        for b in range(16 // r):
            w = tid + b * nt
            f, j = w // q, w % q
            k = j % ns
            live = w < total // r
            if p > 0:
                accesses += [np.where(live, f * n + j + t * q, -1)
                             for t in range(r)]
            if p < len(plan) - 1:
                accesses += [np.where(live, f * n + (j - k) * r + k + m * ns,
                                      -1) for m in range(r)]
        ns *= r
    assert accesses
    for idx in accesses:
        for w0 in range(0, nt, 32):
            p = idx[w0: w0 + 32]
            p = p[p >= 0]
            banks = _swz(p) % 32
            assert len(set(banks.tolist())) == len(p), (n, p)


@pytest.mark.parametrize("n", [200, 256, 512, 768, 1024, 1152, 2048, 4096,
                               16384])
def test_chain_fft_tables_give_the_packed_spectrum(n, rng):
    """The chain kernel's half spectrum walked in numpy in float64: the FFT
    core's plan and table for N/2 on z[t] = y[2t] + i y[2t+1] of the frames
    ``_iir_block`` filters, then the split with ``_split_table_f64``, in the
    kernel's pairing of bins k and N/2 - k, give ``chain_frames_reference``
    (1e-12 of the largest bin)."""
    from simpledsp_tpu_torch.kernels import chain as tchain
    from simpledsp_tpu_torch.models.northstar import default_design

    ops = tchain.FusedNorthStarOperators(default_design(), n,
                                         dtype=torch.float64, device="cpu")
    x = _t(rng.standard_normal((2, 3 * n)))
    s0 = _t(rng.standard_normal((2, ops.state_dim)))
    x3, s3, _ = tchain.chain_prepass(ops, x, s0)
    tables = ops.tables()
    y = tchain._iir_block(x3, s3, tables).reshape(x3.shape[0], n).numpy()
    m = n // 2
    z = _core_walk(y[:, 0::2] + 1j * y[:, 1::2], m)
    sp = tkfft._split_table_f64(n)
    re, im = np.empty((len(y), m)), np.empty((len(y), m))
    re[:, 0] = z[:, 0].real + z[:, 0].imag
    im[:, 0] = z[:, 0].real - z[:, 0].imag
    for k in range(1, m // 2 + 1):
        a, b = z[:, k], z[:, m - k]
        wr, wi = sp[k]
        er, ei = 0.5 * (a.real + b.real), 0.5 * (a.imag - b.imag)
        dr, di = 0.5 * (a.real - b.real), 0.5 * (a.imag + b.imag)
        u, v = wr * di + wi * dr, wi * di - wr * dr
        re[:, k], im[:, k] = er + u, ei + v
        if 2 * k < m:
            re[:, m - k], im[:, m - k] = er - u, v - ei
    want_re, want_im = tchain.chain_frames_reference(x3, s3, tables)
    scale = float(max(want_re.abs().max(), want_im.abs().max()))
    np.testing.assert_allclose(re, want_re.numpy(), rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(im, want_im.numpy(), rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("n", [128, 256, 384, 4096, 16384, 16512, 32768])
def test_dispatch_gate(n):
    """The kernel gate is the JAX package's size gate (n = 128 m,
    2 <= m <= 128), float32 and a CUDA tensor: no CPU or float64 tensor
    is admitted."""
    for dtype in (torch.float32, torch.float64):
        assert not tfft._use_fused_kernel(n, torch.zeros(1, dtype=dtype))
    meta = torch.empty(1, dtype=torch.float32, device="meta")
    assert not tfft._use_fused_kernel(n, meta)


@pytest.mark.parametrize("n", [256, 4096, 32768])
def test_cpu_float32_never_reaches_the_kernel(n, rng, monkeypatch):
    """CPU tensors take the plain four-step, never the wrapper's CUDA
    branch, also at the sizes the kernel takes on the card."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA frames kernel was called")
    monkeypatch.setattr(tkfft, "fft_frames_kernel", refuse)
    x = rng.standard_normal((2, n)).astype(np.float32)
    yr, yi = tfft.fft_ri(_t(x), torch.zeros(2, n))
    ref = np.fft.fft(x.astype(np.float64))
    scale = np.abs(ref).max()
    assert np.abs(yr.numpy() + 1j * yi.numpy() - ref).max() < 1e-5 * scale


@pytest.mark.parametrize("n", [8, 9, 128, 1000, 1024, 4096, 16384, 32768])
def test_best_split_and_consts_match_jax(n):
    assert tkfft._best_split(n) == jkfft._best_split(n)
    assert tkfft.fft_split_supported(n) == jkfft.pallas_fft_supported(n)
    if tkfft._best_split(n) is None:
        return
    for inverse in (False, True):
        got = tkfft._consts(n, inverse, "float32")
        want = jkfft._consts(n, inverse, "float32")
        assert got[:2] == want[:2]
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(a, b)


def test_dft_matrix_and_twiddles_bitwise():
    for n in (8, 128):
        for inverse in (False, True):
            for a, b in zip(tfft.dft_matrix(n, inverse), jfft.dft_matrix(n, inverse)):
                np.testing.assert_array_equal(a, b)
    for a, b in zip(tfft._twiddle_f64(32, 128), jfft._twiddle_f64(32, 128)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tfft._half_twiddle_f64(4096), jfft._half_twiddle_f64(4096)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [8, 9, 256, 4096])
def test_complex_wrappers_match_jax_and_numpy(n, rng):
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    xt = torch.as_tensor(x)
    for name, ref in (("fft", np.fft.fft(x)), ("ifft", np.fft.ifft(x))):
        got = getattr(tfft, name)(xt)
        assert got.dtype == torch.complex128
        _close(got.numpy(), getattr(jfft, name)(jnp.asarray(x)))
        _close(got.numpy(), ref)
    r = x.real
    got = tfft.rfft(torch.as_tensor(r))
    _close(got.numpy(), jfft.rfft(jnp.asarray(r)))
    _close(got.numpy(), np.fft.rfft(r))
    back = tfft.irfft(got, n)
    _close(back.numpy(), jfft.irfft(jnp.asarray(got.numpy()), n))
    _close(back.numpy(), r)


def test_complex_wrappers_working_dtype(rng):
    x = rng.standard_normal((2, 64)).astype(np.float32)
    assert tfft.fft(torch.as_tensor(x)).dtype == torch.complex64
    assert tfft.rfft(torch.as_tensor(x)).dtype == torch.complex64
    assert tfft.fft(torch.as_tensor(x), dtype=torch.float64).dtype == \
        torch.complex128
    assert tfft.fft2(torch.as_tensor(x)).dtype == torch.complex64


@pytest.mark.parametrize("shape", [(8, 16), (3, 12, 20), (2, 31, 17),
                                   (2, 128, 256)])
def test_fft2_ifft2_match_jax_and_numpy(shape, rng):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    got = tfft.fft2(torch.as_tensor(x))
    _close(got.numpy(), jfft.fft2(jnp.asarray(x)))
    _close(got.numpy(), np.fft.fft2(x))
    inv = tfft.ifft2(got)
    _close(inv.numpy(), jfft.ifft2(jnp.asarray(got.numpy())))
    _close(inv.numpy(), x)
    yr, yi = tfft.fft2_ri(torch.as_tensor(x.real), torch.as_tensor(x.imag))
    _close(yr.numpy(), got.real.numpy())
    _close(yi.numpy(), got.imag.numpy())
    br, bi = tfft.ifft2_ri(yr, yi)
    jr, ji = jfft.ifft2_ri(jnp.asarray(yr.numpy()), jnp.asarray(yi.numpy()))
    _close(br.numpy(), jr)
    _close(bi.numpy(), ji)


@pytest.mark.parametrize("shape", [(8, 16), (5, 12, 21), (2, 9, 32),
                                   (2, 640, 640)])
def test_rfft2_ri_irfft2_ri_match_jax_and_numpy(shape, rng):
    x = rng.standard_normal(shape)
    yr, yi = tfft.rfft2_ri(torch.as_tensor(x))
    jr, ji = jfft.rfft2_ri(jnp.asarray(x))
    ref = np.fft.rfft2(x)
    for got, want in ((yr, jr), (yi, ji), (yr, ref.real), (yi, ref.imag)):
        _close(got.numpy(), want)
    back = tfft.irfft2_ri(yr, yi, shape[-1])
    _close(back.numpy(), jfft.irfft2_ri(jr, ji, shape[-1]))
    _close(back.numpy(), x)
