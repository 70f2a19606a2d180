"""The port's full-spectrum fused chain (``fused_chain_frames`` with its
default ``half_spectrum=False``) against the JAX package's in Pallas
interpret mode and against scipy ``sosfilt`` + numpy ``fft``, in float64 on
the CPU, where the port runs the full-spectrum kernel's plain version
(``chain_frames_full_reference``).

Tolerances: the two packages and the oracle agree to 1e-11 of the largest
bin (float64 sums over up to N terms in different orders; measured about
4e-16 relative); dense and two-step projections and streaming halves to
1e-12 of it, as the JAX package's own tests hold them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu.design.biquad import sos_matrix
from simpledsp_tpu.kernels import chain as jchain
from simpledsp_tpu.models.northstar import default_design as j_default_design
from simpledsp_tpu_torch.convert import design_from_numpy
from simpledsp_tpu_torch.kernels import chain as tchain

REL = 1e-11


def _ops(n):
    jd = j_default_design()
    td = design_from_numpy(jd.b, jd.a, jd.gain, jd.ftype, jd.f0, jd.fs, jd.q)
    return (jchain.FusedNorthStarOperators(jd, n, dtype=jnp.float64),
            tchain.FusedNorthStarOperators(td, n, dtype=torch.float64,
                                           device="cpu"))


def _input(rng, n, c=2, frames=3, state_scale=0.1):
    x = rng.standard_normal((c, frames * n))
    s0 = state_scale * rng.standard_normal((c, 10))
    return x, s0


def _port(tops, x, s0, **kw):
    (yr, yi), s = tchain.fused_chain_frames(tops, torch.as_tensor(x),
                                            torch.as_tensor(s0), **kw)
    return yr.numpy(), yi.numpy(), s.numpy()


def _close(got, want, scale, rel=REL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * scale


@pytest.mark.parametrize("n", [1024, 4096, 1000])
def test_default_call_matches_jax_default_call(n, rng):
    """The same call with defaults gives the same result in both packages:
    the full spectrum as (C, F, n2, n1) planes (1000 = 8 x 125, odd n2)."""
    jops, tops = _ops(n)
    x, s0 = _input(rng, n)
    (jr, ji), js = jchain.fused_chain_frames(jops, jnp.asarray(x),
                                             jnp.asarray(s0), interpret=True)
    yr, yi, s = _port(tops, x, s0)
    assert yr.shape == yi.shape == jr.shape == (2, 3, tops.n2, tops.n1)
    scale = float(np.abs(np.asarray(jr)).max())
    _close(yr, np.asarray(jr), scale)
    _close(yi, np.asarray(ji), scale)
    _close(s, np.asarray(js), float(np.abs(np.asarray(js)).max()))


@pytest.mark.parametrize("n", [1024, 4096, 1000])
def test_full_spectrum_matches_scipy_oracle(n, rng):
    jops, tops = _ops(n)
    x = rng.standard_normal((2, 2 * n))
    yr, yi, _ = _port(tops, x, np.zeros((2, tops.state_dim)))
    got = (yr + 1j * yi).reshape(2, -1, n)    # natural bin order
    y = sig.sosfilt(sos_matrix(jops.design), x, axis=-1)
    ref = np.fft.fft(y.reshape(2, -1, n))
    _close(got, ref, float(np.abs(ref).max()))


def test_dense_projection_matches_two_step(rng):
    _, tops = _ops(1024)
    x, s0 = _input(rng, 1024, c=3, frames=8)
    a = _port(tops, x, s0, projection="dense")
    b = _port(tops, x, s0, projection="two_step")
    scale = float(np.abs(a[0]).max())
    for u, v in zip(a, b):
        _close(u, v, scale, 1e-12)


def test_streaming_state_handoff(rng):
    """Two calls with the state handed over equal one call over both."""
    _, tops = _ops(4096)
    x = rng.standard_normal((1, 4 * 4096))
    s0 = np.zeros((1, tops.state_dim))
    ar, ai, s_all = _port(tops, x, s0)
    br, bi, s_mid = _port(tops, x[:, :8192], s0)
    cr, ci, s_end = _port(tops, x[:, 8192:], s_mid)
    scale = float(np.abs(ar).max())
    _close(np.concatenate([br, cr], axis=1), ar, scale, 1e-12)
    _close(np.concatenate([bi, ci], axis=1), ai, scale, 1e-12)
    _close(s_end, s_all, float(np.abs(s_all).max()), 1e-12)


def test_pre_framed_input_gives_the_same_spectra(rng):
    _, tops = _ops(1000)
    x, s0 = _input(rng, 1000)
    flat = _port(tops, x, s0)
    framed = _port(tops, x.reshape(2, 3, tops.n1, tops.n2), s0)
    for a, b in zip(flat, framed):
        np.testing.assert_array_equal(a, b)


def test_full_table_is_the_jax_step3(rng):
    """FT stacks the JAX full kernel's step-3 tables: Re X = tr W2c^T -
    ti W2s^T, Im X = tr W2s^T + ti W2c^T."""
    jops, tops = _ops(1000)
    _, _, _, _, w2c, w2s, _, _ = jchain._consts(1000, False, "float64")
    np.testing.assert_array_equal(
        tops.FT.numpy(), np.concatenate([w2c.T, -w2s.T, w2s.T, w2c.T]))
    assert tops.tables(full=True).PQT is tops.FT
    assert tops.tables().PQT is tops.PQT


@pytest.mark.parametrize("n", [200, 1000, 16384])
def test_full_plain_version_is_the_dft_of_the_filtered_frames(n, rng):
    """chain_frames_full_reference on the prepass output: the DFT of each
    frame of the filtered signal, bins in natural order."""
    jops, tops = _ops(n)
    x = rng.standard_normal((1, 2 * n))
    x3, s3, _ = tchain.chain_prepass(tops, torch.as_tensor(x),
                                     torch.zeros(1, tops.state_dim,
                                                 dtype=torch.float64))
    yr, yi = tchain.chain_frames_full_reference(x3, s3, tops.tables(full=True))
    assert yr.shape == (2, n)
    y = sig.sosfilt(sos_matrix(jops.design), x, axis=-1)
    ref = np.fft.fft(y.reshape(-1, n))
    _close(yr.numpy() + 1j * yi.numpy(), ref, float(np.abs(ref).max()))


def test_half_spectrum_needs_even_n2_in_both_packages(rng):
    jops, tops = _ops(1000)
    x, s0 = _input(rng, 1000)
    with pytest.raises(ValueError, match="even n2"):
        jchain.fused_chain_frames(jops, jnp.asarray(x), jnp.asarray(s0),
                                  half_spectrum=True, interpret=True)
    with pytest.raises(ValueError, match="even n2"):
        _port(tops, x, s0, half_spectrum=True)


def test_full_kernel_wrapper_refuses_before_any_build():
    """The CUDA wrapper checks the operands the kernel reads before it
    builds or launches: float64, and a Phi^T of the wrong shape."""
    _, tops = _ops(1000)
    x3 = torch.zeros(2, tops.n1, tops.n2, dtype=torch.float64)
    s3 = torch.zeros(2, tops.state_dim, tops.n1, dtype=torch.float64)
    launches = tchain.chain_full_kernel.launches
    with pytest.raises(ValueError, match="float32"):
        tchain.chain_full_kernel(x3, s3, tops.tables(full=True))
    tabs32 = tchain.ChainTables(*(t.float() for t in tops.tables(full=True)))
    with pytest.raises(ValueError, match="expected a contiguous"):
        tchain.chain_full_kernel(x3.float(), s3.float(),
                                 tabs32._replace(PhiT=tabs32.PhiT[1:]))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tchain.chain_frames_full(x3.to("meta"), s3.to("meta"),
                                 tops.tables(full=True))
    assert tchain.chain_full_kernel.launches == launches


def _read_frame(y, n2, t, pairs):
    """The kernel's frame readers on y (F, n1, n2) as rows: z[t] from
    y[2t], y[2t+1] with their own rows (pairs), or as the one pair of one
    row (n2 even)."""
    e = 2 * t
    if pairs:
        return (y[:, e // n2, e % n2] + 1j * y[:, (e + 1) // n2, (e + 1) % n2])
    assert n2 % 2 == 0
    row = e // n2
    return y[:, row, e - row * n2] + 1j * y[:, row, e - row * n2 + 1]


@pytest.mark.parametrize("n", [200, 375, 1000, 1024, 4096, 8181, 16129])
def test_full_kernel_walk_gives_the_plain_version(n, rng):
    """The full-spectrum kernel walked in numpy in float64: for an even N the
    N/2-point FFT core (plan and table) on z read by the frame reader (the
    pair reader at odd n2: 1000 = 8 x 125), the split, and the conjugate
    mirror X[N - k] = conj X[k] stored in natural order; for an odd N (375 =
    3 x 125, 8181 = 81 x 101, and 16129 = 127 x 127, the largest there is)
    the N-point core on (y, 0).  They give ``chain_frames_full_reference``
    to 1e-12 of the largest bin."""
    from test_torch_fft import _core_walk

    from simpledsp_tpu_torch.kernels import fft as tkfft

    _, tops = _ops(n)
    x = torch.as_tensor(rng.standard_normal((1, 2 * n)))
    s0 = torch.as_tensor(rng.standard_normal((1, tops.state_dim)))
    x3, s3, _ = tchain.chain_prepass(tops, x, s0)
    tables = tops.tables(full=True)
    y = tchain._iir_block(x3, s3, tables).numpy()
    f, n1, n2 = y.shape
    if n % 2:
        spec = _core_walk(y.reshape(f, n) + 0j, n)
    else:
        m = n // 2
        z = _core_walk(np.stack([_read_frame(y, n2, t, n2 % 2 == 1)
                                 for t in range(m)], -1), m)
        sp = tkfft._split_table_f64(n)
        spec = np.empty((f, n), dtype=complex)
        spec[:, 0] = z[:, 0].real + z[:, 0].imag
        spec[:, m] = z[:, 0].real - z[:, 0].imag
        for k in range(1, m // 2 + 1):
            a, b = z[:, k], z[:, m - k]
            wr, wi = sp[k]
            er, ei = 0.5 * (a.real + b.real), 0.5 * (a.imag - b.imag)
            dr, di = 0.5 * (a.real - b.real), 0.5 * (a.imag + b.imag)
            u, v = wr * di + wi * dr, wi * di - wr * dr
            spec[:, k] = spec[:, n - k] = er + u
            spec[:, k] += 1j * (ei + v)
            spec[:, n - k] -= 1j * (ei + v)
            if 2 * k < m:
                spec[:, m - k] = (er - u) + 1j * (v - ei)
                spec[:, m + k] = (er - u) - 1j * (v - ei)
    want_re, want_im = tchain.chain_frames_full_reference(x3, s3, tables)
    scale = float(max(want_re.abs().max(), want_im.abs().max()))
    np.testing.assert_allclose(spec.real, want_re.numpy(), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(spec.imag, want_im.numpy(), rtol=0,
                               atol=1e-12 * scale)


def test_full_kernel_refuses_an_odd_n_above_its_limit():
    """The largest odd N, 127 x 127, fits a block at the chain's state
    (its FFT's planes overlap x and y); with a state so large that the
    block's shared memory exceeds the card's 227 KB it raises before any
    build."""
    from simpledsp_tpu_torch.models.northstar import default_design

    ops = tchain.FusedNorthStarOperators(default_design(), 127 * 127,
                                         device="cpu")
    assert (ops.n1, ops.n2) == (127, 127)
    d = ops.state_dim
    assert tchain._natural_smem_bytes(127, 127, d) <= tchain._MAX_SMEM
    assert 8 * 16160 <= 4 * 2 * 128 * 132      # the planes within x and y
    big = 200
    assert tchain._natural_smem_bytes(127, 127, big) > tchain._MAX_SMEM
    x3 = torch.zeros(1, 127, 127)
    s3 = torch.zeros(1, big, 127)
    tables = ops.tables(full=True)._replace(PhiT=torch.zeros(big, 127))
    launches = tchain.chain_full_kernel.launches
    with pytest.raises(ValueError, match="do not fit a block"):
        tchain.chain_full_kernel(x3, s3, tables)
    assert tchain.chain_full_kernel.launches == launches
