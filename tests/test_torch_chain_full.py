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
    """The CUDA wrapper checks its operands before it builds or launches:
    float64, and the half table where the full one belongs."""
    _, tops = _ops(1000)
    x3 = torch.zeros(2, tops.n1, tops.n2, dtype=torch.float64)
    s3 = torch.zeros(2, tops.state_dim, tops.n1, dtype=torch.float64)
    launches = tchain.chain_full_kernel.launches
    with pytest.raises(ValueError, match="float32"):
        tchain.chain_full_kernel(x3, s3, tops.tables(full=True))
    tabs32 = tchain.ChainTables(*(t.float() for t in tops.tables()))
    with pytest.raises(ValueError, match="expected a contiguous"):
        tchain.chain_full_kernel(x3.float(), s3.float(), tabs32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tchain.chain_frames_full(x3.to("meta"), s3.to("meta"),
                                 tops.tables(full=True))
    assert tchain.chain_full_kernel.launches == launches
