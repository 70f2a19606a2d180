"""The port's 1-D convolution surface (ops/conv) against the JAX package and
scipy, in float64 on the CPU.

Inputs take each route: direct (min(n, m) <= 96), the power-of-2 FFT
product, and overlap-save (real, n >= 4 m, n + m - 1 >= 8192; the plain
OverlapSaveFIR blocks on the CPU, as in the JAX package off the TPU).
Tolerance: 1e-12 relative to the largest output magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu.ops import conv as jconv
from simpledsp_tpu_torch.ops import conv as tconv

TOL = 1e-12

# (n, m): direct, pow2 FFT, overlap-save, FFT with n < 4 m
SHAPES = [(50, 7), (300, 200), (20000, 301), (9000, 3000)]
MODES = ["full", "same", "valid"]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _signal(rng, shape, cplx):
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if cplx else x


def _scipy(fn, x, h, mode):
    rows = x.reshape(-1, x.shape[-1])
    return np.stack([fn(r, h, mode) for r in rows]).reshape(
        x.shape[:-1] + (-1,))


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", ["auto", "direct", "fft"])
def test_convolve_real_matches_jax_and_scipy(n, m, mode, method, rng):
    x = rng.standard_normal((2, n))
    h = rng.standard_normal(m)
    got = tconv.convolve(torch.as_tensor(x), h, mode, method=method).numpy()
    _close(got, jconv.convolve(jnp.asarray(x), h, mode, method=method))
    _close(got, _scipy(sig.convolve, x, h, mode))


@pytest.mark.parametrize("n,m", SHAPES[:3])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["complex_x", "complex_h", "both"])
def test_convolve_complex_matches_jax_and_scipy(n, m, mode, kind, rng):
    x = _signal(rng, (2, n), kind != "complex_h")
    h = _signal(rng, m, kind != "complex_x")
    got = tconv.convolve(torch.as_tensor(x), h, mode)
    assert got.is_complex()
    _close(got.numpy(), jconv.convolve(jnp.asarray(x), h, mode))
    _close(got.numpy(), _scipy(sig.convolve, x, h, mode))


@pytest.mark.parametrize("n,m", SHAPES[:3])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cplx", [False, True])
def test_correlate_matches_jax_and_scipy(n, m, mode, cplx, rng):
    x = _signal(rng, (3, n), cplx)
    h = _signal(rng, m, cplx)
    got = tconv.correlate(torch.as_tensor(x), h, mode).numpy()
    _close(got, jconv.correlate(jnp.asarray(x), h, mode))
    _close(got, _scipy(sig.correlate, x, h, mode))
    # Tensor taps are flipped on their device; same result.
    _close(tconv.correlate(torch.as_tensor(x), torch.as_tensor(h), mode).numpy(),
           got)


@pytest.mark.parametrize("fn", ["fftconvolve", "oaconvolve"])
@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_fft_named_entries(fn, n, m, mode, rng):
    x = rng.standard_normal((2, n))
    h = rng.standard_normal(m)
    got = getattr(tconv, fn)(torch.as_tensor(x), h, mode).numpy()
    _close(got, getattr(jconv, fn)(jnp.asarray(x), h, mode))
    _close(got, _scipy(getattr(sig, fn), x, h, mode))


def test_batched_axes_and_tensor_taps(rng):
    """Leading axes (2, 3); numpy, list and tensor taps give one result;
    the overlap-save route with tensor taps as with host taps."""
    x = rng.standard_normal((2, 3, 20000))
    h = rng.standard_normal(301)
    want = jconv.convolve(jnp.asarray(x), h, "same")
    for taps in (h, list(h), torch.as_tensor(h)):
        _close(tconv.convolve(torch.as_tensor(x), taps, "same").numpy(), want)


def test_float32_working_dtype(rng):
    x = rng.standard_normal((2, 20000)).astype(np.float32)
    h = rng.standard_normal(301)
    got = tconv.convolve(torch.as_tensor(x), h)
    assert got.dtype == torch.float32
    ref = _scipy(sig.convolve, x.astype(np.float64), h, "full")
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert tconv.convolve(torch.as_tensor(x), h,
                          dtype=torch.float64).dtype == torch.float64


@pytest.mark.parametrize("n1,n2", [(10, 4), (4, 10), (7, 7), (1, 5), (100, 33)])
@pytest.mark.parametrize("mode", MODES)
def test_correlation_lags_match_scipy(n1, n2, mode):
    got = tconv.correlation_lags(n1, n2, mode)
    np.testing.assert_array_equal(got, sig.correlation_lags(n1, n2, mode))
    np.testing.assert_array_equal(got, jconv.correlation_lags(n1, n2, mode))


@pytest.mark.parametrize("n,m", [(50, 7), (97, 97), (96, 500), (300, 200),
                                 (20000, 301)])
def test_choose_conv_method_matches_jax(n, m, rng):
    x = rng.standard_normal(n)
    h = rng.standard_normal(m)
    want = jconv.choose_conv_method(x, h)
    assert tconv.choose_conv_method(x, h) == want
    assert tconv.choose_conv_method(torch.as_tensor(x), h) == want


def test_choose_conv_method_measures_both(rng):
    x = rng.standard_normal((2, 512))
    h = rng.standard_normal(100)
    method, times = tconv.choose_conv_method(x, h, measure=True)
    assert method in ("fft", "direct")
    assert set(times) == {"fft", "direct"} and min(times.values()) > 0


def test_rejects_bad_arguments(rng):
    x = torch.as_tensor(rng.standard_normal(64))
    with pytest.raises(ValueError, match="unknown method"):
        tconv.convolve(x, np.ones(3), method="winograd")
    with pytest.raises(ValueError, match="unknown mode"):
        tconv.convolve(x, np.ones(3), "ful")
    with pytest.raises(ValueError, match="1-D"):
        tconv.convolve(x, np.ones((2, 2)))
    with pytest.raises(ValueError, match="non-empty"):
        tconv.convolve(x, np.ones(0))
    with pytest.raises(ValueError, match="unknown mode"):
        tconv.correlation_lags(4, 3, "ful")


# -- deconvolve -------------------------------------------------------------------

def test_deconvolve_matches_jax_and_scipy(rng):
    s = rng.standard_normal(100)
    div = np.array([1.5, 0.7, -0.3])
    q, r = tconv.deconvolve(torch.as_tensor(s), div)
    jq, jr = jconv.deconvolve(jnp.asarray(s), div)
    qs, rs = sig.deconvolve(s, div)
    for got, want in ((q, qs), (r, rs), (q, jq), (r, jr)):
        _close(got.numpy(), want)
    # signal == convolve(divisor, q) + r, batched
    sb = rng.standard_normal((3, 60))
    qb, rb = tconv.deconvolve(torch.as_tensor(sb), div)
    jqb, jrb = jconv.deconvolve(jnp.asarray(sb), div)
    _close(qb.numpy(), jqb)
    _close(rb.numpy(), jrb)
    recon = np.stack([np.convolve(div, qb[i].numpy())[:60] + rb[i].numpy()
                      for i in range(3)])
    _close(recon, sb)


def test_deconvolve_short_signal_and_bad_divisor(rng):
    s = torch.as_tensor(rng.standard_normal(2))
    q, r = tconv.deconvolve(s, [1.0, 0.5, 0.25])
    jq, jr = jconv.deconvolve(jnp.asarray(s.numpy()), [1.0, 0.5, 0.25])
    assert tuple(q.shape) == jq.shape == (0,)
    assert torch.equal(r, s)
    for bad in ([0.0, 1.0], np.ones((2, 2)), []):
        with pytest.raises(ValueError):
            tconv.deconvolve(s, bad)
