"""The PyTorch port's generic transfer-function filtering
(simpledsp_tpu_torch.ops.lfilter) against the JAX package and scipy, in
float64 on the CPU (the port of tests/test_lfilter.py).

Inputs are made with numpy from a seed and handed to both packages; the
``zi`` state crosses through ``simpledsp_tpu_torch.convert``.
Tolerances: the host float64 analysis (``tf_state_space_f64``, the
``freq*`` family, ``lfilter_zi``, ``lfiltic``) gives the JAX package's bits
(the same NumPy code); filter outputs and states agree with JAX and scipy
to 1e-12 absolute (outputs of order 1), filtfilt of an 8th-order
Chebyshev to 1e-10 as in the JAX tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

from simpledsp_tpu.ops import lfilter as jlf
from simpledsp_tpu_torch.convert import zi_from_numpy
from simpledsp_tpu_torch.ops import lfilter as tlf

TOL = 1e-12


@pytest.fixture(scope="module")
def ba():
    return ss.butter(5, 0.2)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("method", ["scan", "block"])
def test_lfilter_matches_jax_and_scipy(rng, ba, method):
    b, a = ba
    x = rng.standard_normal((3, 1100))
    y, zf = tlf.lfilter(b, a, t64(x), method=method, block_size=128)
    jy, jzf = jlf.lfilter(b, a, jnp.asarray(x), method=method,
                          block_size=128)
    ref, rzf = ss.lfilter(b, a, x, axis=-1,
                          zi=np.zeros((3, len(a) - 1)))
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    np.testing.assert_allclose(zf.numpy(), rzf, rtol=0, atol=TOL)
    np.testing.assert_allclose(zf.numpy(), np.asarray(jzf), rtol=0, atol=TOL)


@pytest.mark.parametrize("method", ["scan", "block", "auto"])
def test_zi_in_and_zf_out(rng, ba, method):
    b, a = ba
    x = rng.standard_normal((2, 1300))
    zi0 = np.tile(ss.lfilter_zi(b, a), (2, 1)) * x[:, :1]
    zi = zi_from_numpy(zi0, state_dim=len(a) - 1, dtype=torch.float64)
    y, zf = tlf.lfilter(b, a, t64(x), zi, method=method, block_size=128)
    jy, jzf = jlf.lfilter(b, a, jnp.asarray(x), jnp.asarray(zi0),
                          method=method, block_size=128)
    ref, rzf = ss.lfilter(b, a, x, axis=-1, zi=zi0)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(zf.numpy(), rzf, rtol=0, atol=TOL)
    np.testing.assert_allclose(zf.numpy(), np.asarray(jzf), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=TOL)


def test_zi_convert_checks_shape():
    with pytest.raises(ValueError):
        zi_from_numpy(np.zeros((2, 4)), state_dim=5)
    with pytest.raises(ValueError):
        zi_from_numpy(np.float64(1.0))
    z = zi_from_numpy(np.arange(5.0), state_dim=5, dtype=torch.float32)
    assert z.dtype == torch.float32 and z.device.type == "cpu"
    np.testing.assert_array_equal(z.numpy(), np.arange(5.0))


def test_fir_and_pure_gain(rng):
    x = rng.standard_normal(128)
    y, _ = tlf.lfilter_scan([0.5, 0.25], [1.0], t64(x))
    np.testing.assert_allclose(y.numpy(), ss.lfilter([0.5, 0.25], [1.0], x),
                               rtol=0, atol=1e-14)
    g, zf = tlf.lfilter_scan([3.0], [1.5], t64(x))
    np.testing.assert_allclose(g.numpy(), 2.0 * x, rtol=0, atol=1e-14)
    assert tuple(zf.shape) == (0,)
    g, zf = tlf.BlockLFilter([3.0], [1.5], dtype=torch.float64,
                             device="cpu")(t64(x))
    np.testing.assert_allclose(g.numpy(), 2.0 * x, rtol=0, atol=1e-14)
    assert tuple(zf.shape) == (0,)


def test_bad_coeffs_and_method_rejected(rng):
    x = t64(rng.standard_normal(16))
    for b, a in (([1.0], [0.0]), (np.ones((2, 2)), [1.0])):
        with pytest.raises(ValueError):
            tlf.lfilter_scan(b, a, x)
        with pytest.raises(ValueError):
            jlf.lfilter_scan(b, a, jnp.asarray(x.numpy()))
    with pytest.raises(ValueError):
        tlf.lfilter([1.0], [1.0], x, method="fast")
    with pytest.raises(ValueError):
        tlf.BlockLFilter([1.0], [1.0], block_size=0, device="cpu")


@pytest.mark.parametrize("block_size", [64, 128, 256])
def test_block_operators_equal_jax(ba, block_size):
    b, a = ba
    got = tlf.BlockLFilter(b, a, block_size=block_size, dtype=torch.float64,
                           device="cpu")
    want = jlf.BlockLFilter(b, a, block_size=block_size, dtype=jnp.float64)
    for name in ("H", "Phi", "K", "F"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, "_" + name))
    assert got.state_dim == want.state_dim


def test_block_matches_scan(rng, ba):
    b, a = ba
    x = rng.standard_normal((2, 1024))
    blk = tlf.BlockLFilter(b, a, block_size=128, dtype=torch.float64,
                           device="cpu")
    y_blk, zf_blk = blk(t64(x))
    y_ref, zf_ref = tlf.lfilter_scan(b, a, t64(x))
    np.testing.assert_allclose(y_blk.numpy(), y_ref.numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(zf_blk.numpy(), zf_ref.numpy(), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("split", [300, 512, 333])
def test_streaming_in_two_halves(rng, ba, split):
    """A split anywhere (a non-block tail included) equals the whole run;
    the scan is bit for bit."""
    b, a = ba
    x = rng.standard_normal(700)
    blk = tlf.BlockLFilter(b, a, block_size=128, dtype=torch.float64,
                           device="cpu")
    y_whole, z_whole = blk(t64(x))
    ya, z = blk(t64(x[:split]))
    yb, z = blk(t64(x[split:]), z)
    np.testing.assert_allclose(torch.cat([ya, yb]).numpy(), y_whole.numpy(),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(z.numpy(), z_whole.numpy(), rtol=0, atol=TOL)
    s_whole, _ = tlf.lfilter_scan(b, a, t64(x))
    sa, z = tlf.lfilter_scan(b, a, t64(x[:split]))
    sb, _ = tlf.lfilter_scan(b, a, t64(x[split:]), z)
    assert torch.equal(torch.cat([sa, sb]), s_whole)


def test_lfilter_auto_dispatch(rng, ba):
    b, a = ba
    x = rng.standard_normal(5000)
    y, _ = tlf.lfilter(b, a, t64(x))
    np.testing.assert_allclose(y.numpy(), ss.lfilter(b, a, x), rtol=0,
                               atol=TOL)


def test_lfilter_float32_follows_jax(rng, ba):
    """float32 on both sides (IEEE float32 products, HIGHEST in JAX): the
    two agree to float32 rounding of outputs of order 1."""
    b, a = ba
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    y, _ = tlf.lfilter(b, a, torch.as_tensor(x))
    jy, _ = jlf.lfilter(b, a, jnp.asarray(x))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=2e-5)


@pytest.mark.parametrize("padlen", [0, 1, None, 799])
def test_filtfilt_padlen(rng, ba, padlen):
    b, a = ba
    x = rng.standard_normal((2, 800))
    y = tlf.filtfilt(b, a, t64(x), padlen=padlen)
    jy = jlf.filtfilt(b, a, jnp.asarray(x), padlen=padlen)
    ref = ss.filtfilt(b, a, x, axis=-1,
                      padlen=3 * max(len(a), len(b)) if padlen is None
                      else padlen)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-11)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=TOL)


@pytest.mark.parametrize("method", ["scan", "block"])
def test_filtfilt_high_order_and_zero_phase(rng, method):
    b, a = ss.cheby1(8, 1, 0.4)
    t = np.arange(2000)
    x = np.sin(2 * np.pi * 0.02 * t) + rng.standard_normal(2000) * 0.1
    y = tlf.filtfilt(b, a, t64(x), method=method).numpy()
    np.testing.assert_allclose(y, ss.filtfilt(b, a, x), rtol=0, atol=1e-10)
    xc = np.sin(2 * np.pi * 0.02 * t)
    yc = tlf.filtfilt(b, a, t64(xc), method=method).numpy()
    core = slice(200, -200)
    lag = np.argmax(np.correlate(yc[core], xc[core], "full")) - \
        (yc[core].size - 1)
    assert lag == 0


def test_filtfilt_padlen_too_long_rejected(rng, ba):
    b, a = ba
    with pytest.raises(ValueError):
        tlf.filtfilt(b, a, t64(rng.standard_normal(10)))
    with pytest.raises(ValueError):
        tlf.filtfilt(b, a, t64(rng.standard_normal(100)), padlen=100)


@pytest.mark.parametrize("design", [lambda: ss.butter(5, 0.2),
                                    lambda: ss.cheby1(4, 1, 0.3),
                                    lambda: ([0.5, 0.25, 0.1], [1.0]),
                                    lambda: ([2.0], [1.0, -0.5])])
def test_host_analysis_equals_jax(design):
    b, a = design()
    for got, want in zip(tlf.tf_state_space_f64(b, a),
                         jlf.tf_state_space_f64(b, a)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tlf.lfilter_zi(b, a), jlf.lfilter_zi(b, a))
    np.testing.assert_allclose(tlf.lfilter_zi(b, a), ss.lfilter_zi(b, a),
                               rtol=0, atol=TOL)
    for got, want in zip(tlf.freqz(b, a, 256), jlf.freqz(b, a, 256)):
        np.testing.assert_array_equal(got, want)
    y = np.arange(1.0, 5.0)
    x = np.arange(4.0) - 1.5
    np.testing.assert_array_equal(tlf.lfiltic(b, a, y, x),
                                  jlf.lfiltic(b, a, y, x))
    np.testing.assert_array_equal(tlf.lfiltic(b, a, y), jlf.lfiltic(b, a, y))


def test_freqz_matches_scipy(ba):
    b, a = ba
    w, h = tlf.freqz(b, a, 256)
    wr, hr = ss.freqz(b, a, worN=256)
    np.testing.assert_allclose(w, wr, rtol=0, atol=TOL)
    np.testing.assert_allclose(h, hr, rtol=0, atol=TOL)


def test_freqs_family_matches_scipy_and_jax():
    bc, ac = ss.butter(4, 100.0, analog=True)
    w = np.logspace(0, 3, 50)
    for worN in (w, 64):
        got, want = tlf.freqs(bc, ac, worN), jlf.freqs(bc, ac, worN)
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g, j)
    _, h2 = ss.freqs(bc, ac, worN=w)
    np.testing.assert_allclose(tlf.freqs(bc, ac, worN=w)[1], h2, atol=TOL)
    assert tlf.freqs(bc, ac, 64)[0].size == 64
    z, p, k = ss.butter(4, 100.0, analog=True, output="zpk")
    _, h1 = tlf.freqs_zpk(z, p, k, w)
    np.testing.assert_array_equal(h1, jlf.freqs_zpk(z, p, k, w)[1])
    np.testing.assert_allclose(h1, ss.freqs_zpk(z, p, k, worN=w)[1],
                               atol=TOL)
    z, p, k = ss.butter(4, 0.3, output="zpk")
    warr = np.linspace(0.01, 0.99 * np.pi, 33)
    for n in (128, warr):
        w1, h1 = tlf.freqz_zpk(z, p, k, n)
        wj, hj = jlf.freqz_zpk(z, p, k, n)
        np.testing.assert_array_equal(h1, hj)
        np.testing.assert_array_equal(w1, wj)
        w2, h2 = ss.freqz_zpk(z, p, k, worN=n)
        np.testing.assert_allclose(w1, w2, atol=TOL)
        np.testing.assert_allclose(h1, h2, atol=TOL)


def test_lfiltic_matches_scipy_and_continues_stream(rng):
    b, a = ss.butter(4, 0.3)
    y_hist = rng.standard_normal(4)
    x_hist = rng.standard_normal(4)
    zi = tlf.lfiltic(b, a, y_hist, x_hist)
    np.testing.assert_allclose(zi, ss.lfiltic(b, a, y_hist, x_hist),
                               atol=1e-14)
    np.testing.assert_allclose(tlf.lfiltic(b, a, y_hist),
                               ss.lfiltic(b, a, y_hist), atol=1e-14)
    x = rng.standard_normal(64)
    y1, _ = tlf.lfilter(b, a, t64(x), zi=t64(zi))
    y2, _ = ss.lfilter(b, a, x, zi=zi)
    np.testing.assert_allclose(y1.numpy(), y2, atol=TOL)
