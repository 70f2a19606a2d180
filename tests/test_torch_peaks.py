"""The PyTorch port's peak family (simpledsp_tpu_torch.ops.peaks) against
scipy and the JAX package, on the CPU (the port of tests/test_peaks.py).

The module is the JAX package's NumPy code, so the differential cases
hold it to the JAX package's bits: equal indices, equal properties.  The
scipy cases keep the JAX tests' tolerances (numpy's ``assert_allclose``
default, rtol 1e-7).  Signals go in as numpy arrays and as tensors: a
tensor is fetched to the host and gives the same result.
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

from simpledsp_tpu.ops import peaks as jpk
from simpledsp_tpu_torch.ops import peaks as pk


@pytest.fixture
def sig1(rng):
    n = 2000
    return np.cumsum(rng.standard_normal(n)) + 0.3 * np.sin(
        np.arange(n) * 0.1)


def _same(a, b):
    """Equal bits, through any nesting of tuples, lists and dicts."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- the JAX package's tests, on the port --------------------------------------

def test_plain_local_maxima(sig1):
    a, _ = pk.find_peaks(sig1)
    b, _ = ss.find_peaks(sig1)
    np.testing.assert_array_equal(a, b)
    assert a.size > 100


@pytest.mark.parametrize("kw", [
    dict(height=1.0),
    dict(height=(0.5, 20.0)),
    dict(threshold=0.2),
    dict(distance=15),
    dict(prominence=2.0),
    dict(width=3),
    dict(prominence=1.0, width=(2, 30), distance=8),
    dict(plateau_size=1),
])
def test_find_peaks_conditions_match_scipy(sig1, kw):
    a, pa = pk.find_peaks(sig1, **kw)
    b, pb = ss.find_peaks(sig1, **kw)
    np.testing.assert_array_equal(a, b)
    assert set(pa) == set(pb)
    for k in pb:
        np.testing.assert_allclose(pa[k], pb[k], err_msg=k)


def test_plateau_handling():
    x = np.array([0, 1, 1, 1, 0, 2, 2, 0, 3, 0, 1, 0], float)
    a, pa = pk.find_peaks(x, plateau_size=2)
    b, pb = ss.find_peaks(x, plateau_size=2)
    np.testing.assert_array_equal(a, b)
    for k in pb:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


@pytest.mark.parametrize("wlen", [None, 5, 40, 41, 100])
def test_peak_prominences_match_scipy(sig1, wlen):
    p, _ = ss.find_peaks(sig1, distance=10)
    a = pk.peak_prominences(sig1, p, wlen=wlen)
    b = ss.peak_prominences(sig1, p, wlen=wlen)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u, v)


@pytest.mark.parametrize("rel", [0.5, 0.7, 1.0])
def test_peak_widths_match_scipy(sig1, rel):
    p, _ = ss.find_peaks(sig1, distance=10)
    a = pk.peak_widths(sig1, p, rel)
    b = ss.peak_widths(sig1, p, rel)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u, v)


def test_argrel_family(rng):
    y = rng.standard_normal((3, 100))
    for order in (1, 3):
        for ours, theirs in [(pk.argrelmax, ss.argrelmax),
                             (pk.argrelmin, ss.argrelmin)]:
            a = ours(y, order=order)
            b = theirs(y, order=order, axis=-1)
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


def test_errors(sig1):
    with pytest.raises(ValueError):
        pk.find_peaks(sig1, distance=0.5)
    with pytest.raises(ValueError):
        pk.find_peaks(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        pk.peak_prominences(sig1, [99999])
    with pytest.raises(ValueError):
        pk.peak_prominences(sig1, [5], wlen=1)
    with pytest.raises(ValueError):
        pk.peak_widths(sig1, [100], rel_height=-1.0)
    with pytest.raises(ValueError):
        pk.argrelmax(sig1, order=0)


def test_find_peaks_x_length_condition_arrays(sig1):
    """Array conditions are SIGNAL-length, sampled at peak positions
    (scipy semantics)."""
    arr = np.full(sig1.size, 1.0)
    arr[: sig1.size // 2] = 50.0           # suppress the first half
    a, _ = pk.find_peaks(sig1, height=arr)
    b, _ = ss.find_peaks(sig1, height=arr)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pk.find_peaks(sig1, height=np.ones(7))


def test_peak_widths_plateau_rel0_no_nan():
    x = np.array([0., 1, 2, 2, 2, 1, 0])
    w, wh, li, ri = pk.peak_widths(x, [3], rel_height=0.0)
    ref = ss.peak_widths(x, [3], rel_height=0.0)
    for u, v in zip((w, wh, li, ri), ref):
        np.testing.assert_allclose(u, v)
    assert np.all(np.isfinite(w))


def test_find_peaks_cwt_matches_scipy():
    """Wavelet-ridge peak finding: index-exact vs scipy across
    widths/filters, noise-only input, and a custom wavelet."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, 800)
    x = (np.exp(-((t - 2.0) / 0.15) ** 2)
         + 0.8 * np.exp(-((t - 5.0) / 0.4) ** 2)
         + 0.6 * np.exp(-((t - 8.0) / 0.1) ** 2)
         + 0.05 * rng.standard_normal(t.size))
    for widths in (np.arange(1, 20), np.arange(2, 35, 3), [5, 10, 15]):
        for kw in (dict(), dict(min_snr=2.0), dict(noise_perc=25),
                   dict(gap_thresh=3), dict(min_length=3),
                   dict(window_size=41)):
            got = pk.find_peaks_cwt(x, widths, **kw)
            ref = ss.find_peaks_cwt(x, widths, **kw)
            assert np.array_equal(got, ref), (widths, kw)
    y = rng.standard_normal(300)
    assert np.array_equal(pk.find_peaks_cwt(y, np.arange(1, 10)),
                          ss.find_peaks_cwt(y, np.arange(1, 10)))

    def gauss_wavelet(points, a):
        v = np.arange(points) - (points - 1.0) / 2
        return np.exp(-v ** 2 / (2 * a * a))

    assert np.array_equal(
        pk.find_peaks_cwt(x, np.arange(1, 12), wavelet=gauss_wavelet),
        ss.find_peaks_cwt(x, np.arange(1, 12), wavelet=gauss_wavelet))


def test_find_peaks_cwt_complex_wavelet():
    """Complex wavelets promote the CWT matrix to complex128:
    lexicographic maxima + fraction-percentile noise floor, index-exact
    vs scipy."""
    rng = np.random.default_rng(1)
    t = np.linspace(0, 10, 500)
    x = (np.exp(-((t - 3) / 0.2) ** 2)
         + 0.7 * np.exp(-((t - 7) / 0.3) ** 2)
         + 0.05 * rng.standard_normal(500))

    def morlet_like(points, a):
        v = (np.arange(points) - (points - 1.0) / 2) / a
        return np.exp(1j * 5 * v) * np.exp(-v * v / 2)

    got = pk.find_peaks_cwt(x, np.arange(1, 10), wavelet=morlet_like)
    ref = ss.find_peaks_cwt(x, np.arange(1, 10), wavelet=morlet_like)
    assert np.array_equal(got, ref)


# -- against the JAX package: equal bits ---------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(height=(0.5, 20.0), threshold=(0.01, 3.0)),
    dict(distance=25.5),
    dict(prominence=(1.0, 8.0), wlen=60),
    dict(width=(2, 40), rel_height=0.8),
    dict(prominence=1.0, width=2, distance=8, plateau_size=(1, 3)),
])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_find_peaks_gives_the_jax_bits(sig1, kw, as_tensor):
    x = torch.from_numpy(sig1) if as_tensor else sig1
    _same(pk.find_peaks(x, **kw), jpk.find_peaks(sig1, **kw))


def test_find_peaks_takes_tensor_conditions(sig1):
    """A condition array given as a tensor is fetched like the signal."""
    arr = np.linspace(-5.0, 30.0, sig1.size)
    _same(pk.find_peaks(torch.from_numpy(sig1), height=torch.from_numpy(arr),
                        prominence=(torch.tensor(0.5), None)),
          jpk.find_peaks(sig1, height=arr, prominence=(0.5, None)))


@pytest.mark.parametrize("wlen", [None, 7, 64.5])
def test_prominences_and_widths_give_the_jax_bits(sig1, wlen):
    p = jpk.find_peaks(sig1, distance=10)[0]
    x = torch.from_numpy(sig1)
    prom = pk.peak_prominences(x, torch.from_numpy(p), wlen=wlen)
    _same(prom, jpk.peak_prominences(sig1, p, wlen=wlen))
    for rel in (0.25, 1.0):
        _same(pk.peak_widths(x, p, rel, wlen=wlen),
              jpk.peak_widths(sig1, p, rel, wlen=wlen))
        _same(pk.peak_widths(sig1, p, rel, prominence_data=tuple(
            torch.from_numpy(v) for v in prom)),
              jpk.peak_widths(sig1, p, rel, prominence_data=prom))


@pytest.mark.parametrize("mode", ["clip", "wrap"])
@pytest.mark.parametrize("order", [1, 2, 5])
def test_argrel_gives_the_jax_bits(rng, mode, order):
    y = np.round(rng.standard_normal((4, 7, 60)), 1)     # with ties
    for ours, theirs in [(pk.argrelmax, jpk.argrelmax),
                         (pk.argrelmin, jpk.argrelmin)]:
        _same(ours(torch.from_numpy(y), order, mode), theirs(y, order, mode))
    _same(pk.argrelextrema(y, np.greater_equal, order, mode),
          jpk.argrelextrema(y, np.greater_equal, order, mode))


def test_ricker_and_cwt_give_the_jax_bits(rng):
    for points, a in ((10, 4.0), (101, 7.5), (1, 1.0)):
        _same(pk.ricker(points, a), jpk.ricker(points, a))
    t = np.linspace(0, 6, 600)
    x = (np.exp(-((t - 1.5) / 0.1) ** 2) + np.exp(-((t - 4.0) / 0.3) ** 2)
         + 0.05 * rng.standard_normal(t.size))
    for widths in (np.arange(1, 15), [3.0, 6.0, 9.0]):
        _same(pk.find_peaks_cwt(torch.from_numpy(x), torch.as_tensor(widths)),
              jpk.find_peaks_cwt(x, widths))
