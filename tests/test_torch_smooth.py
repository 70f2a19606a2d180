"""The PyTorch port's smoothing layer (simpledsp_tpu_torch.ops.smooth)
against scipy and the JAX package, on the CPU (the port of
tests/test_smooth.py).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the host float64 design (``savgol_coeffs``, the edge maps)
gives the JAX package's bits (the same NumPy code); the torch bodies
(``savgol_filter``, ``wiener``, ``detrend``) agree with the JAX package
in float64 to 1e-12 absolute on outputs of order 1, and with scipy to the
JAX tests' bars (1e-9 / 1e-10); the rank filters (``medfilt``,
``medfilt2d``, ``order_filter``) select, so they equal both bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu.ops import smooth as js
from simpledsp_tpu_torch.ops import smooth as ts
from simpledsp_tpu_torch.ops.smooth import (detrend, medfilt, medfilt2d,
                                            order_filter, savgol_coeffs,
                                            savgol_filter, wiener)

TOL = 1e-12
MODES = ["interp", "mirror", "constant", "nearest", "wrap"]


@pytest.fixture
def rng():
    return np.random.default_rng(77)


def T(x):
    return torch.from_numpy(np.asarray(x))


def _jax(fn, x, *args, **kw):
    return np.asarray(fn(jnp.asarray(x), *args, **kw))


# -- the JAX package's tests, on the port --------------------------------------

class TestSavgol:
    @pytest.mark.parametrize("wl,po,d", [(5, 2, 0), (11, 3, 1), (21, 4, 2),
                                         (7, 6, 0)])
    def test_coeffs_match_scipy(self, wl, po, d):
        np.testing.assert_allclose(savgol_coeffs(wl, po, deriv=d),
                                   sig.savgol_coeffs(wl, po, deriv=d),
                                   atol=1e-13)

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("wl,po,d,delta", [(11, 3, 0, 1.0),
                                               (11, 3, 1, 0.5),
                                               (9, 2, 2, 2.0)])
    def test_filter_matches_scipy(self, rng, mode, wl, po, d, delta):
        x = rng.standard_normal(200).cumsum()
        got = savgol_filter(T(x), wl, po, deriv=d, delta=delta,
                            mode=mode).numpy()
        want = sig.savgol_filter(x, wl, po, deriv=d, delta=delta, mode=mode)
        np.testing.assert_allclose(got, want, atol=1e-9)

    def test_batched(self, rng):
        x = rng.standard_normal((4, 100))
        got = savgol_filter(T(x), 9, 3).numpy()
        for i in range(4):
            np.testing.assert_allclose(got[i], sig.savgol_filter(x[i], 9, 3),
                                       atol=1e-10)

    def test_rejects_bad_args(self, rng):
        x = T(rng.standard_normal(50))
        with pytest.raises(ValueError):
            savgol_filter(x, 8, 3)
        with pytest.raises(ValueError):
            savgol_filter(x, 9, 9)
        with pytest.raises(ValueError):
            savgol_filter(x, 51, 3, mode="interp")
        with pytest.raises(ValueError):
            savgol_filter(x, 9, 3, mode="reflect")


class TestMedian:
    @pytest.mark.parametrize("k", [1, 3, 5, 9])
    def test_medfilt_matches_scipy(self, rng, k):
        x = rng.standard_normal(200)
        np.testing.assert_array_equal(medfilt(T(x), k).numpy(),
                                      sig.medfilt(x, k))

    @pytest.mark.parametrize("k", [3, 5, (3, 5)])
    def test_medfilt2d_matches_scipy(self, rng, k):
        im = rng.standard_normal((20, 24))
        np.testing.assert_array_equal(medfilt2d(T(im), k).numpy(),
                                      sig.medfilt2d(im, k))

    def test_rejects_even_kernel(self, rng):
        with pytest.raises(ValueError):
            medfilt(T(rng.standard_normal(10)), 4)
        with pytest.raises(ValueError):
            medfilt2d(T(rng.standard_normal((5, 5))), (3, 4))


class TestWiener:
    @pytest.mark.parametrize("mysize,noise", [(3, None), (5, 0.5),
                                              ((3, 7), None)])
    def test_2d_matches_scipy(self, rng, mysize, noise):
        im = rng.standard_normal((20, 24))
        np.testing.assert_allclose(wiener(T(im), mysize, noise).numpy(),
                                   sig.wiener(im, mysize, noise), atol=1e-10)

    @pytest.mark.parametrize("mysize,noise", [(3, None), (7, 0.25)])
    def test_1d_matches_scipy(self, rng, mysize, noise):
        x = rng.standard_normal(300)
        np.testing.assert_allclose(wiener(T(x), mysize, noise).numpy(),
                                   sig.wiener(x, mysize, noise), atol=1e-10)


class TestDetrend:
    @pytest.mark.parametrize("kind", ["linear", "constant"])
    def test_matches_scipy(self, rng, kind):
        x = rng.standard_normal((3, 400)).cumsum(axis=-1)
        np.testing.assert_allclose(detrend(T(x), type=kind).numpy(),
                                   sig.detrend(x, type=kind, axis=-1),
                                   atol=1e-9)

    def test_rejects_unknown_type(self, rng):
        with pytest.raises(ValueError):
            detrend(T(rng.standard_normal(10)), type="quadratic")


class TestOrderFilter:
    def test_matches_scipy_hole_free(self, rng):
        """Hole-free domains: scipy's rank_filter path is correct there."""
        x2 = rng.standard_normal((20, 25))
        np.testing.assert_array_equal(
            order_filter(T(x2), np.ones((3, 5)), 7).numpy(),
            sig.order_filter(x2, np.ones((3, 5)), 7))
        x1 = rng.standard_normal(50)
        np.testing.assert_array_equal(order_filter(T(x1), np.ones(5),
                                                   2).numpy(),
                                      sig.order_filter(x1, np.ones(5), 2))

    def test_holed_domain_true_semantics(self, rng):
        """Domains with holes: rank over the SELECTED neighbors only
        (scipy 1.17's rank_filter ignores footprint holes), pinned against
        a direct numpy reference."""
        x = rng.standard_normal(30)
        dom = np.array([1, 0, 1, 1, 1])
        got = order_filter(T(x), dom, 1).numpy()
        offs = [j - 2 for j in np.flatnonzero(dom)]
        ref = np.array([
            np.sort([x[t + o] if 0 <= t + o < 30 else 0.0 for o in offs])[1]
            for t in range(30)])
        np.testing.assert_array_equal(got, ref)
        # and scipy 1.17 indeed ignores the hole (upstream behavior pin)
        assert np.allclose(sig.order_filter(x, dom, 1),
                           sig.order_filter(x, np.ones(5), 1))

    def test_median_special_case_and_errors(self, rng):
        x = rng.standard_normal((2, 40))
        np.testing.assert_array_equal(order_filter(T(x), np.ones(5),
                                                   2).numpy(),
                                      medfilt(T(x), 5).numpy())
        z = torch.zeros(8)
        with pytest.raises(ValueError):
            order_filter(z, np.ones(4), 0)              # even domain
        with pytest.raises(ValueError):
            order_filter(z, np.ones(5), 5)              # rank range
        with pytest.raises(ValueError):
            order_filter(z, np.ones((3, 3, 3)), 0)


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("wl,po,d,delta", [(5, 2, 0, 1.0), (31, 3, 0, 1.0),
                                           (11, 4, 2, 0.25), (7, 2, 3, 1.0)])
def test_savgol_host_design_gives_the_jax_bits(wl, po, d, delta):
    np.testing.assert_array_equal(savgol_coeffs(wl, po, deriv=d, delta=delta),
                                  js.savgol_coeffs(wl, po, deriv=d,
                                                   delta=delta))
    for a, b in zip(ts._savgol_edge_maps_f64(wl, po, d, delta),
                    js._savgol_edge_maps_f64(wl, po, d, delta)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wl,po,d", [(5, 2, 0), (11, 2, 0), (31, 3, 1),
                                     (15, 5, 2)])
def test_savgol_filter_matches_jax(rng, mode, wl, po, d):
    """Every pad mode, batched (2, 3, 257) rows, against the JAX package
    in float64."""
    x = rng.standard_normal((2, 3, 257))
    got = savgol_filter(T(x), wl, po, deriv=d, delta=0.5, mode=mode,
                        cval=0.75)
    want = _jax(js.savgol_filter, x, wl, po, deriv=d, delta=0.5, mode=mode,
                cval=0.75)
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["mirror", "nearest", "wrap", "constant"])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_savgol_pads_past_a_short_signal_as_jax_does(rng, mode, n):
    """A window longer than the signal: numpy's repeated padding (the
    periodic extensions), as jnp.pad gives the JAX package."""
    x = rng.standard_normal((2, n))
    got = savgol_filter(T(x), 13, 2, mode=mode).numpy()
    np.testing.assert_allclose(got, _jax(js.savgol_filter, x, 13, 2,
                                         mode=mode), rtol=0, atol=TOL)


@pytest.mark.parametrize("n,half", [(1, 4), (2, 7), (5, 3), (5, 12), (9, 4)])
@pytest.mark.parametrize("rule", ["reflect", "edge", "wrap"])
def test_pad_index_is_numpy_pad(n, half, rule):
    x = np.arange(n) * 10 + 1
    idx = ts._pad_index(n, half, rule, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(x[idx], np.pad(x, half, mode=rule))


def test_savgol_filter_float32_stays_float32(rng):
    x = rng.standard_normal((3, 500)).astype(np.float32)
    got = savgol_filter(T(x), 21, 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), sig.savgol_filter(
        x.astype(np.float64), 21, 3), rtol=0, atol=2e-6)


@pytest.mark.parametrize("k", [1, 3, 7, 11])
def test_medfilt_gives_the_jax_bits(rng, k):
    x = np.round(rng.standard_normal((3, 2, 120)), 1)       # with ties
    np.testing.assert_array_equal(medfilt(T(x), k).numpy(),
                                  _jax(js.medfilt, x, k))


@pytest.mark.parametrize("k", [1, 3, (5, 3), (1, 7), 7])
def test_medfilt2d_gives_the_jax_bits(rng, k):
    x = np.round(rng.standard_normal((2, 19, 23)), 1)
    np.testing.assert_array_equal(medfilt2d(T(x), k).numpy(),
                                  _jax(js.medfilt2d, x, k))


@pytest.mark.parametrize("dom,rank", [
    (np.array([1, 0, 1, 1, 1]), 1), (np.array([1, 1, 0, 0, 1, 1, 1]), 4),
    (np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]), 2),
    (np.array([[1, 0, 1], [0, 1, 0], [1, 0, 1]]), 0),
    (np.ones((3, 5)), 14), (np.array([[1, 1, 1, 0, 1]]), 3)])
def test_order_filter_gives_the_jax_bits(rng, dom, rank):
    """Domains with and without holes, 1-D and 2-D, batched: the JAX
    semantics (rank over the selected neighbours only)."""
    x = np.round(rng.standard_normal((2, 17, 21)), 1)
    np.testing.assert_array_equal(order_filter(T(x), dom, rank).numpy(),
                                  _jax(js.order_filter, x, dom, rank))
    np.testing.assert_array_equal(
        order_filter(T(x), torch.as_tensor(dom), rank).numpy(),
        _jax(js.order_filter, x, dom, rank))


@pytest.mark.parametrize("shape,mysize,noise", [
    ((300,), 3, None), ((300,), 4, None), ((2, 3, 300), 5, 0.4),
    ((20, 24), 3, None), ((20, 24), (3, 7), 0.5), ((2, 20, 24), (4, 2), None),
    ((3, 16, 16), None, None)])
def test_wiener_matches_jax(rng, shape, mysize, noise):
    """1-D and 2-D, odd and even windows (the asymmetric pad), batched."""
    x = rng.standard_normal(shape)
    got = wiener(T(x), mysize, noise)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), _jax(js.wiener, x, mysize, noise),
                               rtol=0, atol=TOL)


def test_wiener_rejects_a_wrong_size():
    with pytest.raises(ValueError):
        wiener(torch.zeros(4, 8), (3, 3, 3))


@pytest.mark.parametrize("kind", ["linear", "l", "constant", "c"])
@pytest.mark.parametrize("shape", [(400,), (2, 3, 257)])
def test_detrend_matches_jax(rng, kind, shape):
    x = rng.standard_normal(shape).cumsum(axis=-1) / 10
    np.testing.assert_allclose(detrend(T(x), type=kind).numpy(),
                               _jax(js.detrend, x, type=kind), rtol=0,
                               atol=TOL)


def test_device_tables_are_cached(rng):
    """The filter weights, edge maps, pad indices and detrend tables are
    built once per (size, dtype, device): a second call uploads nothing."""
    x = T(rng.standard_normal((2, 300)))
    for fn in (lambda: savgol_filter(x, 11, 2),
               lambda: savgol_filter(x, 11, 2, mode="wrap"),
               lambda: detrend(x)):
        fn()
    hits = [f.cache_info().hits for f in (ts._savgol_tables, ts._pad_index,
                                          ts._detrend_tables)]
    savgol_filter(x, 11, 2, mode="wrap")
    detrend(x)
    after = [f.cache_info().hits for f in (ts._savgol_tables, ts._pad_index,
                                           ts._detrend_tables)]
    assert after[0] == hits[0] + 1 and after[1] == hits[1] + 1
    assert after[2] == hits[2] + 1


@pytest.mark.parametrize("chunk", [1, 150, 1000, 1 << 22])
def test_rank_filters_in_row_chunks_give_the_jax_bits(rng, monkeypatch,
                                                      chunk):
    """The rank filters sort chunks of rows (2^22 samples on the card, so
    that no kernel is split over launches); any chunk gives the same bits,
    a row longer than the chunk going alone."""
    monkeypatch.setattr(ts, "_RANK_CHUNK", chunk)
    x = np.round(rng.standard_normal((3, 5, 100)), 1)
    np.testing.assert_array_equal(medfilt(T(x), 7).numpy(),
                                  _jax(js.medfilt, x, 7))
    img = np.round(rng.standard_normal((4, 12, 9)), 1)
    np.testing.assert_array_equal(medfilt2d(T(img), (3, 5)).numpy(),
                                  _jax(js.medfilt2d, img, (3, 5)))
    dom = np.array([[1, 0, 1], [0, 1, 1], [1, 1, 0]])
    np.testing.assert_array_equal(order_filter(T(img), dom, 3).numpy(),
                                  _jax(js.order_filter, img, dom, 3))


def test_rank_filters_keep_shape_dtype_and_empty_batches():
    x = torch.zeros((0, 5, 16), dtype=torch.float32)
    assert medfilt(x, 3).shape == (0, 5, 16)
    y = torch.arange(24, dtype=torch.int64).reshape(2, 12)
    np.testing.assert_array_equal(medfilt(y, 3).numpy(), np.stack(
        [sig.medfilt(r.astype(float), 3) for r in y.numpy()]))
    assert medfilt(y, 3).dtype == torch.int64
