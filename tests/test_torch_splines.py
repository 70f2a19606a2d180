"""The PyTorch port's B-spline family (simpledsp_tpu_torch.ops.splines)
against scipy and the JAX package, on the CPU (the port of
tests/test_splines.py).

Tolerances: the host prefilters and evaluators (``cspline1d`` /
``qspline1d`` and their ``_eval``, ``symiirorder1`` / ``2``, ``cspline2d``
/ ``qspline2d``) are the JAX package's NumPy code and give its bits; the
torch bodies (``sepfir2d``, ``gauss_spline``, and ``spline_filter``
through ``sepfir2d``) agree with the JAX package in float64 to 1e-12
absolute on outputs of order 1 (taps of unit sum).  The scipy cases keep
the JAX tests' tolerances.  A signal given as a tensor gives the result of
its numpy array.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

from simpledsp_tpu.ops import splines as jsp
from simpledsp_tpu_torch.ops import splines as sp

TOL = 1e-12


def T(x):
    return torch.from_numpy(np.asarray(x))


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# -- the JAX package's tests, on the port --------------------------------------

def test_spline_coefficients_match_scipy(rng):
    x = rng.standard_normal(50)
    np.testing.assert_allclose(sp.cspline1d(x), ss.cspline1d(x), atol=1e-12)
    np.testing.assert_allclose(sp.qspline1d(x), ss.qspline1d(x), atol=1e-12)
    # single-sample branch (incl. scipy's skipped-gain quirk, replicated)
    np.testing.assert_allclose(sp.cspline1d(x[:1]), ss.cspline1d(x[:1]))
    np.testing.assert_allclose(sp.qspline1d(x[:1]), ss.qspline1d(x[:1]))
    with pytest.raises(ValueError):
        sp.qspline1d(x, lamb=1.0)


def test_spline_eval_matches_scipy_and_interpolates(rng):
    x = rng.standard_normal(50)
    cj = ss.cspline1d(x)
    qj = ss.qspline1d(x)
    newx = rng.uniform(-20, 70, 300)      # includes mirror extrapolation
    np.testing.assert_allclose(sp.cspline1d_eval(cj, newx),
                               ss.cspline1d_eval(cj, newx), atol=1e-12)
    np.testing.assert_allclose(sp.qspline1d_eval(qj, newx),
                               ss.qspline1d_eval(qj, newx), atol=1e-12)
    np.testing.assert_allclose(
        sp.cspline1d_eval(cj, newx, dx=0.5, x0=2.0),
        ss.cspline1d_eval(cj, newx, dx=0.5, x0=2.0), atol=1e-12)
    # the defining property: evaluation at the knots returns the samples
    np.testing.assert_allclose(sp.cspline1d_eval(cj, np.arange(50.0)), x,
                               atol=1e-12)
    with pytest.raises(ValueError):
        sp.cspline1d_eval(np.empty(0), newx)


def test_sepfir2d_matches_scipy(rng):
    img = rng.standard_normal((20, 30))
    hr = rng.standard_normal(5)
    hc = rng.standard_normal(7)
    got = sp.sepfir2d(T(img), hr, hc).numpy()
    np.testing.assert_allclose(got, ss.sepfir2d(img, hr, hc), atol=1e-12)
    # batched leading axis
    imgs = rng.standard_normal((3, 12, 14))
    got = sp.sepfir2d(T(imgs), hr, hc).numpy()
    for i in range(3):
        np.testing.assert_allclose(got[i], ss.sepfir2d(imgs[i], hr, hc),
                                   atol=1e-12)
    with pytest.raises(ValueError):
        sp.sepfir2d(torch.zeros((4, 4)), np.ones(4), hc)   # even taps
    with pytest.raises(ValueError):
        sp.sepfir2d(torch.zeros(4), hr, hc)                # 1-D input


def test_gauss_spline_matches_scipy(rng):
    x = rng.standard_normal(64)
    np.testing.assert_allclose(sp.gauss_spline(T(x), 3).numpy(),
                               ss.gauss_spline(x, 3), atol=1e-14)


def test_symiirorder1_and_2d_splines_match_scipy(rng):
    r = -2.0 + np.sqrt(3.0)
    x = rng.standard_normal(60)
    np.testing.assert_allclose(
        sp.symiirorder1(x, -r * 6, r, 1e-8),
        ss.symiirorder1(x, -r * 6, r, precision=1e-8), atol=1e-12)
    np.testing.assert_allclose(sp.symiirorder1(x, -r * 6, r),
                               ss.symiirorder1(x, -r * 6, r), atol=1e-10)
    with pytest.raises(ValueError, match="did not converge"):
        sp.symiirorder1(x[:8], -r * 6, r)          # short + DEFAULT prec
    X = rng.standard_normal((30, 40))
    np.testing.assert_allclose(sp.cspline2d(X), ss.cspline2d(X), atol=1e-12)
    np.testing.assert_allclose(sp.qspline2d(X), ss.qspline2d(X), atol=1e-12)
    with pytest.raises(ValueError):
        sp.symiirorder1(x, 1.0, 1.5)               # |z1| >= 1
    with pytest.raises(ValueError, match="did not converge"):
        sp.symiirorder1(x[:5], -r * 6, r, 1e-9)    # short + explicit prec


def test_symiirorder2_matches_scipy(rng):
    x = rng.standard_normal(400)
    for r in (0.3, 0.6, 0.9):
        for omega in (0.4, 1.1, 2.5):
            for prec in (-1.0, 1e-3, 1e-6, 1e-9):
                np.testing.assert_allclose(
                    sp.symiirorder2(x, r, omega, prec),
                    ss.symiirorder2(x, r, omega, precision=prec),
                    atol=1e-10, err_msg=f"r={r} omega={omega} prec={prec}")
    xs = x[:80]
    for r, prec in ((0.9, -1.0), (0.9, 1e-9)):
        with pytest.raises(ValueError, match="did not converge"):
            ss.symiirorder2(xs, r, 0.4, precision=prec)
        with pytest.raises(ValueError, match="did not converge"):
            sp.symiirorder2(xs, r, 0.4, prec)
    X = rng.standard_normal((3, 60))
    got = sp.symiirorder2(X, 0.5, 1.3)
    for i in range(3):
        np.testing.assert_allclose(got[i], ss.symiirorder2(X[i], 0.5, 1.3),
                                   atol=1e-10)
    with pytest.raises(ValueError):
        sp.symiirorder2(x, 1.0, 0.5)               # r >= 1
    with pytest.raises(ValueError, match="did not converge"):
        sp.symiirorder2(x[:6], 0.9, 0.5)           # short + default prec
    with pytest.raises(ValueError):
        sp.symiirorder2(np.ones(8, complex), 0.5, 0.5)


def test_smoothing_splines_match_scipy(rng):
    x = rng.standard_normal(64)
    for lamb in (0.05, 1.0, 5.0, 100.0):
        np.testing.assert_allclose(sp.cspline1d(x, lamb),
                                   ss.cspline1d(x, lamb), atol=1e-10,
                                   err_msg=f"lamb={lamb}")
    X = rng.standard_normal((40, 48))
    for lamb in (0.05, 1.0, 8.0):
        np.testing.assert_allclose(sp.cspline2d(X, lamb),
                                   ss.cspline2d(X, lamb), atol=1e-10,
                                   err_msg=f"lamb={lamb}")
    np.testing.assert_allclose(sp.cspline2d(X, 2.0, 1e-4),
                               ss.cspline2d(X, 2.0, precision=1e-4),
                               atol=1e-10)
    with pytest.raises(ValueError, match="did not converge"):
        sp.cspline2d(rng.standard_normal((24, 30)), 8.0)
    X32 = X.astype(np.float32)
    out32 = sp.cspline2d(X32, 3.0)
    assert out32.dtype == np.float32
    np.testing.assert_allclose(out32, ss.cspline2d(X32, 3.0), atol=1e-3)
    with pytest.raises(ValueError):
        sp.qspline2d(X, lamb=1.0)                  # scipy raises too


def test_spline_filter_matches_scipy(rng):
    X = rng.standard_normal((40, 48))
    for lmbda in (0.1, 5.0):
        np.testing.assert_allclose(sp.spline_filter(X, lmbda),
                                   ss.spline_filter(X, lmbda), atol=1e-10)
    X32 = X.astype(np.float32)
    got32 = sp.spline_filter(X32)
    assert got32.dtype == np.float32
    np.testing.assert_allclose(got32, ss.spline_filter(X32), atol=1e-3)
    # Complex input is carried as two planes; the filter is linear with
    # real coefficients, so plane-by-plane scipy is the exact oracle.
    Z = (rng.standard_normal((40, 44))
         + 1j * rng.standard_normal((40, 44))).astype(np.complex64)
    gotc = sp.spline_filter(Z, 2.0)
    assert gotc.dtype == np.complex64
    ref_r = ss.spline_filter(Z.real.astype(np.float32), 2.0)
    ref_i = ss.spline_filter(Z.imag.astype(np.float32), 2.0)
    np.testing.assert_allclose(gotc.real, ref_r, atol=1e-3)
    np.testing.assert_allclose(gotc.imag, ref_i, atol=1e-3)
    with pytest.raises(TypeError):
        sp.spline_filter(np.ones((4, 4), dtype=np.int32))


def test_splines_reject_complex_and_preserve_f32(rng):
    with pytest.raises(ValueError):
        sp.cspline1d(np.ones(8, complex))
    with pytest.raises(ValueError):
        sp.symiirorder1(np.ones(8, complex), 1.0, 0.5)
    X32 = rng.standard_normal((20, 24)).astype(np.float32)
    out = sp.cspline2d(X32)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ss.cspline2d(X32), atol=1e-5)


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1, 2, 37, 200])
def test_1d_prefilters_give_the_jax_bits(rng, dtype, n):
    x = rng.standard_normal(n).astype(dtype)
    for fn in ("cspline1d", "qspline1d"):
        _bits(getattr(sp, fn)(x), getattr(jsp, fn)(x))
        _bits(getattr(sp, fn)(T(x)), getattr(jsp, fn)(x))
    if n > 2:
        for lamb in (0.5, 30.0):
            _bits(sp.cspline1d(T(x), lamb), jsp.cspline1d(x, lamb))


def test_evaluators_give_the_jax_bits(rng):
    cj = jsp.cspline1d(rng.standard_normal(40))
    newx = rng.uniform(-50, 90, 500)
    for ours, theirs in ((sp.cspline1d_eval, jsp.cspline1d_eval),
                         (sp.qspline1d_eval, jsp.qspline1d_eval)):
        _bits(ours(T(cj), T(newx), 0.7, -3.0), theirs(cj, newx, 0.7, -3.0))
        _bits(ours(cj, newx), theirs(cj, newx))


@pytest.mark.parametrize("prec", [-1.0, 1e-4, 1e-9])
def test_symiir_filters_give_the_jax_bits(rng, prec):
    x = rng.standard_normal((2, 3, 300))
    r = -2.0 + np.sqrt(3.0)
    _bits(sp.symiirorder1(T(x), -6 * r, r, prec),
          jsp.symiirorder1(x, -6 * r, r, prec))
    for r2, omega in ((0.5, 0.7), (0.8, 2.0)):
        _bits(sp.symiirorder2(T(x), r2, omega, prec),
              jsp.symiirorder2(x, r2, omega, prec))


@pytest.mark.parametrize("lamb", [0.0, 0.005, 0.5, 4.0])
def test_2d_prefilters_give_the_jax_bits(rng, lamb):
    X = rng.standard_normal((2, 40, 44))
    _bits(sp.cspline2d(T(X), lamb), jsp.cspline2d(X, lamb))
    if lamb == 0.0:
        _bits(sp.qspline2d(T(X)), jsp.qspline2d(X))
        _bits(sp.cspline2d(X.astype(np.float32)),
              jsp.cspline2d(X.astype(np.float32)))


@pytest.mark.parametrize("shape,kr,kc", [((20, 30), 5, 7), ((3, 12, 14), 1, 3),
                                         ((2, 2, 9, 11), 3, 1),
                                         ((6, 7), 15, 17), ((2, 3, 4), 9, 13),
                                         ((1, 1), 5, 3)])
def test_sepfir2d_matches_jax(rng, shape, kr, kc):
    """Batched planes, and filters longer than half the plane (15 and 17
    taps on 6 x 7, 9 and 13 on 3 x 4, 5 and 3 on one sample): numpy's
    'symmetric' pad repeats with period 2n, which the gather follows."""
    x = rng.standard_normal(shape)
    hr = rng.standard_normal(kr)
    hc = rng.standard_normal(kc)
    hr, hc = hr / np.abs(hr).sum(), hc / np.abs(hc).sum()
    got = sp.sepfir2d(T(x), hr, hc)
    want = np.asarray(jsp.sepfir2d(jnp.asarray(x), hr, hc))
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_sepfir2d_takes_tensor_taps_and_float32(rng):
    x = rng.standard_normal((2, 16, 18))
    hr, hc = np.hanning(7) / np.hanning(7).sum(), np.array([0.25, 0.5, 0.25])
    np.testing.assert_array_equal(
        sp.sepfir2d(T(x), T(hr), T(hc)).numpy(),
        sp.sepfir2d(T(x), hr, hc).numpy())
    got32 = sp.sepfir2d(T(x.astype(np.float32)), hr, hc)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(jsp.sepfir2d(
        jnp.asarray(x.astype(np.float32)), hr, hc)), rtol=0, atol=1e-6)


def test_gauss_spline_matches_jax(rng):
    x = rng.standard_normal((3, 64)) * 3
    for n in (0, 2, 5):
        np.testing.assert_allclose(
            sp.gauss_spline(T(x), n).numpy(),
            np.asarray(jsp.gauss_spline(jnp.asarray(x), n)), rtol=0,
            atol=TOL)
    assert sp.gauss_spline(np.linspace(-2, 2, 5), 3).dtype == torch.float64


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex64,
                                   np.complex128])
def test_spline_filter_matches_jax(rng, dtype):
    X = rng.standard_normal((24, 30))
    if np.iscomplexobj(np.empty(0, dtype)):
        X = X + 1j * rng.standard_normal((24, 30))
    X = X.astype(dtype)
    got = sp.spline_filter(T(X), 3.0)
    want = jsp.spline_filter(X, 3.0)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = TOL if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
