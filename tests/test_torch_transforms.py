"""The port's extended transforms (simpledsp_tpu_torch.ops.transforms)
against the JAX package and scipy, in float64 on the CPU.

Tolerance: 1e-10 relative to the largest output magnitude, for every
comparison (float64 rounding of chirp and four-step sums differs between
the two packages' orders of operations; scipy uses other algorithms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sfft
import scipy.signal as ss
import torch

from simpledsp_tpu.ops import transforms as jtr
from simpledsp_tpu_torch.ops import transforms as ttr

RTOL = 1e-10


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,m", [(17, None), (127, 64), (131, 200),
                                 (999, None), (4099, None)])
def test_czt_matches_jax_and_scipy(n, m, rng):
    x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    w = np.exp(-0.7j * np.pi / n) * 1.0001
    a = 0.98 * np.exp(0.2j)
    got = ttr.czt(_t(x), m, w=w, a=a)
    _close(got, jtr.czt(jnp.asarray(x), m, w=w, a=a))
    _close(got, ss.czt(x, m, w=w, a=a))
    got = ttr.czt(_t(x))
    _close(got, jtr.czt(jnp.asarray(x)))
    _close(got, np.fft.fft(x))


def test_czt_ri_planes_match_jax(rng):
    xr, xi = rng.standard_normal((2, 3, 100))
    yr, yi = ttr.czt_ri(_t(xr), _t(xi), 150, w=np.exp(-1j * np.pi / 150))
    jr, ji = jtr.czt_ri(jnp.asarray(xr), jnp.asarray(xi), 150,
                        w=np.exp(-1j * np.pi / 150))
    _close(yr, jr)
    _close(yi, ji)


@pytest.mark.parametrize("fn", [[0.1, 0.4], 0.75])
@pytest.mark.parametrize("endpoint", [False, True])
def test_zoom_fft_matches_jax_and_scipy(fn, endpoint, rng):
    x = rng.standard_normal((2, 256))
    got = ttr.zoom_fft(_t(x), fn, 100, endpoint=endpoint)
    _close(got, jtr.zoom_fft(jnp.asarray(x), fn, 100, endpoint=endpoint))
    _close(got, ss.zoom_fft(x, fn, 100, endpoint=endpoint, axis=-1))
    zr, zi = ttr.zoom_fft_ri(_t(x), torch.zeros(2, 256, dtype=torch.float64),
                             fn, 100, endpoint=endpoint)
    _close(zr, got.real)
    _close(zi, got.imag)


def test_czt_points_match_jax_and_scipy():
    for m, w, a in ((8, None, 1.0), (16, np.exp(-0.1j), 0.9 + 0.1j)):
        got = ttr.czt_points(m, w, a)
        np.testing.assert_allclose(got, jtr.czt_points(m, w, a), rtol=1e-14)
        np.testing.assert_allclose(got, ss.czt_points(m, w, a), rtol=1e-12)
    with pytest.raises(ValueError, match="positive"):
        ttr.czt_points(0)


def test_czt_and_zoomfft_plans_match_jax(rng):
    x = rng.standard_normal((64, 3))
    plan = ttr.CZT(64, 80, w=np.exp(-0.02j), a=1.01, device="cpu")
    jplan = jtr.CZT(64, 80, w=np.exp(-0.02j), a=1.01)
    _close(plan(x, axis=0), jplan(jnp.asarray(x), axis=0))
    np.testing.assert_allclose(plan.points(), jplan.points(), rtol=1e-14)
    zp = ttr.ZoomFFT(64, [0.2, 0.5], 50, fs=2.0, endpoint=True, device="cpu")
    jzp = jtr.ZoomFFT(64, [0.2, 0.5], 50, fs=2.0, endpoint=True)
    _close(zp(x.T), jzp(jnp.asarray(x.T)))
    assert (zp.f1, zp.f2, zp.fs) == (jzp.f1, jzp.f2, jzp.fs)
    with pytest.raises(ValueError, match="length 64"):
        plan(np.zeros(63))
    for bad in (lambda: ttr.CZT(0, device="cpu"),
                lambda: ttr.CZT(4, 0, device="cpu"),
                lambda: ttr.ZoomFFT(8, [0.1, 0.2, 0.3], device="cpu")):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("n", [7, 8, 15, 64, 128, 4096])
@pytest.mark.parametrize("dct_type", [2, 3])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_dct_matches_jax_and_scipy(n, dct_type, norm, rng):
    x = rng.standard_normal((3, n))
    got = ttr.dct(_t(x), dct_type, norm=norm)
    _close(got, jtr.dct(jnp.asarray(x), dct_type, norm=norm))
    _close(got, sfft.dct(x, dct_type, norm=norm))
    back = ttr.idct(got, dct_type, norm=norm)
    _close(back, jtr.idct(jnp.asarray(got.numpy()), dct_type, norm=norm))
    _close(back, x)


def test_dct_rejects_bad_args():
    x = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="type"):
        ttr.dct(x, 1)
    with pytest.raises(ValueError, match="type"):
        ttr.idct(x, 4)
    with pytest.raises(ValueError, match="norm"):
        ttr.dct(x, 2, norm="forward")
    with pytest.raises(ValueError, match="real"):
        ttr.dct(torch.zeros(8, dtype=torch.complex128))


@pytest.mark.parametrize("n", [256, 257, 4096])
def test_hilbert_matches_jax_and_scipy(n, rng):
    x = rng.standard_normal((2, n))
    yr, yi = ttr.analytic_ri(_t(x))
    jr, ji = jtr.analytic_ri(jnp.asarray(x))
    _close(yr, jr)
    _close(yi, ji)
    _close(ttr.hilbert(_t(x)), ss.hilbert(x, axis=-1))
    with pytest.raises(ValueError, match="real"):
        ttr.analytic_ri(torch.zeros(4, dtype=torch.complex128))


@pytest.mark.parametrize("shape", [(16, 32), (2, 15, 20)])
def test_hilbert2_matches_jax_and_scipy(shape, rng):
    x = rng.standard_normal(shape)
    yr, yi = ttr.hilbert2_ri(_t(x))
    jr, ji = jtr.hilbert2_ri(jnp.asarray(x))
    _close(yr, jr)
    _close(yi, ji)
    if len(shape) == 2:
        _close(ttr.hilbert2(_t(x)), ss.hilbert2(x))
    with pytest.raises(ValueError, match="2 dims"):
        ttr.hilbert2_ri(torch.zeros(4, dtype=torch.float64))


def test_goertzel_matches_jax_and_fft(rng):
    x = rng.standard_normal((3, 200))
    bins = [0, 3, 17, 99, 100, 199]
    got = ttr.goertzel(_t(x), bins)
    _close(got, jtr.goertzel(jnp.asarray(x), bins))
    _close(got, np.fft.fft(x)[:, bins])
    gr, gi = ttr.goertzel_ri(_t(x), bins)
    _close(gr, got.real)
    _close(gi, got.imag)
