"""The port's pulse-Doppler radar (simpledsp_tpu_torch.models.radar) against
the JAX package and brute-force numpy, in float64 on the CPU.

Tolerances: the range-Doppler map at 1e-9 relative to its largest cell and
the matched filter at 1e-10 against the JAX package; the CFAR detection
masks equal and the thresholds at 1e-12 relative.  The CFAR's rolled route
against a float64 numpy box sum at 1e-12 (float64) and 1e-5 (float32, a
few float32 roundings of sums of 2 train terms) of the largest threshold.
The Doppler stage's plain route bit for bit the map's lines before they
moved to ``kernels/doppler``, and against float64 numpy as a relative RMS
error: 1e-13 in float64, 1e-6 in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledsp_tpu.models import radar as jrd
from simpledsp_tpu_torch.kernels import cfar as kcfar
from simpledsp_tpu_torch.kernels import doppler as kdop
from simpledsp_tpu_torch.models import radar as trd
from simpledsp_tpu_torch.ops import fft as tfft
from simpledsp_tpu_torch.ops.fft import _table
from simpledsp_tpu_torch.ops.spectral import window_taps
from simpledsp_tpu_torch.utils import tracing


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


def _pulses(rng, n_cpi, n_pulses, n_samples, targets, tx, noise=0.01):
    """(n_cpi, n_pulses, n_samples) complex I/Q: noise plus each target
    (delay, Doppler in cycles per pulse, amplitude), as tests/test_radar.py
    builds them."""
    txc = tx[0] + 1j * tx[1]
    x = noise * (rng.standard_normal((n_cpi, n_pulses, n_samples))
                 + 1j * rng.standard_normal((n_cpi, n_pulses, n_samples)))
    k = np.arange(n_pulses)[:, None]
    for delay, fd, amp in targets:
        echo = np.zeros(n_samples, dtype=np.complex128)
        echo[delay: delay + txc.size] = amp * txc
        x = x + echo[None, :] * np.exp(2j * np.pi * fd * k)
    return x


def test_lfm_chirp_matches_jax():
    for n, bw in ((64, 0.8), (511, 1.0)):
        for a, b in zip(trd.lfm_chirp(n, bw), jrd.lfm_chirp(n, bw)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="bandwidth"):
        trd.lfm_chirp(64, 1.5)


def test_matched_filter_matches_jax_and_numpy(rng):
    tx = trd.lfm_chirp(64, 0.8)
    x = _pulses(rng, 2, 3, 500, [(100, 0.0, 1.0)], tx)
    yr, yi = trd.matched_filter_ri(_t(x.real), _t(x.imag), *tx)
    jr, ji = jrd.matched_filter_ri(jnp.asarray(x.real), jnp.asarray(x.imag),
                                   *tx)
    _close(yr.numpy(), jr, 1e-10)
    _close(yi.numpy(), ji, 1e-10)
    txc = tx[0] + 1j * tx[1]
    ref = np.array([[np.correlate(row, txc, "full")[txc.size - 1:]
                     for row in cpi] for cpi in x])
    _close(yr.numpy() + 1j * yi.numpy(), ref, 1e-10)
    assert np.abs(yr.numpy() + 1j * yi.numpy())[0, 0].argmax() == 100
    with pytest.raises(ValueError, match="exceeds"):
        trd.matched_filter_ri(_t(x.real[..., :32]), _t(x.imag[..., :32]), *tx)
    with pytest.raises(ValueError, match="1-D"):
        trd.matched_filter_ri(_t(x.real), _t(x.imag), np.ones((2, 2)),
                              np.ones((2, 2)))


@pytest.mark.parametrize("window", ["hann", "rect"])
def test_range_doppler_map_and_cfar_match_jax(window, rng):
    """4 CPIs x 64 pulses x 512 range cells: the map at 1e-9, the detection
    masks equal, and both targets detected on their cells in every CPI."""
    n_cpi, n_pulses, n_samples = 4, 64, 512
    tx = trd.lfm_chirp(64, 0.8)
    targets = [(120, 0.125, 0.5), (300, -0.25, 0.3)]
    x = _pulses(rng, n_cpi, n_pulses, n_samples, targets, tx)
    rdm = trd.range_doppler_map(_t(x.real), _t(x.imag), *tx, window=window)
    jrdm = jrd.range_doppler_map(jnp.asarray(x.real), jnp.asarray(x.imag),
                                 *tx, window=window)
    assert rdm.shape == (n_cpi, n_pulses, n_samples)
    _close(rdm.numpy(), jrdm, 1e-9)
    for axis in (-1, -2):
        det, thr = trd.cfar_ca(rdm, guard=2, train=8, pfa=1e-6, axis=axis)
        jdet, jthr = jrd.cfar_ca(jrdm, guard=2, train=8, pfa=1e-6, axis=axis)
        np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))
        _close(thr.numpy(), jthr, 1e-12)
    det, _ = trd.cfar_ca(rdm, guard=2, train=8, pfa=1e-6)
    for delay, fd, _ in targets:
        row = n_pulses // 2 + int(round(fd * n_pulses))
        assert det[:, row, delay].all(), (delay, fd)


def test_bad_arguments_raise():
    p = torch.zeros(4, 32, dtype=torch.float64)
    with pytest.raises(ValueError, match="guard"):
        trd.cfar_ca(p, guard=-1)
    with pytest.raises(ValueError, match="pfa"):
        trd.cfar_ca(p, pfa=1.0)
    with pytest.raises(ValueError, match="exceeds"):
        trd.cfar_ca(p, guard=4, train=16)
    with pytest.raises(ValueError, match="n_pulses"):
        trd.range_doppler_map(p[0], p[0], *trd.lfm_chirp(8))


# -- the CFAR's two routes (kernels/cfar) -------------------------------------------

def _cfar_counts():
    c = tracing.counters()
    return c.get("radar.cfars", 0), c["kernel.cfar.launches"]


def _box_reference(p, guard, train, pfa):
    """Thresholds in float64 numpy: the mean of the 2 train training cells
    (wrapping), times alpha, along the last axis."""
    p = np.asarray(p, dtype=np.float64)
    n_train = 2 * train
    acc = sum(np.roll(p, k, -1) + np.roll(p, -k, -1)
              for k in range(guard + 1, guard + train + 1))
    return n_train * (pfa ** (-1.0 / n_train) - 1.0) * acc / n_train


@pytest.mark.parametrize("dtype, guard, train, n", [
    (torch.float32, 2, 12, 512),                      # the CPU
    (torch.float64, 2, 12, 512),                      # float64
    (torch.float32, kcfar.MAX_SPAN, 1, 2 * kcfar.MAX_SPAN + 3),  # span past
])
def test_cfar_off_the_kernel_takes_the_rolled_route(dtype, guard, train, n,
                                                    rng):
    """CPU tensors, float64 and a window wider than the kernel's tile go to
    the rolled route: no kernel launch, the call counted in radar.cfars,
    the thresholds those of the box sum."""
    p = torch.as_tensor(rng.exponential(size=(3, n)), dtype=dtype)
    assert not kcfar.cfar_kernel_supported(p, guard, train)
    cfars, launches = _cfar_counts()
    det, thresh = trd.cfar_ca(p, guard=guard, train=train, pfa=1e-5)
    assert _cfar_counts() == (cfars + 1, launches)
    ref = _box_reference(p.numpy(), guard, train, 1e-5)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    _close(thresh.numpy(), ref, tol)
    assert det.dtype == torch.bool and det.shape == p.shape
    assert torch.equal(det, p > thresh)


@pytest.mark.parametrize("shape, axis", [
    ((4096,), -1),            # a 1-D row
    ((3, 16, 100), -1),       # the map's range axis, as it lies
    ((3, 16, 100), -2),       # the Doppler axis: moved last in one copy
    ((40, 3, 5), 0),
    ((2, 3, 40, 5), 2),       # a 4-D batch
])
def test_cfar_kernel_route_gets_the_axis_last_and_contiguous(shape, axis,
                                                             monkeypatch, rng):
    """The kernel route's plumbing on the CPU, with the plain version in the
    kernel's place: the kernel gets the map with ``axis`` last and
    contiguous, and the outputs come back with the map's shape and the
    rolled route's values."""
    got = []

    def fake_kernel(x, guard, train, alpha):
        got.append((tuple(x.shape), x.is_contiguous()))
        return kcfar.cfar_rolled(x, guard, train, alpha)

    p = torch.as_tensor(rng.exponential(size=shape), dtype=torch.float32)
    want = trd.cfar_ca(p, guard=1, train=4, pfa=1e-3, axis=axis)
    monkeypatch.setattr(kcfar, "cfar_kernel_supported", lambda *a: True)
    monkeypatch.setattr(kcfar, "cfar_kernel", fake_kernel)
    cfars, _ = _cfar_counts()
    det, thresh = trd.cfar_ca(p, guard=1, train=4, pfa=1e-3, axis=axis)
    moved = p.movedim(axis, -1).shape
    assert got == [(tuple(moved), True)]
    assert _cfar_counts()[0] == cfars + 1
    assert det.shape == thresh.shape == p.shape
    assert torch.equal(det, want[0]) and torch.equal(thresh, want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kwargs, match", [
    (dict(guard=-1), "guard"),
    (dict(train=0), "train"),
    (dict(pfa=0.0), "pfa"),
    (dict(pfa=1.0), "pfa"),
    (dict(guard=4, train=16), "exceeds"),
    (dict(guard=2, train=14), "exceeds"),     # 2 * 16 + 1 = 33 > 32
])
def test_cfar_keeps_its_argument_errors(kwargs, match, dtype):
    p = torch.zeros(4, 32, dtype=dtype)
    cfars, launches = _cfar_counts()
    with pytest.raises(ValueError, match=match):
        trd.cfar_ca(p, **kwargs)
    assert _cfar_counts() == (cfars, launches)


def test_cfar_kernel_wrapper_refuses_what_it_does_not_take():
    p = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        kcfar.cfar_kernel(p, 2, 12, 1.0)
    assert kcfar.cfar_kernel_supported(p, 2, 12) is False


# -- the Doppler stage's two routes (kernels/doppler) ------------------------------

def _doppler_launches():
    return tracing.counters()["kernel.doppler.launches"]


def _route_before_the_move(xr, xi, tx, window):
    """``range_doppler_map``'s lines as they stood before the Doppler stage
    moved to ``kernels/doppler``: the reference for its plain route."""
    yr, yi = trd.matched_filter_ri(xr, xi, *tx)
    n_pulses = yr.shape[-2]
    w = _table(window_taps(window, n_pulses), yr)[:, None]
    dr, di = tfft.fft_ri((yr * w).transpose(-1, -2),
                         (yi * w).transpose(-1, -2))
    dr, di = dr.transpose(-1, -2), di.transpose(-1, -2)
    return torch.roll(dr * dr + di * di, n_pulses // 2, -2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape, window", [
    ((4, 64, 300), "hann"),
    ((16, 100), "rect"),            # one CPI, no batch axis
    ((2, 3, 32, 50), "hamming"),    # two batch axes
    ((3, 96, 40), "blackman"),      # pulses outside the kernel's gate
])
def test_doppler_plain_is_the_maps_route_before_the_move(shape, window, dtype,
                                                         rng):
    """On the CPU ``range_doppler_map`` and ``doppler_power_plain`` give
    bit for bit what the map gave before the move, and no kernel runs."""
    tx = trd.lfm_chirp(16, 0.8)
    xr, xi = (torch.as_tensor(a, dtype=dtype)
              for a in rng.standard_normal((2, *shape)))
    want = _route_before_the_move(xr, xi, tx, window)
    maps = tracing.counters().get("radar.maps", 0)
    launches = _doppler_launches()
    got = trd.range_doppler_map(xr, xi, *tx, window=window)
    assert tracing.counters()["radar.maps"] == maps + 1
    assert _doppler_launches() == launches
    assert got.dtype == dtype and torch.equal(got, want)
    yr, yi = trd.matched_filter_ri(xr, xi, *tx)
    w = _table(window_taps(window, shape[-2]), yr)[:, None]
    assert torch.equal(kdop.doppler_power_plain(yr, yi, w), want)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-13),
                                        (torch.float32, 1e-6)])
@pytest.mark.parametrize("n_pulses, window", [
    (16, "hann"), (64, "hamming"), (96, "hann"), (128, "hann"),
    (256, "rect"),
])
def test_doppler_plain_matches_float64_numpy(n_pulses, window, dtype, tol,
                                             rng):
    """The plain route against np.roll(|fft(y w, axis=-2)|^2, P // 2, -2)
    on the same y, as a relative RMS error: 1e-13 in float64, 1e-6 in
    float32 (a few roundings of a P-point transform and its square)."""
    y = (rng.standard_normal((3, n_pulses, 70))
         + 1j * rng.standard_normal((3, n_pulses, 70)))
    yr, yi = (torch.as_tensor(a, dtype=dtype) for a in (y.real, y.imag))
    taps = window_taps(window, n_pulses)
    got = kdop.doppler_power_plain(yr, yi, _table(taps, yr)[:, None])
    yq = yr.double().numpy() + 1j * yi.double().numpy()
    ref = np.roll(np.abs(np.fft.fft(yq * taps[:, None], axis=-2)) ** 2,
                  n_pulses // 2, -2)
    err = np.sqrt(((got.double().numpy() - ref) ** 2).sum()
                  / (ref ** 2).sum())
    assert err <= tol, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_pulses", [8, 16, 96, 128, 512, 1024])
def test_doppler_kernel_gate_is_shut_on_the_cpu(n_pulses, dtype):
    """CPU tensors never take the kernel, in float32 or float64, inside the
    gate's pulse counts (16-512, powers of two) or outside them."""
    y = torch.zeros(2, n_pulses, 8, dtype=dtype)
    assert not kdop.doppler_kernel_supported(y, n_pulses)
    assert (kdop.MIN_PULSES, kdop.MAX_PULSES) == (16, 512)


@pytest.mark.parametrize("shape", [(4, 64, 300), (16, 100), (2, 3, 32, 50)])
def test_doppler_kernel_route_gets_y_where_it_lies(shape, monkeypatch, rng):
    """The kernel route's plumbing on the CPU, with the plain version in the
    kernel's place: the kernel gets the matched filter's trimmed rows as
    they lie (no copy) and the window as a column, and its map is the
    map."""
    got = []

    def fake_kernel(yr, yi, w):
        got.append((tuple(yr.shape), yr.stride(), yr.is_contiguous(),
                    tuple(w.shape), yi.stride() == yr.stride()))
        return kdop.doppler_power_plain(yr, yi, w)

    tx = trd.lfm_chirp(16, 0.8)
    xr, xi = (torch.as_tensor(a, dtype=torch.float32)
              for a in rng.standard_normal((2, *shape)))
    want = trd.range_doppler_map(xr, xi, *tx)
    monkeypatch.setattr(kdop, "doppler_kernel_supported", lambda *a: True)
    monkeypatch.setattr(kdop, "doppler_power", fake_kernel)
    power = trd.range_doppler_map(xr, xi, *tx)
    wide = 1 << (shape[-1] + 16 - 2).bit_length()    # the padded row
    (yshape, ystride, contiguous, wshape, same), = got
    assert yshape == shape and ystride[-2:] == (wide, 1)
    assert not contiguous and same and wshape == (shape[-2], 1)
    assert torch.equal(power, want)


def test_doppler_kernel_wrapper_refuses_what_it_does_not_take():
    y = torch.zeros(2, 64, 32)
    launches = _doppler_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kdop.doppler_power(y, y, torch.ones(64))
    assert _doppler_launches() == launches
