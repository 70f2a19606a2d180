"""The port's pulse-Doppler radar (simpledsp_tpu_torch.models.radar) against
the JAX package and brute-force numpy, in float64 on the CPU.

Tolerances: the range-Doppler map at 1e-9 relative to its largest cell and
the matched filter at 1e-10 against the JAX package; the CFAR detection
masks equal and the thresholds at 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledsp_tpu.models import radar as jrd
from simpledsp_tpu_torch.models import radar as trd


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
