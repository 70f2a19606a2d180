"""The port's modems (simpledsp_tpu_torch.models.comms) against the JAX
package and the analytic BER curve, on the CPU (the port of
tests/test_comms.py).

Tolerances: constellation points are host float64 NumPy in both
packages, so equal bit for bit, and so are the mapped symbols and the
decided bits; modulated waveforms and recovered symbols in float64 agree
with the JAX package to 1e-12 relative to the largest sample.  ``awgn``
draws from torch's generator, not JAX's, so it is held to its statistics:
the noise mean within 5 standard errors of 0, each plane's variance
within 3 % of nvar / 2, and one seed giving the same noise twice; the
AWGN BER lies in the JAX tests' band, 0.6 to 1.6 x the analytic value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erfc

from simpledsp_tpu.models import comms as jcomms
from simpledsp_tpu_torch.convert import constellation_from_numpy
from simpledsp_tpu_torch.models import comms as tcomms

CONSTS = {"bpsk": lambda m: m.Constellation.bpsk(),
          "qpsk": lambda m: m.Constellation.qpsk(),
          "qam16": lambda m: m.Constellation.qam(16),
          "qam64": lambda m: m.Constellation.qam(64)}


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("const", sorted(CONSTS))
def test_constellation_equals_jax_and_round_trips(rng, const):
    c, jc = CONSTS[const](tcomms), CONSTS[const](jcomms)
    np.testing.assert_array_equal(c.points, jc.points)
    assert c.bits_per_symbol == jc.bits_per_symbol and c.name == jc.name
    assert abs(np.mean(np.sum(c.points ** 2, axis=1)) - 1.0) < 1e-12
    k = c.bits_per_symbol
    bits = rng.integers(0, 2, (3, (1200 // k) * k))
    sr, si = c.map_bits(torch.as_tensor(bits), dtype=torch.float64)
    jr, ji = jc.map_bits(jnp.asarray(bits), dtype=jnp.float64)
    np.testing.assert_array_equal(sr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
    assert torch.equal(c.demap_hard(sr, si), torch.as_tensor(bits))
    # Hard decisions of noisy symbols: the JAX package's bits.
    nr = sr + 0.3 * torch.as_tensor(rng.standard_normal(sr.shape))
    ni = si + 0.3 * torch.as_tensor(rng.standard_normal(si.shape))
    np.testing.assert_array_equal(
        c.demap_hard(nr, ni).numpy(),
        np.asarray(jc.demap_hard(jnp.asarray(nr.numpy()),
                                 jnp.asarray(ni.numpy()))))


def test_constellation_crosses_through_convert():
    jc = jcomms.Constellation.qam(16)
    c = constellation_from_numpy(jc.name, jc.points)
    np.testing.assert_array_equal(c.points, jc.points)
    assert c.bits_per_symbol == 4
    with pytest.raises(ValueError):
        constellation_from_numpy("bad", np.ones((4, 3)))
    with pytest.raises(ValueError):
        constellation_from_numpy("bad", np.ones((3, 2)))


def test_constellation_refusals():
    with pytest.raises(ValueError):
        tcomms.Constellation.qam(8)
    with pytest.raises(ValueError):
        tcomms.Constellation.qpsk().map_bits(torch.zeros(3, dtype=torch.long))


def test_gray_pam_adjacency():
    for m in (1, 2, 3):
        levels = tcomms.Constellation._gray_pam(m)
        np.testing.assert_array_equal(levels,
                                      jcomms.Constellation._gray_pam(m))
        order = np.argsort(levels)
        for a, b in zip(order[:-1], order[1:]):
            assert bin(int(a) ^ int(b)).count("1") == 1


@pytest.mark.parametrize("span", [8, 10, 16])
def test_linear_modem_noiseless_loopback_matches_jax(rng, span):
    modem = tcomms.LinearModem(tcomms.Constellation.qam(16), sps=8,
                               span=span, beta=0.35, dtype=torch.float64,
                               device="cpu")
    jmodem = jcomms.LinearModem(jcomms.Constellation.qam(16), sps=8,
                                span=span, beta=0.35, dtype=jnp.float64)
    nsym = 400
    bits = rng.integers(0, 2, (2, nsym * 4))
    xr, xi = modem.modulate(torch.as_tensor(bits))
    jxr, jxi = jmodem.modulate(jnp.asarray(bits))
    assert tuple(xr.shape) == (2, nsym * 8)
    _close(xr, jxr)
    _close(xi, jxi)
    rx_bits, (sy_r, sy_i) = modem.demodulate(xr, xi)
    jrx, (jsr, jsi) = jmodem.demodulate(jxr, jxi)
    n_ok = (nsym - modem.delay_symbols) * 4
    assert tuple(rx_bits.shape) == (2, n_ok)
    assert torch.equal(rx_bits, torch.as_tensor(bits[:, :n_ok]))
    np.testing.assert_array_equal(rx_bits.numpy(), np.asarray(jrx))
    _close(sy_r, jsr)
    _close(sy_i, jsi)
    sref_r, sref_i = modem.constellation.map_bits(
        torch.as_tensor(bits[:, :n_ok]), dtype=torch.float64)
    evm = float(torch.sqrt(torch.mean((sy_r - sref_r) ** 2
                                      + (sy_i - sref_i) ** 2)))
    assert evm < 0.02


def test_linear_modem_float32_default():
    modem = tcomms.LinearModem(tcomms.Constellation.qpsk(), device="cpu")
    bits = torch.randint(0, 2, (2, 2 * 300),
                         generator=torch.Generator().manual_seed(3))
    xr, xi = modem.modulate(bits)
    assert xr.dtype == torch.float32
    rx, _ = modem.demodulate(xr, xi)
    assert torch.equal(rx, bits[:, : rx.shape[-1]])


def _awgn_ber(modem, nsym, rng, seed, demod_len=None):
    bits = torch.as_tensor(rng.integers(0, 2, (nsym * 2,)))
    tr, ti = modem.modulate(bits)
    ebn0 = 4.0
    sps = getattr(modem, "sps", 1)
    snr_db = ebn0 + 10.0 * np.log10(2) - 10.0 * np.log10(sps)
    yr, yi = tcomms.awgn(seed, (tr, ti), snr_db, signal_power=1.0)
    rx, _ = modem.demodulate(yr, yi)
    n = rx.shape[-1]
    measured = float(tcomms.ber(bits[:n], rx))
    theory = 0.5 * erfc(np.sqrt(10.0 ** (ebn0 / 10.0)))
    return measured, theory


def test_qpsk_awgn_ber_tracks_theory(rng):
    modem = tcomms.LinearModem(tcomms.Constellation.qpsk(), sps=4, span=12,
                               beta=0.3, dtype=torch.float64, device="cpu")
    measured, theory = _awgn_ber(modem, 30000, rng, 0)
    assert 0.6 * theory < measured < 1.6 * theory


def test_ofdm_qpsk_awgn_ber_tracks_theory(rng):
    m = tcomms.OFDMModem(tcomms.Constellation.qpsk(), n_fft=64, cp=16,
                         dtype=torch.float64)
    measured, theory = _awgn_ber(m, 300 * 64, rng, 1)
    assert 0.6 * theory < measured < 1.6 * theory


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_awgn_statistics_and_seed(dtype):
    n = 1 << 18
    xr = torch.ones(2, n, dtype=dtype)
    xi = torch.zeros(2, n, dtype=dtype)
    snr_db = 7.0
    yr, yi = tcomms.awgn(5, (xr, xi), snr_db)
    assert yr.dtype == dtype and yr.shape == xr.shape
    nvar = 1.0 * 10.0 ** (-snr_db / 10.0)      # measured power is 1
    for plane in (yr - xr, yi - xi):
        assert abs(float(plane.mean())) < 5 * np.sqrt(nvar / 2 / plane.numel())
        assert abs(float(plane.var()) / (nvar / 2) - 1.0) < 0.03
    # the two planes draw independent noise
    assert abs(float(((yr - xr) * (yi - xi)).mean())) / (nvar / 2) < 0.02
    again = tcomms.awgn(5, (xr, xi), snr_db)
    assert torch.equal(again[0], yr) and torch.equal(again[1], yi)
    other = tcomms.awgn(6, (xr, xi), snr_db)
    assert not torch.equal(other[0], yr)
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(tcomms.awgn(gen, (xr, xi), snr_db)[0], yr)
    # an explicit signal power sets the noise level
    zr, _ = tcomms.awgn(5, (xr, xi), snr_db, signal_power=4.0)
    assert abs(float((zr - xr).var()) / (4.0 * nvar / 2) - 1.0) < 0.03


def test_ber_matches_jax_and_checks_shape(rng):
    a = rng.integers(0, 2, 1000)
    b = a.copy()
    b[::7] ^= 1
    got = tcomms.ber(torch.as_tensor(a), torch.as_tensor(b))
    assert float(got) == float(jcomms.ber(jnp.asarray(a), jnp.asarray(b)))
    with pytest.raises(ValueError):
        tcomms.ber(torch.zeros(4), torch.zeros(5))


class TestOFDM:
    def _modems(self, const="qam16"):
        return (tcomms.OFDMModem(CONSTS[const](tcomms), n_fft=64, cp=16,
                                 dtype=torch.float64),
                jcomms.OFDMModem(CONSTS[const](jcomms), n_fft=64, cp=16,
                                 dtype=jnp.float64))

    def test_noiseless_loopback_matches_jax(self, rng):
        m, jm = self._modems()
        bits = rng.integers(0, 2, (2, 20 * m.bits_per_symbol))
        tr, ti = m.modulate(torch.as_tensor(bits))
        jtr, jti = jm.modulate(jnp.asarray(bits))
        assert tuple(tr.shape) == (2, 20 * (64 + 16))
        _close(tr, jtr)
        _close(ti, jti)
        rx, (fr, fi) = m.demodulate(tr, ti)
        _, (jfr, jfi) = jm.demodulate(jtr, jti)
        assert torch.equal(rx, torch.as_tensor(bits))
        _close(fr, jfr)
        _close(fi, jfi)

    def test_multipath_zero_forcing_exact(self, rng):
        m, jm = self._modems()
        bits = rng.integers(0, 2, (2, 12 * m.bits_per_symbol))
        tr, ti = m.modulate(torch.as_tensor(bits))
        h = np.array([1.0, 0.4 - 0.2j, -0.15 + 0.1j, 0.05j])
        tx = tr.numpy() + 1j * ti.numpy()
        rxs = np.stack([np.convolve(tx[i], h)[: tx.shape[1]]
                        for i in range(2)])
        for channel in ((h.real, h.imag),
                        (torch.as_tensor(h.real), torch.as_tensor(h.imag))):
            rb, (fr, _) = m.demodulate(torch.as_tensor(rxs.real),
                                       torch.as_tensor(rxs.imag),
                                       channel=channel)
            assert torch.equal(rb, torch.as_tensor(bits))
        _, (jfr, _) = jm.demodulate(jnp.asarray(rxs.real),
                                    jnp.asarray(rxs.imag),
                                    channel=(h.real, h.imag))
        _close(fr, jfr)
        with pytest.raises(ValueError):
            m.demodulate(tr, ti, channel=(np.ones(40), np.zeros(40)))
        with pytest.raises(ValueError, match="cyclic prefix"):
            m.demodulate(tr, ti, channel=(np.ones(3), np.zeros(40)))

    def test_bad_args(self):
        with pytest.raises(ValueError):
            tcomms.OFDMModem(tcomms.Constellation.qpsk(), n_fft=64, cp=64)
        m = tcomms.OFDMModem(tcomms.Constellation.qpsk(), n_fft=16, cp=4)
        with pytest.raises(ValueError):
            m.modulate(torch.zeros(33, dtype=torch.int32))
        with pytest.raises(ValueError):
            m.demodulate(torch.zeros(10), torch.zeros(10))
